"""Robustness fuzz: the decode stack must never crash on arbitrary input
and must keep its output schema invariants."""

import numpy as np
import pytest

from tetraear_tpu.core.decoder import TetraDecoder
from tetraear_tpu.protocol.parser import TetraProtocolParser
from tetraear_tpu.protocol.sds import parse_sds_data

REQUIRED_KEYS = {"type", "type_name", "number", "timeslot", "bits", "header",
                 "position", "encrypted", "encryption_algorithm", "key_id",
                 "additional_info"}


class TestDecoderFuzz:
    @pytest.mark.parametrize("seed", range(8))
    def test_random_symbol_streams_never_crash(self, seed):
        rng = np.random.default_rng(seed)
        n = int(rng.integers(10, 5000))
        symbols = rng.integers(0, 4, n)
        dec = TetraDecoder(auto_decrypt=bool(seed % 2))
        frames = dec.decode(symbols)
        for f in frames:
            assert REQUIRED_KEYS <= set(f.keys())
            assert len(f["bits"]) == 510
            assert f["timeslot"] == f["number"] % 4
            # strict-discard invariant: emitted frames either parsed a MAC
            # PDU or passed CRC
            assert ("mac_pdu" in f) or f.get("burst_crc", False)

    @pytest.mark.parametrize("seed", range(4))
    def test_8psk_streams(self, seed):
        rng = np.random.default_rng(100 + seed)
        symbols = rng.integers(0, 8, 2000)
        TetraDecoder(auto_decrypt=False).decode(symbols)

    def test_degenerate_streams(self):
        dec = TetraDecoder(auto_decrypt=False)
        for stream in (np.zeros(3000, np.int64), np.ones(3000, np.int64) * 3,
                       np.zeros(0, np.int64), np.array([2])):
            dec.decode(stream)                      # must not raise


class TestParserFuzz:
    @pytest.mark.parametrize("seed", range(8))
    def test_random_mac_bits(self, seed):
        rng = np.random.default_rng(seed)
        p = TetraProtocolParser()
        for _ in range(20):
            bits = rng.integers(0, 2, int(rng.integers(0, 300)))
            pdu = p.parse_mac_pdu(bits)
            if pdu is not None:
                assert isinstance(pdu.data, bytes)
                meta = p.parse_call_metadata(pdu)
                if meta is not None:
                    assert meta.call_type

    @pytest.mark.parametrize("seed", range(8))
    def test_random_sds_payloads(self, seed):
        rng = np.random.default_rng(200 + seed)
        for _ in range(30):
            data = rng.integers(0, 256,
                                int(rng.integers(0, 80))).astype(np.uint8)
            out = parse_sds_data(data.tobytes())
            assert out is None or isinstance(out, str)

    def test_burst_fuzz(self):
        rng = np.random.default_rng(7)
        p = TetraProtocolParser()
        for _ in range(20):
            symbols = rng.integers(0, 4, 255)
            burst = p.parse_burst(symbols)
            assert burst is not None
            assert burst.data_bits.shape[0] in (216, 510)
