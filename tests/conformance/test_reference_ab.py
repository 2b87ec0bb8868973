"""A/B conformance against the ACTUAL reference implementation.

The reference tree (read-only at /root/reference) is imported as the
oracle, with a locally written `bitstring` shim supplying its missing
dependency.  Every test runs identical inputs through both stacks and
compares observable outputs — the strongest form of the BASELINE
conformance criterion ("bit-exact frame decode vs reference ... within its
SNR/CRC-pass bound").
"""

import sys
from pathlib import Path

import numpy as np
import pytest

_HERE = Path(__file__).parent
sys.path.insert(0, str(_HERE))
import bitstring_shim  # noqa: E402

sys.modules.setdefault("bitstring", bitstring_shim)
REFERENCE = Path("/root/reference")
if str(REFERENCE) not in sys.path:
    sys.path.insert(0, str(REFERENCE))

ref = pytest.importorskip("tetraear.core.decoder",
                          reason="reference tree not mounted")
from tetraear.core.crypto import TEADecryptor as RefTEA  # noqa: E402
from tetraear.core.decoder import TetraDecoder as RefDecoder  # noqa: E402
from tetraear.core.protocol import TetraProtocolParser as RefParser  # noqa: E402
from tetraear.core.validator import TetraSignalValidator as RefValidator  # noqa: E402
from tetraear.signal.processor import SignalProcessor as RefProcessor  # noqa: E402

from tetraear_tpu.config import ReceiverConfig
from tetraear_tpu.core.decoder import TetraDecoder
from tetraear_tpu.core.validator import TetraSignalValidator
from tetraear_tpu.crypto.tea import TEADecryptor
from tetraear_tpu.models.receiver import SignalProcessor
from tetraear_tpu.protocol.parser import TetraProtocolParser
from tetraear_tpu.utils import synth


class TestCryptoAB:
    def test_tea1_exact(self, rng):
        for _ in range(25):
            key = rng.integers(0, 256, 10).astype(np.uint8).tobytes()
            data = rng.integers(0, 256, 40).astype(np.uint8).tobytes()
            assert (TEADecryptor(key, "TEA1").decrypt(data)
                    == RefTEA(key, "TEA1").decrypt(data))

    def test_tea2_exact_and_cbc(self, rng):
        for _ in range(25):
            key = rng.integers(0, 256, 16).astype(np.uint8).tobytes()
            data = rng.integers(0, 256, 32).astype(np.uint8).tobytes()
            iv = rng.integers(0, 256, 8).astype(np.uint8).tobytes()
            assert (TEADecryptor(key, "TEA2").decrypt(data)
                    == RefTEA(key, "TEA2").decrypt(data))
            assert (TEADecryptor(key, "TEA3").decrypt(data, iv=iv)
                    == RefTEA(key, "TEA3").decrypt(data, iv=iv))


class TestSdsAB:
    @pytest.mark.parametrize("seed", range(6))
    def test_random_payloads_identical(self, seed):
        rng = np.random.default_rng(seed)
        mine = TetraProtocolParser()
        theirs = RefParser()
        for _ in range(40):
            data = rng.integers(0, 256,
                                int(rng.integers(1, 64))).astype(np.uint8)
            assert (mine.parse_sds_data(data.tobytes())
                    == theirs.parse_sds_data(data.tobytes()))

    def test_structured_payloads_identical(self):
        mine = TetraProtocolParser()
        theirs = RefParser()
        cases = [
            bytes.fromhex("0500C8") + b"HELLO",
            bytes([0x07, 0x00, 10]) + bytes.fromhex("E8329BFD4697D9EC37"),
            bytes([0x82]) + b"Testing message 123",
            bytes([0x03]) + b"PLAIN ASCII",
            bytes([0x83, 0x00, 0x12, 0x34, 0x56, 0x78, 0x9A, 0xBC, 0xDE]),
            bytes([0x0C]) + bytes(12),
            b"Direct readable text here",
            bytes([0x10, 0x10, 0x20, 0x10, 0x20]),
        ]
        for data in cases:
            assert mine.parse_sds_data(data) == theirs.parse_sds_data(data), data


class TestMacPduAB:
    @pytest.mark.parametrize("seed", range(6))
    def test_random_bits_identical(self, seed):
        rng = np.random.default_rng(100 + seed)
        mine = TetraProtocolParser()
        theirs = RefParser()
        for _ in range(40):
            bits = rng.integers(0, 2, int(rng.integers(8, 240)))
            a = mine.parse_mac_pdu(bits.copy())
            b = theirs.parse_mac_pdu(bits.copy())
            if a is None or b is None:
                assert a is None and b is None
                continue
            assert a.pdu_type.name == b.pdu_type.name
            assert a.encrypted == b.encrypted
            assert a.address == b.address
            assert a.length == b.length
            assert a.data == b.data
            assert a.reassembled_data == b.reassembled_data
        # fragment state converges identically
        assert bytes(mine.fragment_buffer) == bytes(theirs.fragment_buffer)

    def test_burst_parse_identical(self, rng):
        mine = TetraProtocolParser()
        theirs = RefParser()
        for _ in range(20):
            symbols = rng.integers(0, 4, 255)
            a = mine.parse_burst(symbols.copy())
            b = theirs.parse_burst(symbols.copy())
            assert a.burst_type.name == b.burst_type.name
            assert a.crc_ok == b.crc_ok
            np.testing.assert_array_equal(a.data_bits, b.data_bits)
        assert mine.get_statistics() == theirs.get_statistics()


class TestFindSyncAB:
    @pytest.mark.parametrize("threshold", [0.90, 0.85, 0.80])
    def test_positions_and_max_corr(self, threshold):
        mine = TetraDecoder(auto_decrypt=False)
        theirs = RefDecoder(auto_decrypt=False)
        for seed in range(6):
            rng = np.random.default_rng(seed)
            bits = rng.integers(0, 2, 1200)
            if seed % 2:
                bits[100:122] = np.asarray(
                    [1, 1, 0, 1, 0, 0, 0, 0, 1, 1, 1, 0, 1, 0, 0, 1, 1, 1,
                     0, 1, 0, 0])
            a_pos, a_max = mine.find_sync(bits, threshold,
                                          return_max_corr=True)
            b_pos, b_max = theirs.find_sync(bits, threshold,
                                            return_max_corr=True)
            assert a_pos == b_pos, seed
            assert abs(a_max - b_max) < 1e-6


def _strip_volatile(frame: dict) -> dict:
    """Normalize a frame dict for A/B comparison."""
    out = {}
    for k, v in frame.items():
        if k in ("sync_position",):          # this repo's extra key
            continue
        if isinstance(v, np.ndarray):
            v = v.tolist()
        if isinstance(v, dict):
            v = {kk: (vv.tolist() if isinstance(vv, np.ndarray) else vv)
                 for kk, vv in v.items()}
        out[k] = v
    return out


class TestFullDecodeAB:
    def test_golden_stream_frames_identical(self):
        """The decisive check: identical symbol streams through both full
        decoders produce identical frame dictionaries."""
        stream = synth.make_stream_bits(num_frames=4, lead_bits=64, seed=2,
                                        golden=True)
        symbols = synth.bits_to_symbols(stream)
        a = TetraDecoder(auto_decrypt=False).decode(symbols.copy())
        b = RefDecoder(auto_decrypt=False).decode(symbols.copy())
        assert len(a) == len(b)
        for fa, fb in zip(a, b):
            assert _strip_volatile(fa) == _strip_volatile(fb)

    @pytest.mark.parametrize("seed", range(4))
    def test_random_streams_identical(self, seed):
        rng = np.random.default_rng(300 + seed)
        symbols = rng.integers(0, 4, 3000)
        a = TetraDecoder(auto_decrypt=False).decode(symbols.copy())
        b = RefDecoder(auto_decrypt=False).decode(symbols.copy())
        assert len(a) == len(b), seed
        for fa, fb in zip(a, b):
            assert _strip_volatile(fa) == _strip_volatile(fb)

    def test_decrypt_path_identical(self):
        """Auto-decrypt on an encrypted-looking golden frame: keys tried,
        scores, chosen key and decrypted bytes must match."""
        stream = synth.make_stream_bits(num_frames=3, lead_bits=64, seed=5,
                                        golden=True,
                                        payload=b"\x01\x02\x03\x04\x05\x06"
                                                b"\x07\x08\x09\x0a\x0b\x0c")
        symbols = synth.bits_to_symbols(stream)
        a = TetraDecoder(auto_decrypt=True).decode(symbols.copy())
        b = RefDecoder(auto_decrypt=True).decode(symbols.copy())
        assert len(a) == len(b)
        for fa, fb in zip(a, b):
            for key in ("encrypted", "decrypted", "keys_tried", "best_score",
                        "best_key", "key_used", "decrypted_bytes",
                        "bypass_clear", "decrypt_confidence"):
                assert fa.get(key) == fb.get(key), key


class TestProcessorAB:
    def test_ref_exact_symbols_match(self):
        """ref-exact profile vs the actual scipy reference chain."""
        rng = np.random.default_rng(9)
        syms = rng.integers(0, 4, 1500)
        iq = synth.synthesize_iq(syms, freq_offset_hz=3e3, snr_db=18, seed=3)
        mine = SignalProcessor(config=ReceiverConfig(profile="ref-exact"))
        theirs = RefProcessor(sample_rate=2.4e6)
        a = mine.process(iq.copy(), freq_offset=3e3)
        b = theirs.process(iq.copy(), freq_offset=3e3)
        assert len(a) == len(b)
        assert (a == b).mean() >= 0.999

    def test_stage_filter_signal_matches(self, rng):
        x = (rng.standard_normal(8192) + 1j * rng.standard_normal(8192)
             ).astype(np.complex64)
        mine = SignalProcessor(config=ReceiverConfig(profile="ref-exact"),
                               sample_rate=240e3)
        theirs = RefProcessor(sample_rate=240e3)
        a = mine.filter_signal(x, bandwidth=25000)
        b = theirs.filter_signal(x, bandwidth=25000)
        rel = np.linalg.norm(a - b) / np.linalg.norm(b)
        assert rel < 1e-3


class TestValidatorAB:
    def test_validate_frames_identical(self):
        frames = [
            {"crc_ok": True, "type_name": "MAC-RESOURCE",
             "call_metadata": {"mcc": 260, "mnc": 1}},
            {"crc_ok": False, "type_name": None, "additional_info": {}},
            {"type_name": "MAC-BROADCAST",
             "call_metadata": {"mcc": 100, "mnc": 5}},
            {"type_name": "MAC-FRAG", "encrypted": True,
             "encryption_algorithm": "XXX", "additional_info": {}},
            {"type_name": "MAC-DATA", "decrypted": True,
             "decrypt_confidence": 90, "additional_info": {}},
        ]
        mine = TetraSignalValidator(expected_country_mcc=260)
        theirs = RefValidator(expected_country_mcc=260)
        for f in frames:
            assert mine.validate_frame(dict(f)) == theirs.validate_frame(dict(f))
        assert mine.get_statistics() == theirs.get_statistics()


class TestEndToEndAB:
    """The BASELINE acceptance criterion, literally: identical IQ through
    both complete stacks (DSP + decode) -> identical frame output."""

    def _run_both(self, iq, freq_offset=0.0, auto_decrypt=False):
        mine_sp = SignalProcessor(config=ReceiverConfig(profile="ref-exact"))
        ref_sp = RefProcessor(sample_rate=2.4e6)
        a_sym = mine_sp.process(iq.copy(), freq_offset=freq_offset)
        b_sym = ref_sp.process(iq.copy(), freq_offset=freq_offset)
        a = TetraDecoder(auto_decrypt=auto_decrypt).decode(a_sym)
        b = RefDecoder(auto_decrypt=auto_decrypt).decode(b_sym)
        return a, b, a_sym, b_sym

    def test_golden_capture_bit_exact_frames(self):
        stream = synth.make_stream_bits(num_frames=5, lead_bits=64, seed=2,
                                        golden=True)
        syms = synth.bits_to_symbols(stream)
        phasors = synth.synthesize_symbol_phasors(syms, mapping="ref")
        iq = synth.upsample_hold(phasors, 2.4e6, 2.4e6 / 130.0
                                 ).astype(np.complex64)
        a, b, a_sym, b_sym = self._run_both(iq)
        assert (a_sym == b_sym).mean() >= 0.999
        assert len(a) == len(b) and len(a) >= 3
        for fa, fb in zip(a, b):
            assert _strip_volatile(fa) == _strip_volatile(fb)

    def test_noisy_capture_with_offset(self):
        stream = synth.make_stream_bits(num_frames=5, lead_bits=64, seed=7,
                                        golden=True)
        syms = synth.bits_to_symbols(stream)
        phasors = synth.synthesize_symbol_phasors(syms, mapping="ref")
        iq = synth.upsample_hold(phasors, 2.4e6, 2.4e6 / 130.0)
        rng = np.random.default_rng(8)
        t = np.arange(len(iq)) / 2.4e6
        iq = iq * np.exp(2j * np.pi * 2e3 * t)
        iq = (iq + 0.05 * (rng.standard_normal(len(iq))
                           + 1j * rng.standard_normal(len(iq)))
              ).astype(np.complex64)
        a, b, a_sym, b_sym = self._run_both(iq, freq_offset=2e3)
        agree = (a_sym == b_sym).mean()
        assert agree >= 0.995, agree
        assert len(a) == len(b)
        for fa, fb in zip(a, b):
            assert _strip_volatile(fa) == _strip_volatile(fb)

    def test_auto_decrypt_end_to_end(self):
        stream = synth.make_stream_bits(
            num_frames=3, lead_bits=64, seed=5, golden=True,
            payload=bytes(range(1, 13)))
        syms = synth.bits_to_symbols(stream)
        phasors = synth.synthesize_symbol_phasors(syms, mapping="ref")
        iq = synth.upsample_hold(phasors, 2.4e6, 2.4e6 / 130.0
                                 ).astype(np.complex64)
        a, b, _, _ = self._run_both(iq, auto_decrypt=True)
        assert len(a) == len(b)
        for fa, fb in zip(a, b):
            assert _strip_volatile(fa) == _strip_volatile(fb)


class TestAuxAB:
    def test_symbols_to_bits_8psk_fold(self, rng):
        mine = TetraDecoder(auto_decrypt=False)
        theirs = RefDecoder(auto_decrypt=False)
        for _ in range(5):
            syms = rng.integers(0, 8, 200)
            a_bits, a_map = mine.symbols_to_bits(syms.copy())
            b_bits, b_map = theirs.symbols_to_bits(syms.copy())
            np.testing.assert_array_equal(a_bits, b_bits)
            np.testing.assert_array_equal(a_map, b_map)

    def test_set_keys_parsing(self):
        mine = TetraDecoder(auto_decrypt=True)
        theirs = RefDecoder(auto_decrypt=True)
        keys = ["00112233445566778899",
                "0123456789ABCDEF0123456789ABCDEF",
                "00" * 32, "AB:CD:EF", "zz"]
        mine.set_keys(keys)
        theirs.set_keys(keys)
        assert mine.user_keys == theirs.user_keys

    def test_detector_analysis_fields(self, rng):
        from tetraear.signal.scanner import TetraSignalDetector as RefDet
        from tetraear_tpu.signal.detector import TetraSignalDetector
        x = synth.synthesize_iq(rng.integers(0, 4, 2000), snr_db=20, seed=3)
        a = TetraSignalDetector().analyze_signal(x.copy())
        b = RefDet().analyze_signal(x.copy())
        assert abs(a["power_db"] - b["power_db"]) < 1e-3
        assert abs(a["modulation_confidence"]
                   - b["modulation_confidence"]) < 1e-3
        assert abs(a["sync_correlation"] - b["sync_correlation"]) < 1e-6
        assert a["sync_detected"] == b["sync_detected"]
        assert a["power_stable"] == b["power_stable"]

    def test_location_parser(self):
        from tetraear.core.location import LocationParser as RefLoc
        from tetraear_tpu.core.location import LocationParser
        texts = ["Lat: 52.24170 Lon: 21.00830",
                 "52°14'30\"N 21°00'30\"E",
                 "N52.2417 E021.0083", "no coords here"]
        for t in texts:
            assert (LocationParser.parse_coordinates(t)
                    == RefLoc.parse_coordinates(t))
        data = bytes([0x00]) + (1234567).to_bytes(3, "big") \
            + (654321).to_bytes(3, "big") + bytes(4)
        assert (LocationParser.parse_lip_message(data)
                == RefLoc.parse_lip_message(data))

    def test_mcc_lookup(self):
        from tetraear.core.mcc_mnc import get_country_from_mcc as ref_cc
        from tetraear_tpu.core.mcc_mnc import get_country_from_mcc
        for mcc in ("260", "262", "310", "999", "208"):
            assert get_country_from_mcc(mcc) == ref_cc(mcc)


class TestVoiceAB:
    def test_voice_processor_identical_pcm(self, rng):
        """Same codec binaries + same block -> byte-identical PCM through
        both subprocess wrappers (uses the contract-exact test codec)."""
        testcodec = Path(__file__).resolve().parents[2] / "native" / "testcodec"
        if not (testcodec / "cdecoder").exists():
            pytest.skip("test codec not built")
        from tetraear.audio.voice import VoiceProcessor as RefVoice
        from tetraear_tpu.audio.blocks import block_from_hard_bits
        from tetraear_tpu.audio.voice import VoiceProcessor

        mine = VoiceProcessor(codec_dir=testcodec)
        # the reference defaults to .exe names; pass explicit Linux paths
        theirs = RefVoice(cdecoder_path=testcodec / "cdecoder",
                          sdecoder_path=testcodec / "sdecoder")
        assert mine.working and theirs.working
        for seed in range(3):
            bits = np.random.default_rng(seed).integers(0, 2, 432)
            block = block_from_hard_bits(bits)
            # these blocks are UNRELATED streams: drop the warm-up
            # context our wrapper adds for consecutive blocks of one
            # call (round 5; its quality win has its own test,
            # tests/codec/test_real_codec.py::test_per_block_context_
            # priming) — the reference wrapper is stateless per block,
            # and so is ours given no prior context
            mine.reset_context()
            a = mine.decode_frame(block)
            b = theirs.decode_frame(block)
            np.testing.assert_array_equal(a, b)
        # invalid inputs rejected identically
        assert mine.decode_frame(bytes(1380)).size == \
            theirs.decode_frame(bytes(1380)).size == 0
        assert mine.decode_frame(b"x").size == theirs.decode_frame(b"x").size


class TestScannerAB:
    def test_scan_frequency_identical_analysis(self):
        """Same fake capture source through both scanners -> same analysis
        dict fields (detector + gates)."""
        from tetraear.signal.scanner import FrequencyScanner as RefScanner
        from tetraear_tpu.signal.scanner import FrequencyScanner

        class FakeSource:
            sdr = None

            def __init__(self):
                rng = np.random.default_rng(0)
                syms = rng.integers(0, 4, 3000)
                self._x = synth.synthesize_iq(syms, snr_db=22, seed=4)

            def set_frequency(self, f):
                self.frequency = f

            def read_samples(self, n):
                return self._x[:n]

        mine = FrequencyScanner(FakeSource(), settle_s=0.0)
        theirs = RefScanner(FakeSource())
        import time as _time
        sleep = _time.sleep
        _time.sleep = lambda s: None        # skip the reference's PLL settle
        try:
            a = mine.scan_frequency(392.5e6, dwell_time=0.05)
            b = theirs.scan_frequency(392.5e6, dwell_time=0.05)
        finally:
            _time.sleep = sleep
        for key in ("frequency", "frequency_mhz", "sync_detected",
                    "power_stable", "signal_present"):
            assert a[key] == b[key], key
        assert abs(a["power_db"] - b["power_db"]) < 1e-3
        assert abs(a["modulation_confidence"]
                   - b["modulation_confidence"]) < 1e-3
        assert abs(a["sync_correlation"] - b["sync_correlation"]) < 1e-6
        assert a["is_tetra"] == b["is_tetra"]
