"""Complete etsi-profile link layer: transmit-side burst building and
sync-driven receive down to MAC bits.

The reference is receive-only and never channel-codes (protocol.py:300);
this module closes the loop with a self-consistent over-the-air format so
the framework is a full TX/RX PHY+link stack that can be regression-tested
end to end without recorded captures:

    burst := TS1 (22 bits = 11 symbols) || type-5 coded block
    SCH/F block = 432 bits (216 symbols) -> burst = 227 symbols

(The true ETSI burst field offsets — broadcast bits, phase-adjustment
 fields, mid-burst training placement — require spec access unavailable in
 this environment; this framing keeps every coded-chain element real while
 making the burst layout explicit and swappable, see protocol/bursts.py.)

Receive: the etsi receiver's dense TS1/TS2 sync correlation locates burst
starts; soft bits following each hit feed the full channel-decode chain
(descramble -> de-interleave -> depuncture -> Viterbi -> CRC), and CRC-valid
MAC bits flow into the standard protocol parser.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import jax.numpy as jnp

from tetraear_tpu import constants as C
from tetraear_tpu.config import ReceiverConfig
from tetraear_tpu.models.receiver_etsi import EtsiReceiver
from tetraear_tpu.ops import channel_coding as cc
from tetraear_tpu.protocol.parser import TetraProtocolParser
from tetraear_tpu.utils import synth

SYNC_SYMBOLS = C.SYNC_LEN_BITS // 2          # 11


class EtsiFrame(NamedTuple):
    sync_symbol: int          # symbol index of the TS1 hit
    crc_ok: bool
    mac_bits: np.ndarray      # (type1,) decoded MAC bits
    mac_pdu: Optional[object]


def build_burst_bits(type1_bits: np.ndarray, channel: str = "SCH/F",
                     ecc30: int = 0) -> np.ndarray:
    """MAC bits -> over-the-air burst bits (TS1 || type-5 block)."""
    coded = cc.encode_channel(type1_bits, channel, ecc30=ecc30)
    return np.concatenate([C.TS1, coded]).astype(np.uint8)


def transmit(mac_frames: List[np.ndarray], channel: str = "SCH/F",
             ecc30: int = 0, gap_symbols: int = 16,
             sample_rate: float = C.DEFAULT_SAMPLE_RATE_HZ,
             symbol_rate: float = C.SYMBOL_RATE_HZ,
             snr_db: float | None = None, seed: int = 0) -> np.ndarray:
    """MAC bit blocks -> pi/4-DQPSK IQ at the capture rate."""
    rng = np.random.default_rng(seed)
    pieces = [rng.integers(0, 2, 2 * gap_symbols).astype(np.uint8)]
    for mac in mac_frames:
        pieces.append(build_burst_bits(mac, channel, ecc30))
        pieces.append(rng.integers(0, 2, 2 * gap_symbols).astype(np.uint8))
    bits = np.concatenate(pieces)
    syms = synth.bits_to_symbols(bits)
    phasors = synth.synthesize_symbol_phasors(syms, mapping="pi4")
    x = synth.upsample_hold(phasors, sample_rate, symbol_rate)
    if snr_db is not None:
        std = 10 ** (-snr_db / 20) / np.sqrt(2)
        x = x + std * (rng.standard_normal(len(x))
                       + 1j * rng.standard_normal(len(x)))
    return x.astype(np.complex64)


class EtsiLinkReceiver:
    """IQ -> CRC-gated MAC bits -> parsed PDUs (full etsi RX stack)."""

    SYNC_THRESHOLD = 0.86     # 19/22 bits of the TS must match

    def __init__(self, config: ReceiverConfig | None = None,
                 channel: str = "SCH/F", ecc30: int = 0):
        self.rx = EtsiReceiver(config)
        self.channel = channel
        self.ecc30 = ecc30
        self.parser = TetraProtocolParser()
        _, self.air_bits = cc.CHANNEL_GEOMETRY[channel]

    def receive(self, iq, freq_offset: float = 0.0) -> List[EtsiFrame]:
        res = self.rx(iq, freq_offset)
        count = int(res.count)
        if count < SYNC_SYMBOLS + self.air_bits // 2 + 2:
            return []
        soft = np.asarray(res.soft_bits)[:count - 1].reshape(-1)
        corr = np.asarray(res.sync_corr)[:max(0, 2 * (count - 1)
                                              - C.SYNC_LEN_BITS + 1)]

        # greedy sync walk (burst-spaced skip)
        burst_bits = C.SYNC_LEN_BITS + self.air_bits
        hits = []
        i = 0
        cand = np.flatnonzero(corr >= self.SYNC_THRESHOLD)
        while True:
            ci = np.searchsorted(cand, i)
            if ci >= len(cand):
                break
            pos = int(cand[ci])
            hits.append(pos)
            i = pos + burst_bits - C.SYNC_LEN_BITS // 2

        frames: List[EtsiFrame] = []
        for pos in hits:
            start = pos + C.SYNC_LEN_BITS
            llrs = soft[start:start + self.air_bits]
            if llrs.shape[0] < self.air_bits:
                continue
            dec = cc.decode_channel_soft(jnp.asarray(llrs), self.channel,
                                         ecc30=self.ecc30)
            crc_ok = bool(dec.crc_ok)
            mac_bits = np.asarray(dec.bits)
            pdu = None
            if crc_ok:
                try:
                    pdu = self.parser.parse_mac_pdu(mac_bits)
                except Exception:
                    pdu = None
            frames.append(EtsiFrame(pos // 2, crc_ok, mac_bits, pdu))
        return frames
