"""Uplink burst TX/RX: normal uplink bursts (NUB) and control uplink
bursts (CB) with SCH/HU — the mobile-side of the air interface.

The reference is strictly a downlink monitor (BladeRF tuned to a base
station); this module extends the framework to uplink/direct-mode
monitoring: a mobile's scheduled bursts arrive as isolated transmissions
(no continuous carrier, no NTS3 straddle, no AACH), located by midamble
correlation (NTS for NUB at bit 220, ETS for CB at bit 88) and decoded
with the cell scrambling learned from the downlink BSCH
(models/downlink.py).

Burst layouts: protocol/bursts.py NUB_FIELDS / CB_FIELDS (EN 300 392-2
§9.4.4.1).  Device/host split as everywhere: dense correlation + batched
channel decodes on device, the data-dependent burst walk on host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import jax.numpy as jnp

from tetraear_tpu import constants as C
from tetraear_tpu.config import ReceiverConfig
from tetraear_tpu.models.receiver_etsi import EtsiReceiver
from tetraear_tpu.ops import channel_coding as cc
from tetraear_tpu.protocol import bursts, layer3
from tetraear_tpu.protocol import mac as mac_l2
from tetraear_tpu.protocol import mle
from tetraear_tpu.protocol.parser import TetraProtocolParser
from tetraear_tpu.utils import synth


@dataclass
class UplinkFrame:
    kind: str                     # "NUB" | "CB"
    start_bit: int                # stream position of the burst start
    channel: str                  # "SCH/F" | "SCH/HU"
    crc_ok: bool
    mac_bits: Optional[np.ndarray]
    mac_pdu: Optional[object] = None
    sds_message: Optional[str] = None
    layer3: Optional[List[object]] = None   # routed Layer3Result list
    # TDMA coordinates (UplinkSlotMonitor only; the uplink clock is
    # slaved to the downlink frame clock)
    tn: Optional[int] = None
    fn: Optional[int] = None
    mn: Optional[int] = None
    slot_index: Optional[int] = None
    timing_offset: int = 0        # residual bits vs the locked slot grid
    # traffic decode outputs (UplinkSlotMonitor with traffic_tns)
    voice_block: Optional[bytes] = None     # TCH/S 690-short codec block
    tch_bits: Optional[np.ndarray] = None   # TCH/7.2 decoded bits


class UplinkTransmitter:
    """Build isolated uplink bursts for a cell's scrambling code."""

    def __init__(self, cell_ecc30: int = 0):
        self.ecc = cell_ecc30

    def nub_bits(self, mac268: np.ndarray, training: int = 1) -> np.ndarray:
        coded = cc.encode_channel(mac268, "SCH/F", ecc30=self.ecc)
        return bursts.build_nub(coded[:216], coded[216:], training)

    def cb_bits(self, mac92: np.ndarray) -> np.ndarray:
        coded = cc.encode_channel(mac92, "SCH/HU", ecc30=self.ecc)
        return bursts.build_cb(coded)

    # --- layer-3 signalling (uplink CMCE via MAC-ACCESS / MAC-DATA) ---
    def access_cb(self, pdu, ssi: int) -> np.ndarray:
        """U-plane CMCE PDU -> MAC-ACCESS -> control burst bits."""
        tm = mle.wrap_mle(mle.PD.CMCE, pdu.build())
        k1, _ = cc.CHANNEL_GEOMETRY["SCH/HU"]
        block = mac_l2.MacAccess(address=ssi, tm_sdu=tm).build(k1)
        return self.cb_bits(block)

    def signalling_nub(self, pdu, ssi: int, training: int = 1
                       ) -> np.ndarray:
        """CMCE PDU -> MAC-DATA -> full normal uplink burst bits."""
        tm = mle.wrap_mle(mle.PD.CMCE, pdu.build())
        k1, _ = cc.CHANNEL_GEOMETRY["SCH/F"]
        block = mac_l2.MacUplinkData(address=ssi, tm_sdu=tm).build(k1)
        return self.nub_bits(block, training)

    def traffic_nub(self, type5_bits: np.ndarray,
                    training: int = 1) -> np.ndarray:
        """One 432-bit coded traffic block (ops/channel_coding.encode_tch
        output row) -> normal uplink burst bits."""
        t5 = np.asarray(type5_bits).astype(np.uint8).reshape(-1)
        assert t5.size == 432
        return bursts.build_nub(t5[:216], t5[216:], training)

    def transmit(self, burst_bits: List[np.ndarray], gap_bits: int = 64,
                 sample_rate: float = C.DEFAULT_SAMPLE_RATE_HZ,
                 snr_db: float | None = None, seed: int = 0) -> np.ndarray:
        """Bursts separated by `gap_bits` of filler -> π/4-DQPSK IQ.

        (A real uplink ramps power down between bursts; for monitor tests
        the filler keeps the demodulator's clock fed, which only makes the
        false-sync rejection job *harder* — the midamble correlator must
        discriminate against modulated filler, not silence.)
        """
        rng = np.random.default_rng(seed)
        pieces = [rng.integers(0, 2, gap_bits).astype(np.uint8)]
        for b in burst_bits:
            pieces.append(np.asarray(b).astype(np.uint8))
            pieces.append(rng.integers(0, 2, gap_bits).astype(np.uint8))
        syms = synth.bits_to_symbols(np.concatenate(pieces))
        return synth.synthesize_iq(syms, sample_rate, snr_db=snr_db,
                                   mapping="pi4", seed=seed)

    def slot_stream_bits(self, slot_map: Dict[int, np.ndarray],
                         num_slots: int, lead_bits: int = 0,
                         seed: int = 0) -> np.ndarray:
        """Grid-aligned uplink stream: `num_slots` x 510-bit TDMA slots.

        slot_map: {slot_index: full burst bits (510 for NUB; a CB burst is
        zero-padded to the slot)}.  Idle slots carry modulated filler (a
        silent MS; random bits keep the monitor's clock fed — harder than
        silence for false-lock rejection).  The uplink slot grid is slaved
        to the downlink's (EN 300 392-2 §7: the MS transmits on the
        downlink-derived timebase), so `lead_bits` models the capture
        starting mid-slot."""
        rng = np.random.default_rng(seed)
        out = [rng.integers(0, 2, lead_bits).astype(np.uint8)]
        for k in range(num_slots):
            if k in slot_map:
                b = np.asarray(slot_map[k]).astype(np.uint8)
                assert b.size <= C.BITS_PER_SLOT
                pad = rng.integers(0, 2, C.BITS_PER_SLOT - b.size
                                   ).astype(np.uint8)
                out.append(np.concatenate([b, pad]))
            else:
                out.append(rng.integers(0, 2, C.BITS_PER_SLOT
                                        ).astype(np.uint8))
        return np.concatenate(out)

    def transmit_slots(self, slot_map: Dict[int, np.ndarray],
                       num_slots: int, lead_bits: int = 0,
                       sample_rate: float = C.DEFAULT_SAMPLE_RATE_HZ,
                       snr_db: float | None = None,
                       seed: int = 0) -> np.ndarray:
        bits = self.slot_stream_bits(slot_map, num_slots, lead_bits, seed)
        syms = synth.bits_to_symbols(bits)
        return synth.synthesize_iq(syms, sample_rate, snr_db=snr_db,
                                   mapping="pi4", seed=seed)


class UplinkMonitor:
    """Locate and decode isolated uplink bursts in a capture."""

    NTS_THRESHOLD = 0.87          # 20/22
    ETS_THRESHOLD = 0.87          # 27/30

    def __init__(self, cell_ecc30: int = 0,
                 config: ReceiverConfig | None = None):
        self.ecc = cell_ecc30
        self.rx = EtsiReceiver(config)
        self.parser = TetraProtocolParser()

    def receive(self, iq, freq_offset: float = 0.0) -> List[UplinkFrame]:
        res = self.rx(iq, freq_offset)
        count = int(res.count)
        if count < 2:
            return []
        soft = np.asarray(res.soft_bits)[:count - 1].reshape(-1)
        return self.receive_soft(soft)

    def receive_bits(self, bits: np.ndarray) -> List[UplinkFrame]:
        return self.receive_soft(np.asarray(bits).astype(np.float32) * 2 - 1)

    def receive_soft(self, llrs: np.ndarray) -> List[UplinkFrame]:
        from tetraear_tpu.models.downlink import _pattern_corr
        hard = (llrs > 0).astype(np.uint8)

        nts_lo, _ = bursts.NUB_FIELDS["nts"]
        ets_lo, _ = bursts.CB_FIELDS["ets"]
        cands = []                      # (start, kind), deduped by start
        for pat, thr, off, kind, size in (
                (bursts.NTS1, self.NTS_THRESHOLD, nts_lo, "NUB",
                 bursts.NUB_BITS),
                (bursts.NTS2, self.NTS_THRESHOLD, nts_lo, "NUB",
                 bursts.NUB_BITS),
                (bursts.ETS, self.ETS_THRESHOLD, ets_lo, "CB",
                 bursts.CB_BITS)):
            corr = _pattern_corr(hard, pat)
            for pos in np.flatnonzero(corr >= thr):
                start = int(pos) - off
                if 0 <= start and start + size <= llrs.size:
                    cands.append((start, kind, size))
        cands.sort()

        frames: List[UplinkFrame] = []
        last_end = -1
        for start, kind, size in cands:
            if start < last_end:         # overlapping duplicate hit
                continue
            frame = self._decode_burst(llrs[start:start + size], kind, start)
            if frame is not None:
                frames.append(frame)
                last_end = start + size
        return frames

    def _decode_burst(self, llrs: np.ndarray, kind: str,
                      start: int) -> Optional[UplinkFrame]:
        if kind == "NUB":
            f = bursts.NUB_FIELDS
            coded = np.concatenate([llrs[f["bkn1"][0]:f["bkn1"][1]],
                                    llrs[f["bkn2"][0]:f["bkn2"][1]]])
            dec = cc.decode_channel_soft(jnp.asarray(coded), "SCH/F",
                                         ecc30=self.ecc)
            channel = "SCH/F"
        else:
            f = bursts.CB_FIELDS
            coded = np.concatenate([llrs[f["cb1"][0]:f["cb1"][1]],
                                    llrs[f["cb2"][0]:f["cb2"][1]]])
            dec = cc.decode_channel_soft(jnp.asarray(coded), "SCH/HU",
                                         ecc30=self.ecc)
            channel = "SCH/HU"
        crc_ok = bool(dec.crc_ok)
        if not crc_ok:
            return None                  # correlator false alarm or noise
        mac_bits = np.asarray(dec.bits)
        # true uplink layer 3 first (MAC-ACCESS / MAC-DATA -> U-* CMCE);
        # heuristic parse is the fallback, as on the downlink
        l3 = None
        try:
            results = layer3.decode_uplink_block(mac_bits, channel)
            keep = [r for r in results
                    if r.confident or (r.pdu is None and r.mac_pdu
                                       is not None
                                       and r.mac_pdu.encryption_mode)]
            if keep:
                l3 = keep
        except ValueError:
            pass
        if l3 is not None:
            sds = next((r.sds.text for r in l3
                        if r.sds is not None and r.sds.text), None)
            return UplinkFrame(kind, start, channel, crc_ok, mac_bits,
                               None, sds, layer3=l3)
        mac_pdu = None
        sds = None
        try:
            mac_pdu = self.parser.parse_mac_pdu(mac_bits)
            data = getattr(mac_pdu, "data", None)
            if data:
                sds = self.parser.parse_sds_data(bytes(data))
        except Exception:
            mac_pdu = None
        return UplinkFrame(kind, start, channel, crc_ok, mac_bits,
                           mac_pdu, sds)


class UplinkSlotMonitor:
    """Continuous uplink monitor slaved to the downlink TDMA frame clock.

    The isolated-burst :class:`UplinkMonitor` treats every burst as a
    standalone event (midamble search over the whole stream, hard
    thresholds).  A real uplink is slot-synchronous: the MS transmits on
    the timebase it derives from the downlink (EN 300 392-2 §7), so once
    the downlink receiver has the cell's slot grid and TDMA counters,
    the uplink monitor can (a) LOCK the 510-bit slot grid, (b) attempt a
    decode in *every* slot — midambles too weak for the isolated
    threshold still decode because the CRC is the gate — and (c) label
    each burst with its (TN, FN, MN), which is what links uplink traffic
    to downlink call grants.

    Grid acquisition is self-contained when no downlink anchor is given:
    midamble hits vote on the slot phase (mode of position mod 510), and
    per-burst timing is re-refined within ±`timing_slack` bits of the
    grid — the continuous timing-recovery loop (tracks clock drift; the
    residual is reported per frame as `timing_offset`).
    """

    def __init__(self, cell_ecc30: int = 0,
                 config: ReceiverConfig | None = None,
                 anchor: tuple = (1, 1, 1), timing_slack: int = 2,
                 traffic_tns: Optional[Dict[int, str]] = None):
        self.ecc = cell_ecc30
        self.rx = EtsiReceiver(config)
        self.parser = TetraProtocolParser()
        self.anchor = anchor          # (tn, fn, mn) of grid slot 0
        self.timing_slack = timing_slack
        # {TN: "TCH/S" | "TCH/7.2" | ...}: timeslots a downlink D-SETUP
        # allocated to uplink traffic (core/calls.CallTracker learns
        # these); their NUBs carry TCH payload instead of SCH/F
        self.traffic_tns = traffic_tns or {}
        self.grid_phase: Optional[int] = None

    # ------------------------------------------------------------------
    def receive(self, iq, freq_offset: float = 0.0) -> List[UplinkFrame]:
        res = self.rx(iq, freq_offset)
        count = int(res.count)
        if count < 2:
            return []
        soft = np.asarray(res.soft_bits)[:count - 1].reshape(-1)
        return self.receive_soft(soft)

    def receive_bits(self, bits: np.ndarray) -> List[UplinkFrame]:
        return self.receive_soft(np.asarray(bits).astype(np.float32) * 2 - 1)

    # ------------------------------------------------------------------
    def _acquire_grid(self, hard: np.ndarray) -> Optional[int]:
        """Slot phase from midamble votes: mode of (midamble_pos -
        in-burst offset) mod 510 over confident hits.  ETS (control
        bursts) votes under both half-slot hypotheses — when CBs occupy
        mixed halves the true phase collects votes from both."""
        from tetraear_tpu.models.downlink import _pattern_corr
        nts_lo, _ = bursts.NUB_FIELDS["nts"]
        ets_lo, _ = bursts.CB_FIELDS["ets"]
        votes: List[int] = []
        for pat, offs in ((bursts.NTS1, (nts_lo,)),
                          (bursts.NTS2, (nts_lo,)),
                          (bursts.ETS, (ets_lo, ets_lo + 255))):
            corr = _pattern_corr(hard, pat)
            for pos in np.flatnonzero(corr >= 0.9):
                for off in offs:
                    votes.append((int(pos) - off) % C.BITS_PER_SLOT)
        if not votes:
            return None
        vals, counts = np.unique(votes, return_counts=True)
        return int(vals[np.argmax(counts)])

    def _refine(self, hard: np.ndarray, expect: int, pat) -> tuple:
        """(best_offset, corr) of the midamble near its expected spot."""
        from tetraear_tpu.models.downlink import _pattern_corr
        lo = max(0, expect - self.timing_slack)
        hi = min(hard.size - len(pat), expect + self.timing_slack)
        if hi < lo:
            return 0, 0.0
        seg = hard[lo:hi + len(pat)]
        corr = _pattern_corr(seg, pat)
        if corr.size == 0:
            return 0, 0.0
        k = int(np.argmax(corr))
        return (lo + k) - expect, float(corr[k])

    # ------------------------------------------------------------------
    def receive_soft(self, llrs: np.ndarray) -> List[UplinkFrame]:
        hard = (llrs > 0).astype(np.uint8)
        phase = self._acquire_grid(hard)
        if phase is None:
            return []
        self.grid_phase = phase

        nts_lo, _ = bursts.NUB_FIELDS["nts"]
        ets_lo, _ = bursts.CB_FIELDS["ets"]
        frames: List[UplinkFrame] = []
        drift = 0                       # accumulated clock correction
        slot = 0
        while True:
            start = phase + slot * C.BITS_PER_SLOT + drift
            if start + C.BITS_PER_SLOT > llrs.size:
                break
            tn, fn, mn = advance_tdma_coords(self.anchor, slot)

            # timing recovery: re-center on whichever midamble answers
            best = None
            for pat, off, kind, size in (
                    (bursts.NTS1, nts_lo, "NUB", bursts.NUB_BITS),
                    (bursts.NTS2, nts_lo, "NUB", bursts.NUB_BITS),
                    (bursts.ETS, ets_lo, "CB", bursts.CB_BITS),
                    (bursts.ETS, ets_lo + 255, "CB", bursts.CB_BITS)):
                delta, corr = self._refine(hard, start + off, pat)
                if best is None or corr > best[3]:
                    best = (kind, off, delta, corr, size)
            kind, off, delta, corr, size = best
            b0 = start + delta if kind == "NUB" else \
                start + delta + (off - ets_lo)
            if corr >= 0.75 and 0 <= b0 and b0 + size <= llrs.size:
                if kind == "NUB" and tn in self.traffic_tns:
                    frame = self._decode_traffic(
                        llrs[b0:b0 + size], self.traffic_tns[tn], b0)
                else:
                    frame = self._decode_burst(llrs[b0:b0 + size], kind,
                                               b0)
                if frame is not None:
                    frame.tn, frame.fn, frame.mn = tn, fn, mn
                    frame.slot_index = slot
                    frame.timing_offset = delta
                    frames.append(frame)
                    drift += delta       # track the MS clock (_refine
                    # bounds delta to +/- timing_slack by construction)
            slot += 1
        return frames

    # same burst decode as the isolated monitor
    _decode_burst = UplinkMonitor._decode_burst

    def _decode_traffic(self, llrs: np.ndarray, channel: str,
                        start: int) -> Optional[UplinkFrame]:
        """NUB on a traffic-allocated TN: bkn1+bkn2 carry 432 coded TCH
        bits (no block CRC — kind tagged, crc_ok None as on the
        downlink).  TCH/S returns the 690-short vocoder block in
        mac_bits' place via the frame's sds-free payload path."""
        f = bursts.NUB_FIELDS
        coded = np.concatenate([llrs[f["bkn1"][0]:f["bkn1"][1]],
                                llrs[f["bkn2"][0]:f["bkn2"][1]]])
        out = np.asarray(cc.decode_tch_soft(jnp.asarray(coded), channel,
                                            ecc30=self.ecc, depth=1))[0]
        frame = UplinkFrame("NUB", start, channel, None, None)
        if channel == "TCH/S":
            from tetraear_tpu.audio.blocks import block_from_soft_llrs
            frame.voice_block = block_from_soft_llrs(out)
        else:
            frame.tch_bits = out
        return frame


def advance_tdma_coords(anchor: tuple, slots: int) -> tuple:
    """(tn, fn, mn) of `slots` slots past the anchor (downlink counting,
    models/downlink.advance_tdma)."""
    from tetraear_tpu.models.downlink import advance_tdma
    return advance_tdma(anchor[0], anchor[1], anchor[2], slots)
