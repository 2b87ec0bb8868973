"""True ETSI downlink burst structures (EN 300 392-2 §9.4.4) — the `etsi`
profile's air-interface layout.

Where `models/etsi_link.py`'s original framing was a self-consistent
placeholder (TS || coded block), this module carries the real
continuous-downlink burst field maps:

Normal continuous downlink burst (NDB), 510 bits:

    [  0: 12) normal training sequence 3, bits q11..q22
    [ 12: 14) phase adjustment bits hl1..hl2
    [ 14:230) scrambled block 1 (bkn1, 216 bits)
    [230:244) scrambled broadcast bits bb1..bb14   (first half of AACH)
    [244:266) normal training sequence 1 or 2 (n / p, 22 bits)
    [266:282) scrambled broadcast bits bb15..bb30  (second half of AACH)
    [282:498) scrambled block 2 (bkn2, 216 bits)
    [498:500) phase adjustment bits hu1..hu2
    [500:510) normal training sequence 3, bits q1..q10

Synchronization continuous downlink burst (SB), 510 bits:

    [  0: 12) normal training sequence 3, bits q11..q22
    [ 12: 14) phase adjustment bits hc1..hc2
    [ 14: 94) frequency correction field f1..f80
    [ 94:214) scrambled synchronization block 1 (BSCH, 120 bits)
    [214:244) scrambled broadcast bits bb1..bb30   (AACH, unsplit)
    [244:282) synchronization training sequence y1..y38
    [282:498) scrambled block 2 (bkn2, 216 bits)
    [498:500) phase adjustment bits hd1..hd2
    [500:510) normal training sequence 3, bits q1..q10

Both midambles start at bit 244 — the standard's fixed reference point —
which is what lets a receiver classify burst type from one correlation
position.  NTS3 (q) intentionally straddles the slot boundary in
continuous mode: each burst ends with q1..q10 and the next begins with
q11..q22, so a 22-bit q-correlation also marks slot edges.

Provenance: field offsets, the frequency-correction bit pattern
(f1–f8 = f73–f80 = 1, rest 0 ⇒ a +2.25 kHz tone mid-field), and the
training sequences follow EN 300 392-2 §9.4.4 as reflected in public
implementations (osmo-tetra).  The phase-adjustment *values* are computed
functionally (cancel the accumulated π/4-DQPSK phase of the covered bit
span, §9.4.3.3's stated purpose) rather than from the spec's Table 9.4
index ranges; they are invisible to differential demodulation, and
`tests/unit/test_bursts.py` pins the zero-phase property.  All TX/RX
round trips in this repo are self-consistent against these maps.

The reference implementation has none of this — its "burst parse" slices
a freeform 510-bit window around a 22-bit training hit
(/root/reference/tetraear/core/protocol.py:246-290).
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np

from tetraear_tpu import constants as C
from tetraear_tpu.protocol.bits import as_bit_array

BURST_BITS = C.BITS_PER_SLOT          # 510
MIDAMBLE_POS = 244                    # both NTS and STS start here

# --- Training sequences (§9.4.4.3) -----------------------------------------
# NTS1 (n) and NTS2 (p): the 22-bit sequences the whole repo already uses
# for sync (constants.TS1/TS2, reference decoder.py:196-199).
NTS1 = C.TS1                                           # n1..n22
NTS2 = C.TS2                                           # p1..p22
# NTS3 (q): the continuous-mode slot-straddling sequence.
NTS3 = np.array([1, 0, 1, 1, 0, 1, 1, 1, 0, 0, 0, 0, 0, 1, 1, 0, 1, 0, 1, 1,
                 0, 1], dtype=np.uint8)                # q1..q22
# Extended training sequence (x, 30 bits) — uplink/direct-mode use.
ETS = np.array([1, 0, 0, 1, 1, 1, 0, 1, 0, 0, 0, 0, 1, 1, 1, 0, 1, 0, 0, 1,
                1, 1, 0, 1, 0, 0, 0, 0, 1, 1], dtype=np.uint8)
# Synchronization training sequence (y, 38 bits).
STS = np.array([1, 1, 0, 0, 0, 0, 0, 1, 1, 0, 0, 1, 1, 1, 0, 0, 1, 1, 1, 0,
                1, 0, 0, 1, 1, 1, 0, 1, 0, 0, 0, 0, 1, 1, 0, 1, 1, 1],
               dtype=np.uint8)

# Frequency correction field: f1..f8 = 1, f9..f72 = 0, f73..f80 = 1.
FREQ_CORRECTION = np.concatenate([
    np.ones(8, np.uint8), np.zeros(64, np.uint8), np.ones(8, np.uint8)])

# --- Field maps (half-open bit ranges) --------------------------------------
NDB_FIELDS: Dict[str, tuple] = {
    "q_tail": (0, 12),      # q11..q22
    "pa_hl": (12, 14),
    "bkn1": (14, 230),
    "bb1": (230, 244),      # bb1..bb14
    "nts": (244, 266),
    "bb2": (266, 282),      # bb15..bb30
    "bkn2": (282, 498),
    "pa_hu": (498, 500),
    "q_head": (500, 510),   # q1..q10
}

SB_FIELDS: Dict[str, tuple] = {
    "q_tail": (0, 12),
    "pa_hc": (12, 14),
    "fc": (14, 94),
    "sb1": (94, 214),
    "bb": (214, 244),       # bb1..bb30 unsplit
    "sts": (244, 282),
    "bkn2": (282, 498),
    "pa_hd": (498, 500),
    "q_head": (500, 510),
}

for _name, _fields in (("NDB", NDB_FIELDS), ("SB", SB_FIELDS)):
    _spans = sorted(_fields.values())
    assert _spans[0][0] == 0 and _spans[-1][1] == BURST_BITS
    assert all(a[1] == b[0] for a, b in zip(_spans, _spans[1:])), _name


class SlicedBurst(NamedTuple):
    kind: str                 # "NDB" | "SB"
    fields: Dict[str, np.ndarray]


# --- Phase adjustment --------------------------------------------------------
# pi/4-DQPSK phase increments per dibit, in units of pi/4 (mod 8):
# 00 -> +1, 01 -> +3, 10 -> -1, 11 -> -3  (constants.DQPSK_PHASES).
_DIBIT_STEP8 = {(0, 0): 1, (0, 1): 3, (1, 0): -1, (1, 1): -3}
_STEP8_TO_DIBIT = {1: (0, 0), 3: (0, 1), 7: (1, 0), 5: (1, 1)}


def _phase8(bits: np.ndarray) -> int:
    """Accumulated phase of a dibit stream, in pi/4 units mod 8."""
    b = as_bit_array(bits)
    assert b.size % 2 == 0
    tot = 0
    for i in range(0, b.size, 2):
        tot += _DIBIT_STEP8[(int(b[i]), int(b[i + 1]))]
    return tot % 8


def phase_adjustment_bits(covered_bits: np.ndarray) -> np.ndarray:
    """One dibit cancelling the accumulated phase of `covered_bits`.

    Every dibit step is an odd multiple of pi/4, so a span with an odd
    number of dibits has an odd accumulated step, and adding one more odd
    step can reach any even residue — including exactly 0.  The burst
    builders below always hand this function odd-dibit spans (115 and 113
    dibits), so cancellation is exact; pinned by test_bursts.py.
    """
    acc = _phase8(covered_bits)
    best, best_err = (0, 0), 9
    for step, dibit in _STEP8_TO_DIBIT.items():
        err = (acc + step) % 8
        err = min(err, 8 - err)
        if err < best_err:
            best, best_err = dibit, err
    return np.array(best, dtype=np.uint8)


# --- Builders ----------------------------------------------------------------

def build_ndb(bkn1: np.ndarray, bb30: np.ndarray, bkn2: np.ndarray,
              training: int = 1) -> np.ndarray:
    """Assemble a 510-bit normal continuous downlink burst.

    bkn1/bkn2: 216 scrambled (type-5) bits each; bb30: 30 scrambled AACH
    bits (split 14/16 around the midamble); training: 1 -> NTS1, 2 -> NTS2
    (the standard uses p to flag a second half-slot logical channel).
    """
    bkn1 = as_bit_array(bkn1)
    bkn2 = as_bit_array(bkn2)
    bb30 = as_bit_array(bb30)
    assert bkn1.size == 216 and bkn2.size == 216 and bb30.size == 30
    nts = NTS1 if training == 1 else NTS2

    out = np.zeros(BURST_BITS, np.uint8)
    out[0:12] = NTS3[10:22]
    out[14:230] = bkn1
    out[230:244] = bb30[:14]
    out[244:266] = nts
    out[266:282] = bb30[14:]
    out[282:498] = bkn2
    out[500:510] = NTS3[0:10]
    # hl pins the phase at the midamble (covers [14,244), 115 dibits);
    # hu pins the phase at the slot boundary (covers bkn2 + q-head,
    # 113 dibits — phase is additive, so position within the span is moot).
    out[12:14] = phase_adjustment_bits(out[14:244])
    out[498:500] = phase_adjustment_bits(
        np.concatenate([out[282:498], out[500:510]]))
    return out


def build_sb(sb1: np.ndarray, bb30: np.ndarray, bkn2: np.ndarray) -> np.ndarray:
    """Assemble a 510-bit synchronization continuous downlink burst.

    sb1: 120 scrambled BSCH bits; bb30: 30 scrambled AACH bits;
    bkn2: 216 scrambled bits (SCH/HD content, e.g. SYSINFO).
    """
    sb1 = as_bit_array(sb1)
    bb30 = as_bit_array(bb30)
    bkn2 = as_bit_array(bkn2)
    assert sb1.size == 120 and bb30.size == 30 and bkn2.size == 216

    out = np.zeros(BURST_BITS, np.uint8)
    out[0:12] = NTS3[10:22]
    out[14:94] = FREQ_CORRECTION
    out[94:214] = sb1
    out[214:244] = bb30
    out[244:282] = STS
    out[282:498] = bkn2
    out[500:510] = NTS3[0:10]
    # hc pins the phase at the sync midamble; hd at the slot boundary.
    out[12:14] = phase_adjustment_bits(out[14:244])
    out[498:500] = phase_adjustment_bits(
        np.concatenate([out[282:498], out[500:510]]))
    return out


# --- Slicers / classification ------------------------------------------------

def classify_burst(bits510: np.ndarray) -> str:
    """NDB vs SB from the midamble at bit 244 (hard bits)."""
    b = as_bit_array(bits510)
    assert b.size == BURST_BITS
    mid = b[MIDAMBLE_POS:MIDAMBLE_POS + 38]
    sts_score = int(np.sum(mid == STS))
    n_score = int(np.sum(b[244:266] == NTS1))
    p_score = int(np.sum(b[244:266] == NTS2))
    return "SB" if sts_score >= max(n_score, p_score) + 8 else "NDB"


def slice_burst(bits510: np.ndarray, kind: str | None = None) -> SlicedBurst:
    """Split a 510-bit burst into its named fields (hard or soft arrays)."""
    b = np.asarray(bits510)
    assert b.shape[-1] == BURST_BITS
    if kind is None:
        kind = classify_burst(b)
    fields = NDB_FIELDS if kind == "NDB" else SB_FIELDS
    return SlicedBurst(kind, {k: b[..., lo:hi] for k, (lo, hi) in fields.items()})


def ndb_aach_bits(sliced: SlicedBurst) -> np.ndarray:
    """Recombine the split broadcast halves of an NDB into bb1..bb30."""
    f = sliced.fields
    return np.concatenate([f["bb1"], f["bb2"]], axis=-1)


# ---------------------------------------------------------------------------
# Uplink bursts (EN 300 392-2 §9.4.4.1): transmitted by mobiles in
# scheduled slots, so they are shorter than the 510-bit slot duration —
# the remainder is power ramp + guard time.  The reference has no uplink
# path at all (BladeRF downlink monitor only); these enable uplink/
# direct-mode monitoring and full-duplex link simulation.
#
# Normal uplink burst (NUB), 462 bits (231 symbols) + 48 bits guard:
#
#     [  0:  4) tail bits
#     [  4:220) scrambled block 1 (216)
#     [220:242) normal training sequence 1 or 2 (22)
#     [242:458) scrambled block 2 (216)
#     [458:462) tail bits
#
# Control uplink burst (CB), 206 bits (103 symbols, fits a subslot):
#
#     [  0:  4) tail bits
#     [  4: 88) scrambled block, first half (84)
#     [ 88:118) extended training sequence (x, 30)
#     [118:202) scrambled block, second half (84)
#     [202:206) tail bits
#
# CB carries SCH/HU (92 type-1 -> 168 air bits, split 84/84 around the
# midamble).  Tail-bit *values* are power-ramp aids, irrelevant to
# differential demod; zeros here (documented functional choice, same
# caveat class as the phase-adjustment values).
# ---------------------------------------------------------------------------

NUB_BITS = 462
CB_BITS = 206

NUB_FIELDS: Dict[str, tuple] = {
    "tail_head": (0, 4),
    "bkn1": (4, 220),
    "nts": (220, 242),
    "bkn2": (242, 458),
    "tail_end": (458, 462),
}

CB_FIELDS: Dict[str, tuple] = {
    "tail_head": (0, 4),
    "cb1": (4, 88),
    "ets": (88, 118),
    "cb2": (118, 202),
    "tail_end": (202, 206),
}

for _name, _fields, _total in (("NUB", NUB_FIELDS, NUB_BITS),
                               ("CB", CB_FIELDS, CB_BITS)):
    _spans = sorted(_fields.values())
    assert _spans[0][0] == 0 and _spans[-1][1] == _total
    assert all(a[1] == b[0] for a, b in zip(_spans, _spans[1:])), _name


def build_nub(bkn1: np.ndarray, bkn2: np.ndarray,
              training: int = 1) -> np.ndarray:
    """Assemble a 462-bit normal uplink burst from two scrambled blocks."""
    bkn1 = as_bit_array(bkn1)
    bkn2 = as_bit_array(bkn2)
    assert bkn1.size == 216 and bkn2.size == 216
    out = np.zeros(NUB_BITS, np.uint8)
    out[4:220] = bkn1
    out[220:242] = NTS1 if training == 1 else NTS2
    out[242:458] = bkn2
    return out


def build_cb(coded168: np.ndarray) -> np.ndarray:
    """Assemble a 206-bit control uplink burst from a 168-bit SCH/HU
    type-5 block (split 84/84 around the extended training sequence)."""
    coded = as_bit_array(coded168)
    assert coded.size == 168
    out = np.zeros(CB_BITS, np.uint8)
    out[4:88] = coded[:84]
    out[88:118] = ETS
    out[118:202] = coded[84:]
    return out


def slice_nub(bits462: np.ndarray) -> Dict[str, np.ndarray]:
    b = np.asarray(bits462)
    assert b.shape[-1] == NUB_BITS
    return {k: b[..., lo:hi] for k, (lo, hi) in NUB_FIELDS.items()}


def slice_cb(bits206: np.ndarray) -> Dict[str, np.ndarray]:
    b = np.asarray(bits206)
    assert b.shape[-1] == CB_BITS
    return {k: b[..., lo:hi] for k, (lo, hi) in CB_FIELDS.items()}
