"""Pipeline configuration.

A :class:`ReceiverConfig` fully determines the traced device program: sample
rates, filter designs, demod profile, and block geometry.  All fields are
static (hashable) so a config instance can key JIT caches.

Profiles
--------
``ref-exact``
    Bit-faithful reproduction of the reference DSP chain
    (tetraear/signal/processor.py:221-273): scipy-style ``decimate`` (IIR
    cheby1-8 filtfilt) -> frequency shift -> Butterworth-4 filtfilt ->
    integer-sps best-phase pick -> pi/4-DQPSK quantize.  IIR filtfilt runs as
    a ``lax.scan``; sequential, used for conformance validation.
``ref-compat``
    Decision-equivalent fast path: the IIR filtfilt stages are replaced by
    linear-phase FIR filters with matched squared-magnitude response,
    implemented as polyphase matmuls.  Same decision chain downstream;
    symbol/sync/CRC decisions agree with ``ref-exact`` within the SNR bound
    (see BASELINE.md: conformance is decision-level).
``etsi``
    Quality profile (north-star): rational polyphase resample to an exact
    integer samples-per-symbol grid, RRC matched filter, soft DQPSK output,
    full channel decoding hooks (descramble / de-interleave / Viterbi).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from tetraear_tpu import constants as C


@dataclasses.dataclass(frozen=True)
class ReceiverConfig:
    sample_rate_hz: float = C.DEFAULT_SAMPLE_RATE_HZ
    profile: str = "ref-compat"          # ref-exact | ref-compat | etsi
    block_size: int = 128 * 1024         # IQ samples per processing block

    # --- ref-* profile parameters (processor.py:244-267) ---
    decimation_target_hz: float = C.REF_DECIMATION_TARGET_HZ
    channel_bandwidth_hz: float = C.CHANNEL_BANDWIDTH_HZ
    symbol_rate_hz: float = C.SYMBOL_RATE_HZ

    # FIR approximation orders for ref-compat
    decim_fir_taps_per_phase: int = 12   # prototype length = taps * decim
    channel_fir_taps: int = 65

    # --- etsi profile parameters ---
    etsi_sps: int = 4                    # samples per symbol after resample
    rrc_alpha: float = 0.35              # TETRA RRC roll-off
    rrc_span_symbols: int = 10

    # sync search
    sync_thresholds: Tuple[float, ...] = C.SYNC_THRESHOLDS

    @property
    def decimation_factor(self) -> int:
        """Integer decimation factor, as the reference computes it
        (processor.py:249)."""
        if self.sample_rate_hz > self.decimation_target_hz * 2:
            return max(1, int(self.sample_rate_hz / self.decimation_target_hz))
        return 1

    @property
    def intermediate_rate_hz(self) -> float:
        return self.sample_rate_hz / self.decimation_factor

    @property
    def ref_samples_per_symbol(self) -> int:
        """Integer sps used by the reference symbol picker
        (processor.py:183). Note: deliberately truncates (240000/18000 -> 13)."""
        return int(self.intermediate_rate_hz / self.symbol_rate_hz)


DEFAULT_CONFIG = ReceiverConfig()


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Host decode-orchestration options (core/decoder.py:19-34)."""
    auto_decrypt: bool = True
    key_file: Optional[str] = None
    expected_mcc: Optional[int] = None
