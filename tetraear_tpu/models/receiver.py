"""Receiver pipelines: the flagship "model" of the framework.

A receiver turns a block of complex IQ into demodulated dibit symbols, bits,
and dense sync-correlation scores, entirely on device in one jitted program.
Host code (core/decoder.py) then applies the data-dependent protocol logic.

Two entry layers:

* :class:`Frontend` — the device-native block pipeline.  Static block shapes,
  jit-cached per (length, profile); batched/vmapped variants used by the
  channelizer and the sharded pod pipeline.
* :class:`SignalProcessor` — drop-in behavioral equivalent of the reference
  ``tetraear.signal.processor.SignalProcessor`` (processor.py:18-273): same
  constructor, same ``process(samples, freq_offset) -> uint8 symbols``
  contract, same ``.symbols`` side-channel used by the voice path.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from tetraear_tpu import constants as C
from tetraear_tpu.config import ReceiverConfig
from tetraear_tpu.ops import ddc, dqpsk, fir, iir, sync, timing
from tetraear_tpu.utils import backend


class DemodResult(NamedTuple):
    """Device outputs for one IQ block (padded to static shapes)."""
    symbols_iq: jnp.ndarray    # (M,) complex64 symbol-rate samples (padded)
    hard_symbols: jnp.ndarray  # (M-1,) uint8 dibits (padded)
    bits: jnp.ndarray          # (2*(M-1),) uint8 (padded)
    sync_corr: jnp.ndarray     # (2*(M-1)-21,) float32 best-of-TS1/TS2
    count: jnp.ndarray         # () int32 — number of valid symbol samples
    best_phase: jnp.ndarray    # () int32


def _frontend_block(iq: jnp.ndarray, freq_offset: jnp.ndarray,
                    cfg: ReceiverConfig, apply_shift: bool) -> DemodResult:
    """Trace the full single-carrier chain for a fixed-length block.

    Mirrors processor.py:221-273 stage-for-stage; see ReceiverConfig for the
    per-profile filter substitutions.
    """
    decim = cfg.decimation_factor
    inter_rate = cfg.intermediate_rate_hz

    if cfg.profile == "ref-exact":
        y = iir.decimate_exact(iq, decim) if decim > 1 else iq
        if apply_shift:
            y = ddc.frequency_shift(y, freq_offset, inter_rate)
        cutoff = (cfg.channel_bandwidth_hz / 2) / (inter_rate / 2)
        y = iir.butter_filtfilt_exact(y, cutoff)
    else:  # ref-compat (FIR fast path)
        if decim > 1:
            taps_d = jnp.asarray(fir.design_decimation_fir(
                decim, cfg.decim_fir_taps_per_phase))
            y = fir.fir_decimate(iq, taps_d, decim)
        else:
            y = iq
        if apply_shift:
            y = ddc.frequency_shift(y, freq_offset, inter_rate)
        cutoff = (cfg.channel_bandwidth_hz / 2) / (inter_rate / 2)
        taps_c = jnp.asarray(fir.design_channel_fir(cfg.channel_fir_taps, cutoff))
        y = fir.fir_filter_same(y, taps_c)

    ts = timing.best_phase_pick(y, cfg.ref_samples_per_symbol)
    hard = dqpsk.demodulate_hard(ts.symbols, profile="ref")
    bits = dqpsk.symbols_to_bits(hard)
    corr = sync.best_correlation(bits)
    return DemodResult(ts.symbols, hard, bits, corr, ts.count, ts.best_phase)


class Frontend:
    """Jit-compiled block demodulator for a fixed ReceiverConfig.

    Compilation is cached per input length & shift-presence; feeding
    constant-size blocks (cfg.block_size) gives a single compilation.
    """

    def __init__(self, config: ReceiverConfig | None = None):
        self.config = config or ReceiverConfig()

    @functools.lru_cache(maxsize=8)
    def _compiled(self, n: int, apply_shift: bool):
        cfg = self.config

        @jax.jit
        def run(iq, freq_offset):
            return _frontend_block(iq, freq_offset, cfg, apply_shift)

        return run

    def __call__(self, iq, freq_offset: float = 0.0) -> DemodResult:
        iq = backend.ensure_complex_on_device(iq)
        apply_shift = bool(freq_offset != 0.0)
        fn = self._compiled(iq.shape[-1], apply_shift)
        return fn(iq, jnp.float32(freq_offset))

    # `hash`/`eq` so lru_cache on the bound method works per instance
    def __hash__(self):
        return hash(self.config)

    def __eq__(self, other):
        return isinstance(other, Frontend) and self.config == other.config


class SignalProcessor:
    """Behavioral equivalent of the reference SignalProcessor.

    API parity with tetraear/signal/processor.py:18-273:
      - ``SignalProcessor(sample_rate).process(samples, freq_offset)``
        returns uint8 symbols 0..3
      - ``self.symbols`` holds the complex symbol-rate samples afterwards
        (consumed by the voice extraction path, ui/modern.py:2031-2034)
      - ``resample/filter_signal/frequency_shift/extract_symbols/
        demodulate_dqpsk`` individual stages are exposed with the same
        signatures for tooling/tests.
    """

    def __init__(self, sample_rate: float = C.DEFAULT_SAMPLE_RATE_HZ,
                 config: ReceiverConfig | None = None):
        self.sample_rate = sample_rate
        base = config or ReceiverConfig()
        if base.sample_rate_hz != sample_rate:
            import dataclasses
            base = dataclasses.replace(base, sample_rate_hz=sample_rate)
        self.config = base
        self.symbol_rate = C.SYMBOL_RATE_HZ
        self.samples_per_symbol = int(sample_rate / self.symbol_rate)
        self.symbols: np.ndarray | None = None
        if base.profile == "etsi":
            from tetraear_tpu.models.receiver_etsi import EtsiReceiver
            self._frontend = EtsiReceiver(base)
        else:
            self._frontend = Frontend(base)

    # -- full pipeline ------------------------------------------------------
    def process(self, samples, freq_offset: float = 0.0) -> np.ndarray:
        samples = np.asarray(samples)
        if samples.size == 0:
            self.symbols = np.array([], dtype=complex)
            return np.array([], dtype=np.uint8)
        res = self._frontend(samples, freq_offset)
        count = int(res.count)
        self.symbols = np.asarray(res.symbols_iq)[:count]
        if count < 2:
            return np.array([], dtype=np.uint8)
        return np.asarray(res.hard_symbols)[:count - 1]

    def process_full(self, samples, freq_offset: float = 0.0):
        """Full device outputs (bits/corr/soft) for pipeline consumers."""
        return self._frontend(np.asarray(samples), freq_offset)

    # -- individual stages (API parity; used by tests/tools) ----------------
    def resample(self, samples, target_rate):
        """FFT resample to target rate (processor.py:35-49 semantics)."""
        samples = np.asarray(samples)
        new_n = int(len(samples) * target_rate / self.sample_rate)
        x = backend.ensure_complex_on_device(samples)
        spec = jnp.fft.fft(x)
        out = _fft_resample(spec, len(samples), new_n)
        return np.asarray(out)

    def filter_signal(self, samples, bandwidth=C.CHANNEL_BANDWIDTH_HZ,
                      sample_rate=None):
        fs = sample_rate if sample_rate is not None else self.sample_rate
        samples = np.asarray(samples)
        if samples.size == 0:
            return samples
        cutoff = (bandwidth / 2) / (fs / 2)
        xd = backend.ensure_complex_on_device(samples)
        if self.config.profile == "ref-exact":
            return np.asarray(
                iir.butter_filtfilt_exact(xd, cutoff))
        taps = jnp.asarray(fir.design_channel_fir(
            self.config.channel_fir_taps, cutoff))
        return np.asarray(fir.fir_filter_same(xd, taps))

    def frequency_shift(self, samples, freq_offset, sample_rate=None):
        fs = sample_rate if sample_rate is not None else self.sample_rate
        return np.asarray(ddc.frequency_shift(
            backend.ensure_complex_on_device(samples),
            freq_offset, fs))

    def extract_symbols(self, samples, sample_rate=None):
        fs = sample_rate if sample_rate is not None else self.sample_rate
        samples = np.asarray(samples)
        if samples.size == 0:
            return np.array([], dtype=complex)
        sps = int(fs / self.symbol_rate)
        ts = timing.best_phase_pick(
            backend.ensure_complex_on_device(samples), sps)
        return np.asarray(ts.symbols)[:int(ts.count)]

    def demodulate_dqpsk(self, samples) -> np.ndarray:
        samples = np.asarray(samples)
        if samples.size < 2:
            return np.array([], dtype=np.uint8)
        return np.asarray(dqpsk.demodulate_hard(
            backend.ensure_complex_on_device(samples),
            profile="ref"))


@functools.partial(jax.jit, static_argnums=(1, 2))
def _fft_resample(spec: jnp.ndarray, n: int, new_n: int) -> jnp.ndarray:
    """scipy.signal.resample-style spectral resampling (complex input)."""
    if new_n == n:
        return jnp.fft.ifft(spec)
    k = min(n, new_n)
    half = k // 2
    out = jnp.zeros(new_n, spec.dtype)
    out = out.at[:half + (k % 2)].set(spec[:half + (k % 2)])
    out = out.at[new_n - half:].set(spec[n - half:])
    return jnp.fft.ifft(out) * (new_n / n)
