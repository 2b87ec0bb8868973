"""Transcendental-free, complex-free multi-carrier pipeline.

Functionally equivalent to MulticarrierFrontend for carriers on the
25 kHz grid, built from a restricted op vocabulary: multiply/add, strided
real convolutions, reshapes, reductions, comparisons.  Motivations:

1. **Speed of light**: no cos/sin/atan2 on the hot path.  The mixer
   exploits that every 25 kHz-grid oscillator at fs = 2.4 MS/s is periodic
   in fs/spacing = 96 samples, so mixing is a broadcast multiply against a
   tiny host-precomputed (C, 96) table; the DQPSK quantizer runs as sector
   sign/slope comparisons on z = s[n]*conj(s[n-1]) real/imag parts
   (ops/dqpsk.quantize_z_ref).
2. **Restricted vocabulary**: real f32 arithmetic only, so the whole
   step is plain multiply/add/compare work for any backend.

Everything is (2, ...)-stacked real float32: index 0 = real, 1 = imag.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from tetraear_tpu.config import ReceiverConfig
from tetraear_tpu.ops import dqpsk, fir, sync
from tetraear_tpu.ops.fir import _conv1d_real


class RealPairResult(NamedTuple):
    bits: jnp.ndarray        # (C, B) uint8
    sync_corr: jnp.ndarray   # (C, B-21) float32
    count: jnp.ndarray       # (C,) int32
    best_phase: jnp.ndarray  # (C,) int32


class RealPairDecodeResult(NamedTuple):
    """RealPairResult + the on-device candidate/CRC stage (same fields as
    models/multicarrier.MulticarrierResult minus the complex-free rename)."""
    bits: jnp.ndarray        # (C, B) uint8
    sync_corr: jnp.ndarray   # (C, B-21) float32
    count: jnp.ndarray       # (C,) int32
    best_phase: jnp.ndarray  # (C,) int32
    cand_pos: jnp.ndarray    # (C, K) int32
    cand_corr: jnp.ndarray   # (C, K) float32
    cand_valid: jnp.ndarray  # (C, K) bool
    frame_bits: jnp.ndarray  # (C, K, 510) uint8
    crc_ok: jnp.ndarray      # (C, K) bool


@functools.lru_cache(maxsize=None)
def _mixer_table(num_carriers_key, sample_rate: float, spacing: float,
                 offsets_bytes: bytes) -> np.ndarray:
    offsets = np.frombuffer(offsets_bytes, np.float32)
    period = int(round(sample_rate / spacing))
    n = np.arange(period)
    ph = -2.0 * np.pi * offsets[:, None] * n[None, :] / sample_rate
    return np.stack([np.cos(ph), np.sin(ph)], axis=0).astype(np.float32)


def mixer_table(offsets_hz: np.ndarray, sample_rate: float,
                spacing: float = 25e3) -> np.ndarray:
    """(2, C, period) cos/sin table; requires offsets on the spacing grid."""
    offsets = np.asarray(offsets_hz, np.float32)
    assert np.allclose(offsets % spacing, 0) or \
        np.allclose((offsets % spacing) - spacing, 0, atol=1e-3), \
        "offsets must lie on the channel grid"
    return _mixer_table(len(offsets), float(sample_rate), float(spacing),
                        offsets.tobytes())


def _realpair_block(x_ri: jnp.ndarray, table: jnp.ndarray,
                    cfg: ReceiverConfig, k: int = 0,
                    threshold: float = 0.80):
    """x_ri: (2, N) f32; table: (2, C, P) f32 -> RealPairResult.

    With k > 0, appends the on-device candidate+CRC stage (itself already
    complex/transcendental-free: top_k, gathers, GF(2)-matmul CRC) and
    returns RealPairDecodeResult — the FULL decode compute of
    MulticarrierFrontend in the restricted op vocabulary.
    """
    n = x_ri.shape[-1]
    period = table.shape[-1]
    assert n % period == 0
    decim = cfg.decimation_factor
    sps = cfg.ref_samples_per_symbol

    # --- mix via the periodic table: broadcast over N/period tiles --------
    xt = x_ri.reshape(2, 1, n // period, period)
    oc = table[0][None, :, None, :]          # cos, (1, C, 1, P)
    osn = table[1][None, :, None, :]         # sin
    xr, xi = xt[0:1], xt[1:2]
    mr = (xr * oc - xi * osn)[0].reshape(-1, n)          # (C, N)
    mi = (xr * osn + xi * oc)[0].reshape(-1, n)

    # --- decimating FIR + channel FIR (real convs) ------------------------
    taps_d = jnp.asarray(fir.design_decimation_fir(
        decim, cfg.decim_fir_taps_per_phase))
    g1 = (taps_d.shape[0] - 1) // 2
    yr = _conv1d_real(mr, taps_d, decim, (g1, g1))
    yi = _conv1d_real(mi, taps_d, decim, (g1, g1))
    cutoff = (cfg.channel_bandwidth_hz / 2) / (cfg.intermediate_rate_hz / 2)
    taps_c = jnp.asarray(fir.design_channel_fir(cfg.channel_fir_taps, cutoff))
    g2 = (taps_c.shape[0] - 1) // 2
    yr = _conv1d_real(yr, taps_c, 1, (g2, g2))
    yi = _conv1d_real(yi, taps_c, 1, (g2, g2))

    return _demod_from_pair(yr, yi, sps, k, threshold)


def _demod_from_pair(yr: jnp.ndarray, yi: jnp.ndarray, sps: int,
                     k: int = 0, threshold: float = 0.80,
                     z_rot: tuple | None = None):
    """Channel-rate (C, M) real/imag pair -> demod/sync[/candidates].

    The gather-free timing+demod tail shared by the DDC-bank and PFB
    real-pair frontends (complex equivalent: ops/timing.best_phase_pick +
    ops/dqpsk.demodulate_hard).

    z_rot: optional per-carrier (cos, sin) of the deferred residual
    rotation (ops/fused.symbol_rotation) — applied to z as one (C, 1)
    broadcast, replacing the full (C, M) rotation stage the caller
    skipped with fused_channelize_ri(rotate=False)."""
    # --- best-phase timing + symbol pick on ONE free-reshape grid ---------
    # grid[c, k, p] = y[c, k*sps + p]: a contiguous-prefix reshape, never a
    # gather, transpose, or strided-slice stack (an sps-way slice stack
    # would re-materialize the full channel-rate array twice).  The same
    # grid feeds the per-phase power sums AND the symbol pick.
    m_dec = yr.shape[-1]
    m = m_dec // sps
    grid_r = yr[:, :m * sps].reshape(-1, m, sps)          # (C, M, sps)
    grid_i = yi[:, :m * sps].reshape(-1, m, sps)
    phase_power = (grid_r ** 2 + grid_i ** 2).sum(axis=1)  # (C, sps)
    best = jnp.argmax(phase_power, axis=-1).astype(jnp.int32)
    count = ((m_dec - best) // sps).astype(jnp.int32)

    # extract symbols at the chosen phase: an exact selection along the
    # sps axis (a one-hot matmul here would round the picked samples
    # wherever f32 matmuls run at reduced precision)
    pick = best[:, None, None]
    sym_r = jnp.take_along_axis(grid_r, pick, axis=-1)[..., 0]   # (C, M)
    sym_i = jnp.take_along_axis(grid_i, pick, axis=-1)[..., 0]

    # --- differential + sector quantizer (no atan2) -----------------------
    zr = sym_r[:, 1:] * sym_r[:, :-1] + sym_i[:, 1:] * sym_i[:, :-1]
    zi = sym_i[:, 1:] * sym_r[:, :-1] - sym_r[:, 1:] * sym_i[:, :-1]
    if z_rot is not None:
        cd = jnp.asarray(z_rot[0], jnp.float32)[:, None]
        sd = jnp.asarray(z_rot[1], jnp.float32)[:, None]
        zr, zi = zr * cd + zi * sd, zi * cd - zr * sd
    hard = dqpsk.quantize_z_ref(zr, zi)
    bits = dqpsk.symbols_to_bits(hard)
    corr = sync.best_correlation(bits)
    if k <= 0:
        return RealPairResult(bits, corr, count, best)
    from tetraear_tpu.models.multicarrier import extract_candidates
    valid_bits = jnp.maximum(count - 1, 0) * 2
    pos, ccorr, valid, frames, crc_ok = extract_candidates(
        bits, corr, valid_bits, k, threshold)
    return RealPairDecodeResult(bits, corr, count, best, pos, ccorr, valid,
                                frames, crc_ok)


class RealPairFrontend:
    """Grid-locked, transcendental/complex-free multicarrier frontend."""

    def __init__(self, config: ReceiverConfig | None = None,
                 spacing_hz: float = 25e3, num_candidates: int = 0,
                 threshold: float = 0.80):
        self.config = config or ReceiverConfig()
        self.spacing_hz = spacing_hz
        self.num_candidates = num_candidates
        self.threshold = threshold

    @functools.lru_cache(maxsize=8)
    def _compiled(self, n: int, c: int):
        cfg, k, thr = self.config, self.num_candidates, self.threshold
        if k <= 0:
            @jax.jit
            def run(x_ri, table):
                return _realpair_block(x_ri, table, cfg, 0, thr)
            return run

        # candidates stage as its own dispatched program (the monolithic
        # executable schedules ~2x slower on the remote backend — see
        # models/multicarrier._candidates_compiled)
        from tetraear_tpu.models.multicarrier import _candidates_compiled

        @jax.jit
        def front(x_ri, table):
            return _realpair_block(x_ri, table, cfg, 0, thr)

        cand = _candidates_compiled(k, thr)

        def run(x_ri, table):
            res = front(x_ri, table)
            pos, ccorr, valid, frames, crc_ok = cand(res.bits,
                                                     res.sync_corr,
                                                     res.count)
            return RealPairDecodeResult(res.bits, res.sync_corr,
                                        res.count, res.best_phase, pos,
                                        ccorr, valid, frames, crc_ok)
        return run

    def __call__(self, x, offsets_hz) -> RealPairResult:
        offsets = np.asarray(offsets_hz, np.float32)
        table = jnp.asarray(mixer_table(offsets, self.config.sample_rate_hz,
                                        self.spacing_hz))
        x = np.asarray(x)
        if np.iscomplexobj(x):
            x_ri = jnp.asarray(np.stack([x.real, x.imag]).astype(np.float32))
        else:
            x_ri = jnp.asarray(x, jnp.float32)
        fn = self._compiled(x_ri.shape[-1], len(offsets))
        return fn(x_ri, table)

    def __hash__(self):
        return hash((self.config, self.spacing_hz, self.num_candidates,
                     self.threshold))

    def __eq__(self, other):
        return (isinstance(other, RealPairFrontend)
                and (self.config, self.spacing_hz, self.num_candidates,
                     self.threshold)
                == (other.config, other.spacing_hz, other.num_candidates,
                    other.threshold))


class RealPairPfbFrontend:
    """Complex-free full-band channelizer+demod: the PFB analogue of
    models/multicarrier.PfbMulticarrierFrontend in the restricted op
    vocabulary (ops/pfb.pfb_channelize_realpair: IDFT as two real (C, C)
    matmuls).  All fs/25kHz channels (96 at 2.4 MS/s), demod/sync[/
    candidates+CRC] — executable on backends without complex arithmetic."""

    def __init__(self, config: ReceiverConfig | None = None,
                 num_candidates: int = 0, threshold: float = 0.80,
                 taps_per_branch: int = 8):
        self.config = config or ReceiverConfig()
        self.num_candidates = num_candidates
        self.threshold = threshold
        self.taps_per_branch = taps_per_branch
        fs = self.config.sample_rate_hz
        self.num_channels = int(round(fs / 25e3))
        self.decim = self.config.decimation_factor

    def channel_offsets_hz(self) -> np.ndarray:
        from tetraear_tpu.ops import pfb
        return pfb.channel_offsets_hz(self.num_channels,
                                      self.config.sample_rate_hz)

    @functools.lru_cache(maxsize=4)
    def _compiled(self, n: int):
        cfg, k, thr = self.config, self.num_candidates, self.threshold
        num_channels, decim, tpb = (self.num_channels, self.decim,
                                    self.taps_per_branch)

        @jax.jit
        def run(x_ri):
            from tetraear_tpu.ops import pfb
            taps = pfb.design_prototype(num_channels, tpb)
            y = pfb.pfb_channelize_realpair(x_ri, num_channels, decim, taps)
            return _demod_from_pair(y[0], y[1], cfg.ref_samples_per_symbol,
                                    k, thr)
        return run

    def __call__(self, x):
        x = np.asarray(x)
        if np.iscomplexobj(x):
            x_ri = jnp.asarray(np.stack([x.real, x.imag]).astype(np.float32))
        else:
            x_ri = jnp.asarray(x, jnp.float32)
        return self._compiled(x_ri.shape[-1])(x_ri)

    def __hash__(self):
        return hash((self.config, self.num_candidates, self.threshold,
                     self.taps_per_branch))

    def __eq__(self, other):
        return (isinstance(other, RealPairPfbFrontend)
                and (self.config, self.num_candidates, self.threshold,
                     self.taps_per_branch)
                == (other.config, other.num_candidates, other.threshold,
                    other.taps_per_branch))
