"""Polyphase rational resampling (L/M) as strided convolutions.

Used by the `etsi` profile to reach an exact integer samples-per-symbol
grid: 2.4 MS/s -> decimate by 10 -> 240 kHz -> (x3/10) -> 72 kHz
= 4 x 18000 symbols/s.  The reference instead truncates 240000/18000 to 13
samples/symbol (processor.py:183) and slips one symbol every ~40 — the
root cause of its frame-level fragility (SURVEY.md §6).

upfirdn semantics with zero-phase alignment:

    y[m] = sum_k h[k] * xu[m*M + delay - k],   delay = (len(h)-1)//2
    xu[i] = x[i/L] if i % L == 0 else 0

decomposed per output phase q = m mod L into L plain strided convolutions
(kernel g_q[j] = h[k0(q) + L*j]) — no zero-stuffed buffers.
Matches scipy.signal.resample_poly(x, L, M, window=h) on the interior.
"""

from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp
from jax import lax


@functools.lru_cache(maxsize=None)
def _phase_plan(num_taps: int, L: int, M: int):
    """Per-phase (kernel, base_offset) for the polyphase decomposition."""
    delay = (num_taps - 1) // 2
    plans = []
    for q in range(L):
        k0 = (q * M + delay) % L
        g = np.arange(k0, num_taps, L)          # tap indices of this phase
        b_q = (q * M + delay - k0) // L         # input offset for i == 0
        plans.append((g, b_q))
    return plans, delay


def rational_resample(x: jnp.ndarray, L: int, M: int,
                      taps: np.ndarray) -> jnp.ndarray:
    """x: (..., N) complex/real -> (..., L*floor(N*L/M/L)) resampled."""
    assert np.gcd(L, M) == 1
    taps = np.asarray(taps, np.float64)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None, :]
    n = x.shape[-1]
    num_out = (n * L) // M
    blocks = num_out // L                        # outputs per phase
    plans, _ = _phase_plan(len(taps), L, M)

    is_complex = jnp.iscomplexobj(x)
    phase_outs = []
    for q, (tap_idx, b_q) in enumerate(plans):
        g = taps[tap_idx]
        J = len(g)
        # y_q[i] = sum_j g[j] * x[i*M + b_q - j]
        #        = corr(x, g[::-1]) evaluated at position i*M + b_q - (J-1)
        start = b_q - (J - 1)
        pad_l = max(0, -start)
        pad_r = (blocks - 1) * M + b_q + 1 + pad_l - n + 8
        pad_r = max(0, pad_r)
        xp = jnp.pad(x, ((0, 0),) * (x.ndim - 1) + ((pad_l, pad_r),))
        seg = xp[..., start + pad_l:]
        kern = jnp.asarray(g[::-1], jnp.float32)
        if is_complex:
            re = _strided_corr(jnp.real(seg), kern, M, blocks)
            im = _strided_corr(jnp.imag(seg), kern, M, blocks)
            phase_outs.append((re + 1j * im).astype(jnp.complex64))
        else:
            phase_outs.append(_strided_corr(seg.astype(jnp.float32),
                                            kern, M, blocks))
    y = jnp.stack(phase_outs, axis=-1)           # (..., blocks, L)
    y = y.reshape(x.shape[:-1] + (blocks * L,))
    return y[0] if squeeze else y


def _strided_corr(x: jnp.ndarray, kern: jnp.ndarray, stride: int,
                  num_out: int) -> jnp.ndarray:
    width = kern.shape[0]
    need = (num_out - 1) * stride + width
    if x.shape[-1] < need:
        x = jnp.pad(x, ((0, 0),) * (x.ndim - 1) + ((0, need - x.shape[-1]),))
    x = x[..., :need]
    lhs = x.reshape((-1, 1, need))
    rhs = kern[None, None, :]
    out = lax.conv_general_dilated(
        lhs, rhs, window_strides=(stride,), padding=((0, 0),),
        dimension_numbers=("NCW", "OIW", "NCW"),
        precision=lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32)
    return out[:, 0, :].reshape(x.shape[:-1] + (num_out,))


@functools.lru_cache(maxsize=None)
def design_rrc_resampler(L: int, M: int, sps_out: int, alpha: float = 0.35,
                         span_symbols: int = 10) -> np.ndarray:
    """Combined anti-alias + RRC matched filter at the virtual L*fs_in rate.

    One symbol spans sps_out * M virtual samples; gain L per upfirdn
    convention."""
    from tetraear_tpu.ops.fir import design_rrc
    virtual_sps = sps_out * M
    taps = design_rrc(virtual_sps, alpha, span_symbols).astype(np.float64)
    return taps * L
