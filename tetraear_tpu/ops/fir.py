"""FIR design and polyphase/strided convolution.

Filter *design* happens on host at trace time with scipy (static, cached);
filter *application* is a strided `lax.conv_general_dilated` (an implicit
GEMM on the device), pinned to HIGHEST precision.

The `ref-compat` profile replaces the reference's zero-phase IIR stages
(scipy.signal.decimate's cheby1-8 filtfilt, processor.py:254; butter-4
filtfilt, processor.py:78-79) with symmetric (exactly linear-phase) FIRs whose
magnitude matches the IIR's *squared* magnitude (filtfilt applies |H|^2 with
zero phase).  After integer group-delay compensation both stages are
zero-phase on the block interior, so downstream phase-difference decisions
agree with the reference away from block edges.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax


# ---------------------------------------------------------------------------
# Design (host, cached)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def design_decimation_fir(decim: int, taps_per_phase: int = 16) -> np.ndarray:
    """Linear-phase FIR matching |cheby1(8, 0.05, 0.8/decim)|^2.

    scipy.signal.decimate(x, q) uses cheby1(8, 0.05, 0.8/q) + filtfilt
    (processor.py:254).  We sample the squared magnitude of that IIR on a
    dense grid and fit a type-I FIR with firwin2.
    """
    from scipy import signal as sps

    numtaps = taps_per_phase * decim + 1   # odd -> integer group delay
    b, a = sps.cheby1(8, 0.05, 0.8 / decim)
    freqs = np.linspace(0.0, 1.0, 512)
    _, h = sps.freqz(b, a, worN=freqs * np.pi)
    gain = np.abs(h) ** 2                  # filtfilt applies |H|^2
    gain[-1] = 0.0
    taps = sps.firwin2(numtaps, freqs, gain)
    return taps.astype(np.float32)


@functools.lru_cache(maxsize=None)
def design_channel_fir(num_taps: int, cutoff_norm: float) -> np.ndarray:
    """Linear-phase FIR matching |butter(4, cutoff)|^2 (processor.py:78-79).

    ``cutoff_norm`` is the cutoff as a fraction of Nyquist, exactly as the
    reference computes it: (bandwidth/2) / (fs/2), clipped to [0.01, 0.99].
    """
    from scipy import signal as sps

    if num_taps % 2 == 0:
        num_taps += 1
    cutoff_norm = min(0.99, max(0.01, cutoff_norm))
    b, a = sps.butter(4, cutoff_norm, btype="low")
    freqs = np.linspace(0.0, 1.0, 512)
    _, h = sps.freqz(b, a, worN=freqs * np.pi)
    gain = np.abs(h) ** 2
    gain[-1] = 0.0
    taps = sps.firwin2(num_taps, freqs, gain)
    return taps.astype(np.float32)


@functools.lru_cache(maxsize=None)
def design_rrc(sps_: int, alpha: float, span_symbols: int) -> np.ndarray:
    """Root-raised-cosine matched filter for the `etsi` profile (alpha=0.35
    per ETSI EN 300 392-2 modulation filter)."""
    n = sps_ * span_symbols + 1
    t = (np.arange(n) - (n - 1) / 2) / sps_
    taps = np.zeros_like(t)
    for i, ti in enumerate(t):
        if abs(ti) < 1e-9:
            taps[i] = 1.0 - alpha + 4 * alpha / np.pi
        elif abs(abs(4 * alpha * ti) - 1.0) < 1e-9:
            taps[i] = (alpha / np.sqrt(2)) * (
                (1 + 2 / np.pi) * np.sin(np.pi / (4 * alpha))
                + (1 - 2 / np.pi) * np.cos(np.pi / (4 * alpha)))
        else:
            num = (np.sin(np.pi * ti * (1 - alpha))
                   + 4 * alpha * ti * np.cos(np.pi * ti * (1 + alpha)))
            den = np.pi * ti * (1 - (4 * alpha * ti) ** 2)
            taps[i] = num / den
    taps /= np.sqrt(np.sum(taps ** 2))
    return taps.astype(np.float32)


# ---------------------------------------------------------------------------
# Application (device)
# ---------------------------------------------------------------------------

def _conv1d_real(x: jnp.ndarray, taps: jnp.ndarray, stride: int,
                 pad: tuple[int, int]) -> jnp.ndarray:
    """Strided 1-D cross-correlation of real batched signals.

    x: (B, N) float32; taps: (L,) float32 -> (B, M).
    """
    lhs = x[:, None, :]                     # NCW
    rhs = taps[None, None, :]               # OIW
    out = lax.conv_general_dilated(
        lhs, rhs,
        window_strides=(stride,),
        padding=(pad,),
        dimension_numbers=("NCW", "OIW", "NCW"),
        precision=lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )
    return out[:, 0, :]


def fir_decimate(x: jnp.ndarray, taps: jnp.ndarray, decim: int) -> jnp.ndarray:
    """Zero-phase FIR filter + decimate, matching scipy's output grid.

    For odd, symmetric ``taps`` of length L = 2G+1, computes
    ``y[m] = sum_k taps[k] * x[m*decim + G - k]`` with zero padding, i.e. the
    centered 'same' filter sampled on the [0, decim, 2*decim, ...] grid —
    the grid scipy.signal.decimate returns (y[::q] starting at 0).

    x: complex64 (B, N) or (N,) -> complex64 (B, ceil(N/decim)).
    """
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None, :]
    G = (taps.shape[0] - 1) // 2
    re = _conv1d_real(jnp.real(x), taps, decim, (G, G))
    im = _conv1d_real(jnp.imag(x), taps, decim, (G, G))
    y = (re + 1j * im).astype(jnp.complex64)
    return y[0] if squeeze else y


def fir_filter_same(x: jnp.ndarray, taps: jnp.ndarray) -> jnp.ndarray:
    """Zero-phase 'same' FIR filter (stride 1)."""
    return fir_decimate(x, taps, 1)


def fir_decimate_halo(x: jnp.ndarray, taps: jnp.ndarray, decim: int,
                      left_halo: jnp.ndarray, right_halo: jnp.ndarray
                      ) -> jnp.ndarray:
    """Overlap-save variant: neighbours supply G samples of real signal on
    each side instead of zero padding, so sharded == unsharded on the
    interior.  Halos must each have length G = (len(taps)-1)//2 and the local
    block length must be a multiple of ``decim``."""
    G = (taps.shape[0] - 1) // 2
    xp = jnp.concatenate([left_halo, x, right_halo], axis=-1)
    squeeze = xp.ndim == 1
    if squeeze:
        xp = xp[None, :]
    re = _conv1d_real(jnp.real(xp), taps, decim, (0, 0))
    im = _conv1d_real(jnp.imag(xp), taps, decim, (0, 0))
    y = (re + 1j * im).astype(jnp.complex64)
    return y[0] if squeeze else y
