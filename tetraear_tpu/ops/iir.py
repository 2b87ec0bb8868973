"""Scan-based IIR filtering for the `ref-exact` profile.

Reproduces scipy.signal filtfilt/decimate semantics (odd-extension padding,
``lfilter_zi``-style initial conditions) as ``lax.scan`` programs so the
bit-faithful reference chain (processor.py:254 decimate-filtfilt, :264
butter-filtfilt) can run under jit.

High-order IIRs (cheby1 order 8) are numerically unstable in float32 direct
form, so filters run as cascaded second-order sections (biquads) — stable in
f32 and equivalent to scipy's float64 transfer-function form to working
precision.  Sequential by nature; used for conformance validation, not the
production fast path (see ops/fir.py).
"""

from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp
from jax import lax


# ---------------------------------------------------------------------------
# Transfer-function lfilter (general utility; fine for low orders)
# ---------------------------------------------------------------------------

def lfilter(b: np.ndarray, a: np.ndarray, x: jnp.ndarray,
            zi: jnp.ndarray | None = None) -> jnp.ndarray:
    """Direct-form-II-transposed IIR filter along the last axis.

    Matches scipy.signal.lfilter.  NOTE: high-order narrowband designs are
    unstable in f32 — use :func:`sosfilt` for order > 4.
    """
    b = np.asarray(b, dtype=np.float64)
    a = np.asarray(a, dtype=np.float64)
    b = b / a[0]
    a = a / a[0]
    n = max(len(a), len(b))
    bp = np.zeros(n); bp[:len(b)] = b
    ap = np.zeros(n); ap[:len(a)] = a
    dt = x.real.dtype if jnp.iscomplexobj(x) else x.dtype
    bj = jnp.asarray(bp, dtype=dt)
    aj = jnp.asarray(ap, dtype=dt)

    batch_shape = x.shape[:-1]
    xf = x.reshape((-1, x.shape[-1]))
    if zi is None:
        z0 = jnp.zeros((xf.shape[0], n - 1), dtype=x.dtype)
    else:
        z0 = jnp.broadcast_to(zi, (xf.shape[0], n - 1)).astype(x.dtype)

    def step(z, xt):
        y = bj[0] * xt + z[:, 0]
        znew = jnp.concatenate(
            [z[:, 1:], jnp.zeros((z.shape[0], 1), dtype=z.dtype)], axis=1)
        znew = znew + bj[1:][None, :] * xt[:, None] - aj[1:][None, :] * y[:, None]
        return znew, y

    _, ys = lax.scan(step, z0, xf.T)
    return ys.T.reshape(batch_shape + (x.shape[-1],))


# ---------------------------------------------------------------------------
# Second-order sections
# ---------------------------------------------------------------------------

# Recurrence steps per loop iteration of the biquad scans: the same
# arithmetic in the same order, in 1/SCAN_UNROLL as many device loop
# iterations (each iteration of a device loop costs a launch).
SCAN_UNROLL = 16


def _biquad(sec: np.ndarray, x: jnp.ndarray, zi: jnp.ndarray) -> jnp.ndarray:
    """One DF2-transposed biquad over the last axis.

    sec: (6,) [b0 b1 b2 1 a1 a2]; x: (B, N); zi: (B, 2).
    """
    b0, b1, b2, _, a1, a2 = [float(v) for v in sec]

    def step(z, xt):
        y = b0 * xt + z[:, 0]
        z0n = b1 * xt + z[:, 1] - a1 * y
        z1n = b2 * xt - a2 * y
        return jnp.stack([z0n, z1n], axis=1), y

    _, ys = lax.scan(step, zi, x.T, unroll=SCAN_UNROLL)
    return ys.T


def sosfilt(sos: np.ndarray, x: jnp.ndarray,
            zi: jnp.ndarray | None = None) -> jnp.ndarray:
    """Cascaded-biquad filter along the last axis (scipy.signal.sosfilt).

    sos: (S, 6) host-side array; zi: optional (S, 2) per-section initial
    conditions, broadcast over batch.
    """
    batch_shape = x.shape[:-1]
    y = x.reshape((-1, x.shape[-1]))
    for s in range(sos.shape[0]):
        if zi is None:
            z0 = jnp.zeros((y.shape[0], 2), dtype=y.dtype)
        else:
            z0 = jnp.broadcast_to(zi[s], (y.shape[0], 2)).astype(y.dtype)
        y = _biquad(sos[s], y, z0)
    return y.reshape(batch_shape + (x.shape[-1],))


@functools.lru_cache(maxsize=None)
def _tf2sos_zi(b: tuple, a: tuple) -> tuple[np.ndarray, np.ndarray]:
    from scipy.signal import tf2sos, sosfilt_zi
    sos = tf2sos(np.asarray(b), np.asarray(a))
    return sos, sosfilt_zi(sos)


def filtfilt(b: np.ndarray, a: np.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Zero-phase forward-backward filter matching scipy.signal.filtfilt
    defaults (padtype='odd', padlen=3*max(len(a),len(b))), computed as an
    SOS cascade for f32 stability.

    x: (..., N) real or complex; N must exceed padlen.
    """
    b = np.asarray(b, dtype=np.float64)
    a = np.asarray(a, dtype=np.float64)
    padlen = 3 * max(len(a), len(b))
    n = x.shape[-1]
    if n <= padlen:
        raise ValueError(f"input length {n} must exceed padlen {padlen}")

    sos, zi = _tf2sos_zi(tuple(b), tuple(a))
    # sosfilt with per-section zi scaled by the boundary sample needs the
    # scaling applied to each section's *input*; scipy sosfiltfilt scales all
    # sections by x[0] — replicate that.
    left = 2 * x[..., :1] - x[..., padlen:0:-1]
    right = 2 * x[..., -1:] - x[..., -2:-padlen - 2:-1]
    ext = jnp.concatenate([left, x, right], axis=-1)

    def _pass(sig):
        # scipy's sosfilt_zi rows are pre-scaled for the cascade: every
        # section's zi is multiplied by the *original* first sample.
        batch_shape = sig.shape[:-1]
        y = sig.reshape((-1, sig.shape[-1]))
        x0 = y[:, :1]
        for s in range(sos.shape[0]):
            z0 = jnp.asarray(zi[s]).astype(y.dtype)
            y = _biquad(sos[s], y, z0[None, :] * x0)
        return y.reshape(batch_shape + (sig.shape[-1],))

    y = _pass(ext)
    y = jnp.flip(y, axis=-1)
    y = _pass(y)
    y = jnp.flip(y, axis=-1)
    return y[..., padlen:padlen + n]


@functools.lru_cache(maxsize=None)
def decimate_coeffs(q: int) -> tuple[np.ndarray, np.ndarray]:
    """cheby1(8, 0.05, 0.8/q) — the IIR scipy.signal.decimate(zero_phase=True)
    applies via filtfilt (processor.py:254)."""
    from scipy.signal import cheby1
    b, a = cheby1(8, 0.05, 0.8 / q)
    return b, a


def decimate_exact(x: jnp.ndarray, q: int) -> jnp.ndarray:
    """scipy.signal.decimate(x, q) semantics: cheby1-8 filtfilt then take
    every q-th sample starting at index 0."""
    b, a = decimate_coeffs(q)
    y = filtfilt(b, a, x)
    return y[..., ::q]


@functools.lru_cache(maxsize=None)
def butter_coeffs(order: int, cutoff_norm: float) -> tuple[np.ndarray, np.ndarray]:
    from scipy.signal import butter
    return butter(order, cutoff_norm, btype="low")


def butter_filtfilt_exact(x: jnp.ndarray, cutoff_norm: float,
                          order: int = 4) -> jnp.ndarray:
    """butter(order, cutoff) + filtfilt — reference channel filter
    (processor.py:74-79) with the same [0.01, 0.99] cutoff clamp."""
    cutoff_norm = min(0.99, max(0.01, cutoff_norm))
    b, a = butter_coeffs(order, cutoff_norm)
    return filtfilt(b, a, x)
