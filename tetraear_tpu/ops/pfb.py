"""Polyphase DFT-filterbank channelizer: all fs/spacing channels at once.

Technique per the retrieved channelization literature (PAPERS.md: GPU/
many-core polyphase filterbanks): one prototype lowpass + a C-point (I)FFT
replaces C independent mixer+FIR chains.  For the TETRA grid (fs = 2.4 MHz,
25 kHz spacing -> C = 96 channels) with decimation D = 10 the filterbank
delivers ALL 96 carriers at 240 kHz each for roughly half the FLOPs of a
16-carrier DDC bank (ops/channelizer.py), as one FFT/matmul structure.

Math (channel c centered at +c*fs/C, fftfreq channel order):

    y_c[m] = sum_k h[k] x[mD - k] e^{-j 2 pi c (mD - k) / C}
           = e^{-j 2 pi c mD / C} * C * IDFT_r->c{ f[m, r] }
    f[m, r] = sum_p h[pC + r] x[mD - pC - r]

so per output step: gather the length-P*C reversed window ending at mD,
multiply the prototype, fold (sum over p), IFFT across the fold, apply the
oversampling phase rotation (period C / gcd(C, D) in m).

Window gathers are chunked over the output axis to bound the (chunk, P*C)
materialization; everything else is dense batched math.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax


@functools.lru_cache(maxsize=None)
def design_prototype(num_channels: int, taps_per_branch: int = 8,
                     cutoff_scale: float = 1.0) -> np.ndarray:
    """Lowpass prototype of length C*P with cutoff at half the channel
    spacing (scaled by cutoff_scale)."""
    from scipy.signal import firwin
    n = num_channels * taps_per_branch
    taps = firwin(n, cutoff_scale / num_channels)
    return taps.astype(np.float64)


def channel_offsets_hz(num_channels: int, sample_rate_hz: float) -> np.ndarray:
    """Center frequency of each filterbank channel (fftfreq order)."""
    return (np.fft.fftfreq(num_channels) * sample_rate_hz).astype(np.float32)


def pfb_channelize(x: jnp.ndarray, num_channels: int, decim: int,
                   taps: np.ndarray | None = None,
                   chunk: int = 8192) -> jnp.ndarray:
    """x: (N,) complex64 -> (C, M) complex64 with M = N // decim.

    Output sample m of channel c is the channel-c baseband at input position
    m*decim (causal window ending there; group delay = prototype delay).
    """
    if taps is None:
        taps = design_prototype(num_channels)
    taps = np.asarray(taps, np.float64)
    pc = len(taps)
    assert pc % num_channels == 0
    p = pc // num_channels

    n = x.shape[-1]
    m_total = n // decim
    h = jnp.asarray(taps, jnp.float32)

    # oversampling rotation: e^{-j 2 pi c m D / C}, periodic in m
    period = num_channels // math.gcd(num_channels, decim)
    mm = np.arange(period)
    cc = np.arange(num_channels)
    rot = np.exp(-2j * np.pi * np.outer(mm, cc) * decim / num_channels)
    rot_j = jnp.asarray(rot.astype(np.complex64))          # (period, C)

    # left-pad so the first windows (mD - j < 0) read zeros
    xp = jnp.pad(x, (pc, 0))

    num_chunks = -(-m_total // chunk)
    m_pad = num_chunks * chunk

    def do_chunk(start):
        m_idx = start + jnp.arange(chunk)                  # output indices
        # window w[m, j] = x[mD - j], j in [0, PC) -> padded index mD - j + PC
        gather = (m_idx[:, None] * decim - jnp.arange(pc)[None, :] + pc)
        gather = jnp.clip(gather, 0, xp.shape[0] - 1)
        w = xp[gather]                                     # (chunk, PC)
        fw = w * h[None, :]
        folded = fw.reshape(chunk, p, num_channels).sum(axis=1)
        y = jnp.fft.ifft(folded, axis=-1) * num_channels   # (chunk, C)
        y = y * rot_j[m_idx % period]
        return y.astype(jnp.complex64)

    starts = jnp.arange(num_chunks) * chunk
    ys = jax.lax.map(do_chunk, starts)                     # (num_chunks, chunk, C)
    y = ys.reshape(m_pad, num_channels)[:m_total]
    return jnp.transpose(y)                                # (C, M)


@functools.lru_cache(maxsize=None)
def _idft_tables(num_channels: int) -> tuple:
    """Real/imag parts of the C-point IDFT matrix W[r,c]=e^{+j2pi rc/C}."""
    r = np.arange(num_channels)
    th = 2.0 * np.pi * np.outer(r, r) / num_channels
    return (np.cos(th).astype(np.float32), np.sin(th).astype(np.float32))


_mm = functools.partial(jnp.matmul, precision=lax.Precision.HIGHEST)


def pfb_channelize_realpair(x_ri: jnp.ndarray, num_channels: int,
                            decim: int, taps: np.ndarray | None = None,
                            chunk: int = 8192) -> jnp.ndarray:
    """Complex-free pfb_channelize: x_ri (2, N) f32 -> (2, C, M) f32.

    Same math as :func:`pfb_channelize`, with the C-point IFFT expressed as
    two real (C, C) matmuls (IDFT matrix, host-precomputed) and the
    oversampling rotation as real cos/sin tables (no complex arithmetic,
    models/realpair.py).  For C = 96 the (chunk, C) @ (C, C) products
    dominate; they run at HIGHEST precision.
    """
    if taps is None:
        taps = design_prototype(num_channels)
    taps = np.asarray(taps, np.float64)
    pc = len(taps)
    assert pc % num_channels == 0
    p = pc // num_channels

    n = x_ri.shape[-1]
    m_total = n // decim
    h = jnp.asarray(taps, jnp.float32)

    cos_w, sin_w = _idft_tables(num_channels)
    cos_j = jnp.asarray(cos_w)
    sin_j = jnp.asarray(sin_w)

    period = num_channels // math.gcd(num_channels, decim)
    mm = np.arange(period)
    cc = np.arange(num_channels)
    th = 2.0 * np.pi * np.outer(mm, cc) * decim / num_channels
    rot_r = jnp.asarray(np.cos(th).astype(np.float32))     # (period, C)
    rot_i = jnp.asarray((-np.sin(th)).astype(np.float32))

    xp = jnp.pad(x_ri, ((0, 0), (pc, 0)))                  # (2, N+PC)

    num_chunks = -(-m_total // chunk)
    m_pad = num_chunks * chunk

    def do_chunk(start):
        m_idx = start + jnp.arange(chunk)
        gather = (m_idx[:, None] * decim - jnp.arange(pc)[None, :] + pc)
        gather = jnp.clip(gather, 0, xp.shape[-1] - 1)
        w = xp[:, gather] * h[None, None, :]               # (2, chunk, PC)
        folded = w.reshape(2, chunk, p, num_channels).sum(axis=2)
        fr, fi = folded[0], folded[1]                      # (chunk, C)
        # IDFT (times C): Y = folded @ W with W = cos + j sin
        yr = _mm(fr, cos_j) - _mm(fi, sin_j)
        yi = _mm(fr, sin_j) + _mm(fi, cos_j)
        # oversampling rotation
        rr = rot_r[m_idx % period]
        ri = rot_i[m_idx % period]
        return jnp.stack([yr * rr - yi * ri, yr * ri + yi * rr])

    starts = jnp.arange(num_chunks) * chunk
    ys = jax.lax.map(do_chunk, starts)                 # (nc, 2, chunk, C)
    y = jnp.transpose(ys, (1, 0, 2, 3)).reshape(2, m_pad, num_channels)
    return jnp.transpose(y[:, :m_total], (0, 2, 1))        # (2, C, M)
