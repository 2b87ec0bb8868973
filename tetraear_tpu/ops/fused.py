"""Fused multicarrier front-end: ONE dense multi-channel convolution
replaces the per-carrier mixer + decimation FIR + channel FIR cascade.

Derivation (all three stages are LTI per carrier, so they compose):

    staged:  x_c[n] = x[n] e^{-j2pi f_c n / fs}
             y1 = centered_decim_fir(x_c) downsampled by D     (taps_d, G1)
             y2[m] = sum_j taps_c[j] y1[m + G2 - j]            (taps_c, G2)

    fused:   h = taps_c upsampled by D, convolved with taps_d  (composite)
             K_c[u] = h[u] e^{+j2pi f_c u / fs}                (modulated)
             y2[m] = e^{-j2pi f_c (mD + Gc) / fs}
                     * sum_u K_c[u] x[mD + Gc - u],   Gc = G2*D + G1

The sum is one `lax.conv_general_dilated` with 2 input channels (re/im)
and 2C output channels — one dense implicit GEMM instead of the staged
C=1 convolutions.  Every conv here runs at HIGHEST precision (f32
operands; on a GPU no TF32).  The residual per-output
rotation runs at the decimated rate (10x cheaper than the full-rate
mixer it replaces).

Numerically this is the same linear operator as the cascade (LTI
composition), differing only in float summation order; equivalence with
the staged chain is pinned by tests/unit/test_fused_frontend.py at both
the sample level (allclose) and the decision level (identical frames).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from tetraear_tpu.ops import fir


@functools.lru_cache(maxsize=None)
def composite_taps(decim: int, taps_per_phase: int,
                   channel_taps: int, cutoff_norm: float) -> np.ndarray:
    """taps_d (*) upsample_D(taps_c): the single-rate composite filter."""
    taps_d = fir.design_decimation_fir(decim, taps_per_phase)
    taps_c = fir.design_channel_fir(channel_taps, cutoff_norm)
    up = np.zeros((len(taps_c) - 1) * decim + 1, np.float64)
    up[::decim] = taps_c
    return np.convolve(taps_d.astype(np.float64), up).astype(np.float32)


def modulated_kernel(taps: np.ndarray, offsets_hz: np.ndarray,
                     sample_rate_hz: float) -> tuple:
    """(2C, 2, L) real conv kernel K_c[u] = taps[u] e^{+j2pi f_c u / fs},
    reversed for conv_general_dilated's cross-correlation, with output
    channels BLOCK-ordered [re_0..re_{C-1}, im_0..im_{C-1}] so the
    consumers split the conv output with two contiguous slices
    (out[:C], out[C:]) instead of stride-2 slices — a free split vs a
    relayout of the full (2C, M) activation.

    Returns (kernel, rotation_cycles) with rotation_cycles[c] = f_c / fs
    (the residual per-output rotation the caller applies)."""
    h = np.asarray(taps, np.float64)
    L = len(h)
    offs = np.asarray(offsets_hz, np.float64)
    C = len(offs)
    u = np.arange(L, dtype=np.float64)
    ph = np.exp(2j * np.pi * offs[:, None] * u[None, :] / sample_rate_hz)
    Kc = (h[None, :] * ph)[:, ::-1]          # (C, L), reversed for corr
    kr = Kc.real.astype(np.float32)
    ki = Kc.imag.astype(np.float32)
    # complex multiply via real conv: out_re = x_re*Kr - x_im*Ki,
    #                                 out_im = x_re*Ki + x_im*Kr
    kernel = np.zeros((2 * C, 2, L), np.float32)
    kernel[:C, 0] = kr
    kernel[:C, 1] = -ki
    kernel[C:, 0] = ki
    kernel[C:, 1] = kr
    return jnp.asarray(kernel), offs / sample_rate_hz


def fused_kernel(offsets_hz: np.ndarray, sample_rate_hz: float,
                 decim: int, taps_per_phase: int, channel_taps: int,
                 cutoff_norm: float) -> tuple:
    """DDC-bank composite kernel: (kernel, group_delay, rotation_base)."""
    h = composite_taps(decim, taps_per_phase, channel_taps, cutoff_norm)
    g1 = (taps_per_phase * decim + 1 - 1) // 2
    g2 = (channel_taps | 1) // 2            # design pads to odd
    gc = g2 * decim + g1
    kernel, rot = modulated_kernel(h, offsets_hz, sample_rate_hz)
    return kernel, gc, rot


def ddc_kernel(offsets_hz: np.ndarray, sample_rate_hz: float,
               decim: int, taps_per_phase: int) -> tuple:
    """Mixer + decimation FIR only (no channel FIR) as one dense conv —
    the etsi profile's channelizer front (its channel selectivity comes
    from the RRC matched filter downstream).  Matches
    ops/channelizer.channelize output.  Returns (kernel, gc, rot)."""
    taps_d = fir.design_decimation_fir(decim, taps_per_phase)
    gc = (taps_per_phase * decim + 1 - 1) // 2
    kernel, rot = modulated_kernel(taps_d, offsets_hz, sample_rate_hz)
    return kernel, gc, rot


def pfb_kernel(num_channels: int, sample_rate_hz: float,
               taps: np.ndarray | None = None,
               taps_per_branch: int = 8) -> tuple:
    """Dense-conv equivalent of ops/pfb.pfb_channelize (same output:
    causal window ending at m*decim, group delay = prototype delay).

    The same math as the gather-based PFB, stated as ONE multi-channel
    conv:
    K_c[k] = h[k] e^{+j2pi c k / C}, rotation e^{-j2pi c mD / C}.
    Returns (kernel, gc=0, rotation_cycles)."""
    from tetraear_tpu.ops import pfb
    if taps is None:
        taps = pfb.design_prototype(num_channels, taps_per_branch)
    offs = pfb.channel_offsets_hz(num_channels, sample_rate_hz)
    kernel, rot = modulated_kernel(np.asarray(taps), offs, sample_rate_hz)
    return kernel, 0, rot


def symbol_rotation(rot_cycles: np.ndarray, decim: int, sps: int) -> tuple:
    """Per-carrier constant (cos, sin) of Delta_c = 2pi f_c D*sps / fs.

    The residual rotation e^{-j theta_m}, theta_m = 2pi f_c (s+Gc+mD)/fs,
    is invariant in |y|^2 (so symbol-timing phase power never needs it)
    and enters the differential product of symbols spaced exactly sps
    channel samples apart as the CONSTANT e^{-j Delta_c}: z' = z e^{-j
    (theta_k - theta_{k-1})} with theta_k - theta_{k-1} = 2pi f_c D sps/fs.
    So the demod path can skip the whole (C, M) channel-rate rotation
    stage and apply one (C,)-broadcast rotation to z at symbol rate —
    see fused_channelize(rotate=False) + the z_rot hooks in
    models/{multicarrier,realpair}."""
    d = np.asarray(rot_cycles, np.float64) * decim * sps
    d = 2.0 * np.pi * (d - np.round(d))
    return np.cos(d).astype(np.float32), np.sin(d).astype(np.float32)


def fused_channelize_ri(x: jnp.ndarray, kernel: jnp.ndarray, gc: int,
                        rot_cycles: np.ndarray, decim: int,
                        start_index=0, rotate: bool = True) -> tuple:
    """fused_channelize returning a (yr, yi) f32 pair instead of
    complex64 — same values, half the downstream memory traffic (the
    96-channel demod tail is HBM-bound on this backend).  Feed
    models/realpair._demod_from_pair for a decision-identical tail.

    rotate=False skips the residual per-sample rotation entirely (the
    conv+split only); pair with symbol_rotation() applied to z in the
    demod tail — decision-identical, minus ~4 full passes over the
    (C, M) activations."""
    n = x.shape[-1]
    m_out = -(-n // decim)
    xri = jnp.stack([jnp.real(x), jnp.imag(x)])[None]
    L = kernel.shape[-1]
    pad_l = L - 1 - gc
    pad_r = max(0, (m_out - 1) * decim + gc + 1 - n)
    out = lax.conv_general_dilated(
        xri, kernel, (decim,), ((pad_l, pad_r),),
        dimension_numbers=("NCW", "OIW", "NCW"),
        precision=lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32)[0]               # (2C, M)
    c = out.shape[0] // 2
    yr, yi = out[:c], out[c:]                                # (C, M)
    if not rotate:
        return yr, yi

    rot_cycles = np.asarray(rot_cycles, np.float64)
    q = _rotation_period(rot_cycles)
    m = jnp.arange(m_out, dtype=jnp.int32)
    if q:
        import math
        th = 2.0 * np.pi * rot_cycles[:, None] * np.arange(q)[None, :]
        cos_t = jnp.asarray(np.cos(th).astype(np.float32))
        sin_t = jnp.asarray(np.sin(th).astype(np.float32))
        p = q // math.gcd(decim % q or q, q)
        m0 = jnp.arange(p, dtype=jnp.int32)
        idx0 = (jnp.asarray(start_index, jnp.int32) + gc + m0 * decim) % q
        reps = -(-m_out // p)
        cr = jnp.tile(cos_t[:, idx0], (1, reps))[:, :m_out]
        si = jnp.tile(sin_t[:, idx0], (1, reps))[:, :m_out]
    else:
        arg = jnp.asarray(rot_cycles, jnp.float32)[:, None] * (
            jnp.asarray(start_index, jnp.float32) + gc
            + m[None, :].astype(jnp.float32) * decim)
        arg = 2.0 * jnp.pi * (arg - jnp.round(arg))
        cr, si = jnp.cos(arg), jnp.sin(arg)
    # (yr + j yi) * e^{-j theta} = (yr c + yi s) + j (yi c - yr s)
    return yr * cr + yi * si, yi * cr - yr * si


def s2d_kernel(kernel: jnp.ndarray, decim: int) -> jnp.ndarray:
    """Space-to-depth transform of a (2C, 2, L) composite kernel.

    The strided conv  out[c, m] = sum_t K[c, j, t] xpad[j, mD+t]  is,
    with t = aD + r, a stride-1 conv over W = Np/D positions with 2D
    input channels:  out[c, m] = sum_{(r,j), a} K2[c, (r,j), a]
    X2[(r,j), m+a], where X2 is xpad viewed as (W, D, 2) row-major —
    a FREE reshape of the (N, 2) re/im-interleaved input, no transpose
    or gather.  This moves the decimation out of the conv stride and
    into the channel dimension: the implicit GEMM contracts over
    2D*ceil(L/D) ≈ 2L input channels with a dense stride-1 window.
    Returns (2C, 2D, Lp) with input channel index r*2 + j."""
    k = np.asarray(kernel)
    c2, _, L = k.shape
    lp = -(-L // decim)
    kp = np.zeros((c2, 2, lp * decim), np.float32)
    kp[:, :, :L] = k
    k4 = kp.reshape(c2, 2, lp, decim)          # [c, j, a, r]
    return jnp.asarray(np.ascontiguousarray(
        k4.transpose(0, 3, 1, 2)).reshape(c2, 2 * decim, lp))


def s2d_of_kernel(kernel: jnp.ndarray, decim: int, fold: int) -> jnp.ndarray:
    """Output-folded space-to-depth kernel: (2C*fold, 2D, Lp+fold-1).

    The s2d conv's output-channel count is 2C — 32 for 16 carriers.
    Folding `fold` consecutive output positions into
    the channel dimension multiplies the output channels by `fold` at
    the cost of fold-1 extra (zero) taps per row:

        out[c, w*F + r] = sum_{i,a} K2[c,i,a] X2[i, w*F + r + a]
                        = (stride-F conv)[c*F + r, w]
        with K3[c*F+r, i, a2] = K2[c, i, a2-r]  (0 <= a2-r < Lp).

    The un-fold on the output side is one (2C, F, W) -> (2C, W, F)
    minor-axis transpose of the DECIMATED activation (cheap vs the conv).
    fold=4 with C=16 gives 128 output channels."""
    k2 = np.asarray(s2d_kernel(kernel, decim))
    c2, ich, lp = k2.shape
    k3 = np.zeros((c2, fold, ich, lp + fold - 1), np.float32)
    for r in range(fold):
        k3[:, r, :, r:r + lp] = k2
    return jnp.asarray(k3.reshape(c2 * fold, ich, lp + fold - 1))


def _s2d_conv_folded(x: jnp.ndarray, kernel_of: jnp.ndarray, gc: int,
                     L: int, decim: int, fold: int) -> jnp.ndarray:
    """Output-folded stride-`fold` variant of _s2d_conv: same (2C, m_out)
    result (summation order identical per output; the fold only changes
    which output channel computes it)."""
    n = x.shape[-1]
    m_out = -(-n // decim)
    la = kernel_of.shape[-1]
    pad_l = L - 1 - gc
    wr = -(-m_out // fold)
    need = (wr - 1) * fold + la               # X2 positions the conv reads
    total = max(need * decim, -(-(pad_l + n) // decim) * decim)
    xri = jnp.stack([jnp.real(x), jnp.imag(x)], axis=-1)      # (N, 2)
    xpad = jnp.pad(xri, ((pad_l, total - pad_l - n), (0, 0)))
    x2 = xpad.reshape(1, total // decim, 2 * decim)           # (1, W, 2D)
    out = lax.conv_general_dilated(
        x2, kernel_of, (fold,), ((0, 0),),
        dimension_numbers=("NWC", "OIW", "NCW"),
        precision=lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32)[0][:, :wr]        # (2C*F, Wr)
    c2 = out.shape[0] // fold
    out = out.reshape(c2, fold, wr).transpose(0, 2, 1).reshape(c2, wr * fold)
    return out[:, :m_out]


def fused_channelize_s2d_of_ri(x: jnp.ndarray, kernel_of: jnp.ndarray,
                               gc: int, L: int, decim: int,
                               fold: int) -> tuple:
    """(yr, yi) un-derotated pair via the output-folded s2d conv — same
    values as fused_channelize_s2d_ri (pair with symbol_rotation)."""
    out = _s2d_conv_folded(x, kernel_of, gc, L, decim, fold)
    c2 = out.shape[0] // 2
    return out[:c2], out[c2:]


def _s2d_conv(x: jnp.ndarray, kernel_s2d: jnp.ndarray, gc: int, L: int,
              decim: int) -> jnp.ndarray:
    """Space-to-depth stride-1 conv shared by the s2d variants.

    x: (N,) complex64 -> (2C, m_out) f32 un-derotated channel pair rows
    (block order [re.., im..]), numerically the same contraction as the
    stride-D conv in fused_channelize (summation order differs)."""
    n = x.shape[-1]
    m_out = -(-n // decim)
    lp = kernel_s2d.shape[-1]
    pad_l = L - 1 - gc
    # cover both the conv's read window and the left-padded input (for
    # short composite delays, e.g. the PFB's gc=0, pad_l + n can exceed
    # (m_out + lp - 1) * D); any surplus rows produce extra outputs that
    # are sliced off below
    total = max((m_out + lp - 1) * decim,
                -(-(pad_l + n) // decim) * decim)
    xri = jnp.stack([jnp.real(x), jnp.imag(x)], axis=-1)      # (N, 2)
    xpad = jnp.pad(xri, ((pad_l, total - pad_l - n), (0, 0)))
    x2 = xpad.reshape(1, total // decim, 2 * decim)           # (1, W, 2D)
    out = lax.conv_general_dilated(
        x2, kernel_s2d, (1,), ((0, 0),),
        dimension_numbers=("NWC", "OIW", "NCW"),
        precision=lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32)[0]                # (2C, >=m_out)
    return out[:, :m_out]


def fused_channelize_s2d(x: jnp.ndarray, kernel_s2d: jnp.ndarray, gc: int,
                         L: int, rot_cycles: np.ndarray, decim: int,
                         start_index=0, rotate: bool = True):
    """fused_channelize via the space-to-depth stride-1 conv: same
    operator, decimation folded into the channel dim (see s2d_kernel).
    `L` is the original composite length (pre-padding).  Returns
    complex (C, M); rotate=False skips the residual derotation
    (pair with symbol_rotation)."""
    out = _s2d_conv(x, kernel_s2d, gc, L, decim)
    c2 = out.shape[0] // 2
    y = lax.complex(out[:c2], out[c2:])
    if not rotate:
        return y
    n = x.shape[-1]
    m_out = -(-n // decim)
    rot_cycles = np.asarray(rot_cycles, np.float64)
    q = _rotation_period(rot_cycles)
    m = jnp.arange(m_out, dtype=jnp.int32)
    if q:
        import math
        ph = np.exp(-2j * np.pi * rot_cycles[:, None]
                    * np.arange(q)[None, :]).astype(np.complex64)
        p = q // math.gcd(decim % q or q, q)
        m0 = jnp.arange(p, dtype=jnp.int32)
        idx0 = (jnp.asarray(start_index, jnp.int32) + gc + m0 * decim) % q
        base = jnp.asarray(ph)[:, idx0]
        reps = -(-m_out // p)
        rot = jnp.tile(base, (1, reps))[:, :m_out]
    else:
        arg = jnp.asarray(rot_cycles, jnp.float32)[:, None] * (
            jnp.asarray(start_index, jnp.float32) + gc
            + m[None, :].astype(jnp.float32) * decim)
        rot = jnp.exp(-2j * jnp.pi * (arg - jnp.round(arg)))
    return (y * rot).astype(jnp.complex64)


def fused_channelize_s2d_ri(x: jnp.ndarray, kernel_s2d: jnp.ndarray,
                            gc: int, L: int, decim: int) -> tuple:
    """(yr, yi) un-derotated pair via the space-to-depth conv — the
    realpair-tail feed (pair with symbol_rotation for the z constant)."""
    out = _s2d_conv(x, kernel_s2d, gc, L, decim)
    c2 = out.shape[0] // 2
    return out[:c2], out[c2:]


def conv_reference(x: np.ndarray, kernel: np.ndarray, gc: int, decim: int,
                   m_count: int) -> np.ndarray:
    """Plain float64 NumPy evaluation of the composite conv: the first
    ``m_count`` outputs of fused_channelize_ri(rotate=False) stacked as
    (2C, m_count) rows [re.., im..] — the reference every conv
    formulation (strided, s2d, s2d_of, a hand-written kernel) is held
    to."""
    k = np.asarray(kernel, np.float64)
    L = k.shape[-1]
    pad_l = L - 1 - gc
    need = (m_count - 1) * decim + L
    xri = np.zeros((2, pad_l + max(len(x), need)), np.float64)
    xri[0, pad_l:pad_l + len(x)] = np.real(x)
    xri[1, pad_l:pad_l + len(x)] = np.imag(x)
    win = np.lib.stride_tricks.sliding_window_view(
        xri[:, :need], L, axis=-1)[:, ::decim][:, :m_count]   # (2, M, L)
    return np.einsum("cjl,jml->cm", k, win)


def _rotation_period(rot_cycles: np.ndarray, max_q: int = 4608) -> int:
    """Smallest Q with every f_c*Q/fs an integer (0 if none <= max_q).

    For the TETRA 25 kHz grid at 2.4 MS/s this is 96: the residual
    rotation is then an exact function of (start + Gc + m*D) mod Q."""
    for q in range(1, max_q + 1):
        if np.allclose(rot_cycles * q, np.round(rot_cycles * q),
                       atol=1e-12):
            return q
    return 0


def fused_channelize(x: jnp.ndarray, kernel: jnp.ndarray, gc: int,
                     rot_cycles: np.ndarray, decim: int,
                     start_index=0, rotate: bool = True) -> jnp.ndarray:
    """x: (N,) complex64 -> (C, ceil(N/decim)) complex64 baseband carriers.

    Matches ops/channelizer.channelize + ops/fir.fir_filter_same output
    (same grid, same group-delay alignment); `start_index` keeps mixer
    phase continuous across blocks, as the staged path does.

    rotate=False returns the un-derotated channels (conv only); demod
    consumers apply symbol_rotation() to z instead — see
    fused_channelize_ri.
    """
    n = x.shape[-1]
    m_out = -(-n // decim)                                   # ceil(N/D)
    xri = jnp.stack([jnp.real(x), jnp.imag(x)])[None]       # (1, 2, N)
    L = kernel.shape[-1]
    # output m reads x[mD + gc - u]; the corr form needs left pad
    # L-1-gc, and right pad sized so the output length is exactly m_out
    pad_l = L - 1 - gc
    pad_r = max(0, (m_out - 1) * decim + gc + 1 - n)
    out = lax.conv_general_dilated(
        xri, kernel, (decim,), ((pad_l, pad_r),),
        dimension_numbers=("NCW", "OIW", "NCW"),
        precision=lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32)[0]               # (2C, M)
    c2 = out.shape[0] // 2
    y = lax.complex(out[:c2], out[c2:])                      # (C, M)
    if not rotate:
        return y

    # residual rotation e^{-j2pi f (s + mD + Gc) / fs} at the LOW rate.
    rot_cycles = np.asarray(rot_cycles, np.float64)
    q = _rotation_period(rot_cycles)
    m = jnp.arange(m_out, dtype=jnp.int32)
    if q:
        # exact path (grid-aligned carriers): (C, Q) host-built table —
        # no accumulating f32 error however long the block.  The phase
        # index (s + Gc + mD) mod Q repeats every p = Q/gcd(D, Q) output
        # samples, so gather one tiny period and tile (no gather over
        # the full activation)
        import math
        ph = np.exp(-2j * np.pi * rot_cycles[:, None]
                    * np.arange(q)[None, :]).astype(np.complex64)
        p = q // math.gcd(decim % q or q, q)
        m0 = jnp.arange(p, dtype=jnp.int32)
        idx0 = (jnp.asarray(start_index, jnp.int32) + gc
                + m0 * decim) % q
        base = jnp.asarray(ph)[:, idx0]                      # (C, p)
        reps = -(-m_out // p)
        rot = jnp.tile(base, (1, reps))[:, :m_out]           # (C, M)
    else:
        # general offsets: f32 direct, same precision class as the
        # staged full-rate mixer it replaces
        arg = jnp.asarray(rot_cycles, jnp.float32)[:, None] * (
            jnp.asarray(start_index, jnp.float32) + gc
            + m[None, :].astype(jnp.float32) * decim)
        rot = jnp.exp(-2j * jnp.pi * (arg - jnp.round(arg)))
    return (y * rot).astype(jnp.complex64)
