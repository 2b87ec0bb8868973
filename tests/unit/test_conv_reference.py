"""Every channelizer conv formulation against the plain float64 NumPy
reference ops/fused.conv_reference: the strided conv, the space-to-depth
conv (s2d) and its output-folded form (s2d_of), at 1, 4 and 16 carriers,
with ragged lengths, and the 192-row PFB kernel."""

import numpy as np
import pytest

import jax.numpy as jnp

from tetraear_tpu.config import ReceiverConfig
from tetraear_tpu.ops import fused

CFG = ReceiverConfig()
D = CFG.decimation_factor
# f32 sums of ~1,500 products against float64: 2e-5 of the mean output
# magnitude bounds the accumulated rounding with margin
TOL = 2e-5


def _noise(seed: int, n: int) -> np.ndarray:
    a = np.random.default_rng(seed).standard_normal((2, n)) * 0.3
    return (a[0] + 1j * a[1]).astype(np.complex64)


def _ddc_kernel(c: int):
    cutoff = (CFG.channel_bandwidth_hz / 2) / (CFG.intermediate_rate_hz / 2)
    offs = (np.arange(c) - (c - 1) / 2) * 25e3 + 310.0   # off-grid too
    k, gc, _ = fused.fused_kernel(offs, CFG.sample_rate_hz, D,
                                  CFG.decim_fir_taps_per_phase,
                                  CFG.channel_fir_taps, cutoff)
    return np.asarray(k), gc


def _rows(form: str, x, k, gc):
    L = k.shape[-1]
    xj = jnp.asarray(x)
    if form == "strided":
        yr, yi = fused.fused_channelize_ri(xj, jnp.asarray(k), gc,
                                           np.zeros(k.shape[0] // 2), D,
                                           rotate=False)
        return np.concatenate([np.asarray(yr), np.asarray(yi)])
    if form == "s2d":
        return np.asarray(fused._s2d_conv(xj, fused.s2d_kernel(k, D), gc,
                                          L, D))
    fold = int(form.removeprefix("s2d_of"))
    return np.asarray(fused._s2d_conv_folded(
        xj, fused.s2d_of_kernel(k, D, fold), gc, L, D, fold))


def _check(form, x, k, gc):
    got = _rows(form, x, k, gc)
    m_out = -(-len(x) // D)
    assert got.shape == (k.shape[0], m_out)
    ref = fused.conv_reference(x, k, gc, D, m_out)
    err = np.abs(got - ref).max() / np.abs(ref).mean()
    assert err < TOL, err


@pytest.mark.parametrize("n", [20_000, 20_007])
@pytest.mark.parametrize("carriers", [1, 4, 16])
@pytest.mark.parametrize("form", ["strided", "s2d", "s2d_of2", "s2d_of4"])
def test_ddc_conv_matches_float64(form, carriers, n):
    x = _noise(carriers * 7 + n, n)
    k, gc = _ddc_kernel(carriers)
    _check(form, x, k, gc)


@pytest.mark.parametrize("n", [9_600, 9_613])
@pytest.mark.parametrize("form", ["strided", "s2d"])
def test_pfb_192_row_conv_matches_float64(form, n):
    x = _noise(n, n)
    k, gc, _ = fused.pfb_kernel(96, CFG.sample_rate_hz)
    assert k.shape[0] == 192
    _check(form, x, np.asarray(k), gc)


def test_reference_is_the_textbook_sum():
    """conv_reference itself, against a direct double loop."""
    rng = np.random.default_rng(0)
    k = rng.standard_normal((4, 2, 23))
    x = (rng.standard_normal(200) + 1j * rng.standard_normal(200))
    gc, m = 5, 12
    pad_l = k.shape[-1] - 1 - gc
    xp = np.concatenate([np.zeros(pad_l), x, np.zeros(300)])
    want = np.zeros((4, m))
    for c in range(4):
        for i in range(m):
            seg = xp[i * D:i * D + k.shape[-1]]
            want[c, i] = (k[c, 0] @ seg.real) + (k[c, 1] @ seg.imag)
    np.testing.assert_allclose(fused.conv_reference(x, k, gc, D, m), want,
                               rtol=1e-12, atol=1e-12)
