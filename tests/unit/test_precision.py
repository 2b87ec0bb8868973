"""The precision each device stage lowers with, read from the lowered
StableHLO: f32 channelizer convs and matmuls are pinned to HIGHEST (on a
GPU an unpinned f32 conv may run in TF32), the +/-1 sync correlation to
DEFAULT, and the symbol pick is a selection with no matmul at all."""

import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tetraear_tpu.config import ReceiverConfig
from tetraear_tpu.ops import fir, fused, pfb, resample, sync

CFG = ReceiverConfig()
D = CFG.decimation_factor


def _precisions(fn, *args) -> list:
    """Precision pair of every convolution / dot_general in the lowering."""
    text = jax.jit(fn).lower(*args).as_text()
    ops = [line for line in text.splitlines()
           if "stablehlo.convolution" in line
           or "stablehlo.dot_general" in line]
    assert ops, "no conv/dot in the lowered program"
    return [tuple(re.findall(r"precision (\w+)", line))
            or tuple(re.findall(r"precision = \[(\w+), (\w+)\]", line)[0])
            for line in ops]


def _kernel(c: int):
    cutoff = (CFG.channel_bandwidth_hz / 2) / (CFG.intermediate_rate_hz / 2)
    offs = (np.arange(c) - (c - 1) / 2) * 25e3
    return fused.fused_kernel(offs, CFG.sample_rate_hz, D,
                              CFG.decim_fir_taps_per_phase,
                              CFG.channel_fir_taps, cutoff)


X = jnp.zeros(6000, jnp.complex64)
K, GC, ROT = _kernel(4)
L = K.shape[-1]
K2 = fused.s2d_kernel(K, D)
K_OF = fused.s2d_of_kernel(K, D, 4)

HIGHEST_SITES = {
    "fused_channelize": lambda x: fused.fused_channelize(x, K, GC, ROT, D),
    "fused_channelize_ri": lambda x: fused.fused_channelize_ri(
        x, K, GC, ROT, D, rotate=False),
    "s2d_conv": lambda x: fused._s2d_conv(x, K2, GC, L, D),
    "s2d_of_conv": lambda x: fused._s2d_conv_folded(x, K_OF, GC, L, D, 4),
    "fir_decimate": lambda x: fir.fir_decimate(
        x, jnp.asarray(fir.design_decimation_fir(D)), D),
    "rational_resample": lambda x: resample.rational_resample(
        x, 3, 10, resample.design_rrc_resampler(3, 10, 4)),
    "pfb_realpair_idft": lambda x: pfb.pfb_channelize_realpair(
        jnp.stack([jnp.real(x), jnp.imag(x)]), 96, D, chunk=64),
}


@pytest.mark.parametrize("site", sorted(HIGHEST_SITES))
def test_f32_sites_pinned_highest(site):
    precs = _precisions(HIGHEST_SITES[site], X)
    assert all(p == ("HIGHEST", "HIGHEST") for p in precs), precs


def test_sharded_fused_step_pinned_highest():
    from tetraear_tpu.parallel.mesh import make_mesh
    from tetraear_tpu.parallel.sharded import (build_sharded_step_fused,
                                               shard_inputs)
    mesh = make_mesh(carrier=2, time=2, devices=jax.devices()[:4])
    offs = np.array([-25e3, 25e3], np.float32)
    step = D * CFG.ref_samples_per_symbol
    run = build_sharded_step_fused(mesh, offs, CFG, halo=4 * step)
    xs, _ = shard_inputs(mesh, np.zeros(2 * 40 * step, np.complex64), offs)
    precs = _precisions(run, xs)
    # the channelizer conv at HIGHEST; the one other conv is the +/-1
    # sync correlation at DEFAULT
    assert sorted(precs) == [("DEFAULT", "DEFAULT"),
                             ("HIGHEST", "HIGHEST")], precs


def test_sync_correlation_default_is_exact():
    """+/-1 operands: DEFAULT precision (TF32 or bf16 alike) is exact."""
    precs = _precisions(sync.sync_correlation,
                        jnp.zeros((2, 100), jnp.uint8))
    assert precs == [("DEFAULT", "DEFAULT")]


@pytest.mark.parametrize("where", ["realpair", "sharded"])
def test_symbol_pick_is_a_selection(where):
    """The best-phase symbol pick lowers to a gather, not a matmul that
    reduced precision would round."""
    if where == "realpair":
        from tetraear_tpu.models.realpair import _demod_from_pair
        fn = lambda a, b: _demod_from_pair(a, b, 13).bits  # noqa: E731
        text = jax.jit(fn).lower(jnp.zeros((2, 1300)),
                                 jnp.zeros((2, 1300))).as_text()
    else:
        from tetraear_tpu.parallel.mesh import make_mesh
        from tetraear_tpu.parallel.sharded import (build_sharded_step,
                                                   shard_inputs)
        mesh = make_mesh(carrier=1, time=2, devices=jax.devices()[:2])
        step = D * CFG.ref_samples_per_symbol
        run = build_sharded_step(mesh, CFG, halo=4 * step)
        xs, offs = shard_inputs(mesh, np.zeros(2 * 40 * step, np.complex64),
                                np.zeros(1, np.float32))
        text = run.lower(xs, offs).as_text()
    assert "gather" in text
    assert "dot_general" not in text
