"""Tests that need the card: ``pytest -m gpu --device gpu``.

They skip elsewhere (the ``gpu_device`` fixture decides, at run time).
Each pins what only the GPU can show: that the pinned precision holds on
the card, and that the card's decisions equal the host's.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tetraear_tpu.config import ReceiverConfig
from tetraear_tpu.ops import fused
from tetraear_tpu.utils import synth

pytestmark = pytest.mark.gpu


def _kernel(width: str):
    cfg = ReceiverConfig()
    if width == "pfb96":
        k, gc, _ = fused.pfb_kernel(96, cfg.sample_rate_hz)
        return k, gc
    cutoff = (cfg.channel_bandwidth_hz / 2) / (cfg.intermediate_rate_hz / 2)
    offs = (np.arange(16) - 7.5) * 25e3
    k, gc, _ = fused.fused_kernel(offs, cfg.sample_rate_hz,
                                  cfg.decimation_factor,
                                  cfg.decim_fir_taps_per_phase,
                                  cfg.channel_fir_taps, cutoff)
    return k, gc


@pytest.mark.parametrize("width", ["16c", "pfb96"])
def test_s2d_conv_keeps_f32_on_card(gpu_device, width):
    """HIGHEST holds on the card: the s2d conv matches the float64
    reference to f32 accuracy (TF32 operands would miss by ~1e-3)."""
    d = ReceiverConfig().decimation_factor
    k, gc = _kernel(width)
    rng = np.random.default_rng(4)
    n = 200_000
    x = ((rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 0.3
         ).astype(np.complex64)
    conv = jax.jit(lambda xx, kk: fused._s2d_conv(xx, kk, gc, k.shape[-1],
                                                  d))
    with jax.default_device(gpu_device):
        y = np.asarray(conv(jax.device_put(x, gpu_device),
                            fused.s2d_kernel(k, d)))
    ref = fused.conv_reference(x, np.asarray(k), gc, d, 2000)
    err = np.abs(y[:, :2000] - ref).max() / np.abs(ref).mean()
    assert err < 1e-4, err


def test_realpair_tail_equals_host(gpu_device):
    """The demod tail (exact symbol pick, sector quantizer) decides the
    same bits on the card as on the host for a planted burst."""
    from tetraear_tpu.models.realpair import _demod_from_pair

    st = synth.make_stream_bits(num_frames=4, lead_bits=64, seed=3,
                                golden=True)
    iq = synth.upsample_hold(synth.synthesize_symbol_phasors(
        synth.bits_to_symbols(st), mapping="ref"), 2.4e6, 2.4e6 / 130.0)
    y = iq[::10][None].astype(np.complex64)
    yr, yi = np.real(y), np.imag(y)
    tail = jax.jit(lambda a, b: _demod_from_pair(a, b, 13).bits)
    with jax.default_device(gpu_device):
        on_card = np.asarray(tail(jax.device_put(yr, gpu_device),
                                  jax.device_put(yi, gpu_device)))
    with jax.default_device(jax.devices("cpu")[0]):
        on_host = np.asarray(tail(yr, yi))
    np.testing.assert_array_equal(on_card, on_host)


def test_golden_clean_ref_exact_on_card(gpu_device):
    """The clean reference-golden fixture decodes bit-exact on the card
    through the ref-exact chain (IIR scans included)."""
    import json
    from pathlib import Path

    from tetraear_tpu.core.decoder import TetraDecoder
    from tetraear_tpu.io.replay import load_iq
    from tetraear_tpu.models.receiver import SignalProcessor

    fx = Path(__file__).resolve().parents[1] / "conformance" / "fixtures"
    lines = (fx / "clean.golden.jsonl").read_text().splitlines()
    golden = [json.loads(x) for x in lines[1:]]
    with jax.default_device(gpu_device):
        sp = SignalProcessor(config=ReceiverConfig(profile="ref-exact"))
        sym = sp.process(np.asarray(load_iq(fx / "clean.cf32")))
    frames = TetraDecoder(auto_decrypt=False).decode(sym)
    assert len(frames) == len(golden)
    for mine, gold in zip(frames, golden):
        assert mine["sds_message"] == gold["sds_message"]
        assert [int(b) for b in mine["bits"]] == gold["bits"]


def test_sync_correlation_exact_on_card(gpu_device):
    """The +/-1 sync conv runs at DEFAULT precision and still counts the
    matching bits exactly; only the final scaling to a fraction may round
    differently in the last bit (no k/22 sits on a threshold)."""
    from tetraear_tpu.ops import sync

    bits = np.random.default_rng(1).integers(0, 2, (4, 5000)).astype(
        np.uint8)
    with jax.default_device(gpu_device):
        on_card = np.asarray(sync.sync_correlation(
            jax.device_put(jnp.asarray(bits), gpu_device)))
    with jax.default_device(jax.devices("cpu")[0]):
        on_host = np.asarray(sync.sync_correlation(jnp.asarray(bits)))
    np.testing.assert_array_equal(np.rint(on_card * 22),
                                  np.rint(on_host * 22))
    np.testing.assert_allclose(on_card, on_host, rtol=0, atol=1e-6)
