"""Fused composite-conv front-end (ops/fused.py): same linear operator as
the staged mixer + decimation FIR + channel FIR cascade, pinned at the
sample level (allclose) and the decision level (identical decoded
frames/candidates)."""

import numpy as np
import jax.numpy as jnp
import pytest

from tetraear_tpu.config import ReceiverConfig
from tetraear_tpu.models.multicarrier import MulticarrierFrontend
from tetraear_tpu.ops import channelizer, fir, fused
from tetraear_tpu.utils import synth


def _staged(x, offsets, cfg, start_index=0):
    decim = cfg.decimation_factor
    taps_d = jnp.asarray(fir.design_decimation_fir(
        decim, cfg.decim_fir_taps_per_phase))
    cutoff = (cfg.channel_bandwidth_hz / 2) / (cfg.intermediate_rate_hz / 2)
    taps_c = jnp.asarray(fir.design_channel_fir(cfg.channel_fir_taps,
                                                cutoff))
    y = channelizer.channelize(jnp.asarray(x), jnp.asarray(offsets),
                               cfg.sample_rate_hz, decim, taps=taps_d,
                               start_index=start_index)
    return np.asarray(fir.fir_filter_same(y, taps_c))


def _fused(x, offsets, cfg, start_index=0):
    decim = cfg.decimation_factor
    cutoff = (cfg.channel_bandwidth_hz / 2) / (cfg.intermediate_rate_hz / 2)
    kernel, gc, rot = fused.fused_kernel(
        np.asarray(offsets, np.float64), cfg.sample_rate_hz, decim,
        cfg.decim_fir_taps_per_phase, cfg.channel_fir_taps, cutoff)
    return np.asarray(fused.fused_channelize(
        jnp.asarray(x, jnp.complex64), kernel, gc, rot, decim,
        start_index=start_index))


class TestOperatorEquivalence:
    @pytest.mark.parametrize("start_index", [0, 13 * 96])
    def test_allclose_on_interior(self, rng, start_index):
        cfg = ReceiverConfig()
        n = 40_000
        x = ((rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 0.3
             ).astype(np.complex64)
        offsets = np.array([-50e3, -25e3, 0.0, 25e3, 75e3], np.float32)
        a = _staged(x, offsets, cfg, start_index)
        b = _fused(x, offsets, cfg, start_index)
        assert a.shape == b.shape
        # identical LTI operator up to fp order; boundaries differ by the
        # cascade's two-stage zero-padding vs the composite's one-stage
        g = 200 // cfg.decimation_factor + 20
        interior = np.s_[:, g:-g]
        scale = np.abs(a[interior]).mean() + 1e-12
        err = np.abs(a[interior] - b[interior]).max() / scale
        assert err < 2e-3, err

    def test_non_grid_offsets_supported(self, rng):
        cfg = ReceiverConfig()
        n = 20_000
        x = ((rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 0.3
             ).astype(np.complex64)
        offsets = np.array([-31_415.0, 12_345.0], np.float32)
        a = _staged(x, offsets, cfg)
        b = _fused(x, offsets, cfg)
        g = 60
        scale = np.abs(a[:, g:-g]).mean() + 1e-12
        assert np.abs(a[:, g:-g] - b[:, g:-g]).max() / scale < 5e-3


class TestDecisionEquivalence:
    def _wideband(self):
        fs = 2.4e6
        x = None
        for seed, off in [(1, -25e3), (2, 0.0), (3, 25e3)]:
            st = synth.make_stream_bits(
                num_frames=4, lead_bits=64, seed=seed, golden=True,
                payload=f"CARRIER {seed} MSG".encode()[:20])
            syms = synth.bits_to_symbols(st)
            ph = synth.synthesize_symbol_phasors(syms, mapping="ref")
            iq = synth.upsample_hold(ph, fs, fs / 130.0)
            if x is None:
                x = np.zeros(len(iq), np.complex64)
            t = np.arange(len(x)) / fs
            x += (iq[:len(x)] * np.exp(2j * np.pi * off * t)
                  ).astype(np.complex64)
        return x

    def test_fused_frontend_identical_decisions(self):
        x = self._wideband()
        offsets = np.array([-25e3, 0.0, 25e3], np.float32)
        staged = MulticarrierFrontend()(x, offsets)
        fused_fe = MulticarrierFrontend(fused=True)(x, offsets)
        np.testing.assert_array_equal(np.asarray(staged.count),
                                      np.asarray(fused_fe.count))
        # same bits everywhere the windows are valid
        sv = np.asarray(staged.cand_valid)
        fv = np.asarray(fused_fe.cand_valid)
        np.testing.assert_array_equal(sv, fv)
        np.testing.assert_array_equal(
            np.asarray(staged.cand_pos)[sv], np.asarray(fused_fe.cand_pos)[fv])
        np.testing.assert_array_equal(
            np.asarray(staged.frame_bits)[sv],
            np.asarray(fused_fe.frame_bits)[fv])
        np.testing.assert_array_equal(np.asarray(staged.crc_ok)[sv],
                                      np.asarray(fused_fe.crc_ok)[fv])

    def test_fused_decodes_all_carriers(self):
        from tetraear_tpu.models.multicarrier import MulticarrierDecoder
        x = self._wideband()
        offsets = np.array([-25e3, 0.0, 25e3], np.float32)
        mc = MulticarrierFrontend(fused=True)
        per_carrier = MulticarrierDecoder(3, auto_decrypt=False).decode(
            mc(x, offsets))
        for c, frames in enumerate(per_carrier):
            texts = {f.get("sds_message") for f in frames}
            assert f"[TXT] CARRIER {c + 1} MSG" in texts


class TestFusedPfb:
    def test_pfb_kernel_matches_gather_pfb(self, rng):
        """fused.pfb_kernel + fused_channelize == ops/pfb.pfb_channelize
        (same causal window, same rotation) on random IQ."""
        from tetraear_tpu.ops import pfb
        cfg = ReceiverConfig()
        C = 96
        n = 96 * 200
        x = ((rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 0.3
             ).astype(np.complex64)
        a = np.asarray(pfb.pfb_channelize(jnp.asarray(x), C,
                                          cfg.decimation_factor))
        kernel, gc, rot = fused.pfb_kernel(C, cfg.sample_rate_hz)
        b = np.asarray(fused.fused_channelize(jnp.asarray(x), kernel, gc,
                                              rot, cfg.decimation_factor))
        assert a.shape == b.shape
        scale = np.abs(a).mean() + 1e-12
        assert np.abs(a - b).max() / scale < 2e-3

    def test_fused_pfb_frontend_decodes(self):
        """PfbMulticarrierFrontend(fused=True) and the s2d split-dispatch
        variant (the bench tier) decode a planted carrier identically to
        the gather formulation."""
        from tetraear_tpu.models.multicarrier import PfbMulticarrierFrontend
        fs = 2.4e6
        st = synth.make_stream_bits(num_frames=4, lead_bits=64, seed=2,
                                    golden=True)
        syms = synth.bits_to_symbols(st)
        ph = synth.synthesize_symbol_phasors(syms, mapping="ref")
        iq = synth.upsample_hold(ph, fs, fs / 130.0)
        t = np.arange(len(iq)) / fs
        x = (iq * np.exp(2j * np.pi * 50e3 * t)).astype(np.complex64)
        a = PfbMulticarrierFrontend()(x)
        av = np.asarray(a.cand_valid)
        # planted carrier at +50 kHz = channel index 2; signal-free
        # channels slice near-zero samples whose hard decisions are
        # fp-order chaotic — no meaningful contract there
        ch = 2
        for variant in (True, "s2d", "s2d_mono"):
            b = PfbMulticarrierFrontend(fused=variant)(x)
            bv = np.asarray(b.cand_valid)
            np.testing.assert_array_equal(av, bv)
            np.testing.assert_array_equal(np.asarray(a.crc_ok)[av],
                                          np.asarray(b.crc_ok)[bv])
            np.testing.assert_array_equal(
                np.asarray(a.frame_bits)[ch][av[ch]],
                np.asarray(b.frame_bits)[ch][bv[ch]])
            assert np.asarray(b.crc_ok)[ch][bv[ch]].any()


class TestFusedDdc:
    def test_ddc_kernel_matches_channelize(self, rng):
        """fused.ddc_kernel (mixer + decimation FIR only) ==
        ops/channelizer.channelize on the interior."""
        cfg = ReceiverConfig()
        n = 26_000
        x = ((rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 0.3
             ).astype(np.complex64)
        offsets = np.array([-50e3, 0.0, 25e3], np.float32)
        taps_d = jnp.asarray(fir.design_decimation_fir(
            cfg.decimation_factor, cfg.decim_fir_taps_per_phase))
        a = np.asarray(channelizer.channelize(
            jnp.asarray(x), jnp.asarray(offsets), cfg.sample_rate_hz,
            cfg.decimation_factor, taps=taps_d))
        kernel, gc, rot = fused.ddc_kernel(
            np.asarray(offsets, np.float64), cfg.sample_rate_hz,
            cfg.decimation_factor, cfg.decim_fir_taps_per_phase)
        b = np.asarray(fused.fused_channelize(jnp.asarray(x), kernel, gc,
                                              rot, cfg.decimation_factor))
        assert a.shape == b.shape
        g = 20
        scale = np.abs(a[:, g:-g]).mean() + 1e-12
        assert np.abs(a[:, g:-g] - b[:, g:-g]).max() / scale < 2e-3


class TestDeferredRotation:
    """rotate=False + ops/fused.symbol_rotation applied to z must equal the
    per-sample derotation path exactly at the decision level: |y|^2 timing
    is rotation-invariant and symbols spaced sps channel samples apart see
    the residual rotation as one per-carrier constant on z."""

    def test_symbol_rotation_constant_is_exact(self):
        cfg = ReceiverConfig()
        offs = np.array([-50e3, -25e3, 0.0, 25e3, 75e3], np.float64)
        rot_cycles = offs / cfg.sample_rate_hz
        cd, sd = fused.symbol_rotation(rot_cycles, cfg.decimation_factor,
                                       cfg.ref_samples_per_symbol)
        want = np.exp(-2j * np.pi * rot_cycles * cfg.decimation_factor
                      * cfg.ref_samples_per_symbol)
        np.testing.assert_allclose(cd, want.real, atol=1e-6)
        np.testing.assert_allclose(-sd * 1j + cd,
                                   cd - 1j * sd, atol=0)  # shape/type sanity
        np.testing.assert_allclose(sd, -want.imag, atol=1e-6)

    @pytest.mark.slow
    def test_deferred_z_rotation_matches_rotated_symbols(self, rng):
        """Direct algebra check: demod decisions from rotate=False channels
        + constant z rotation == decisions from the rotated channels."""
        from tetraear_tpu.models.multicarrier import _demod_front
        cfg = ReceiverConfig()
        n = 66_560
        x = ((rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 0.3
             ).astype(np.complex64)
        # grid offsets: both paths are phase-exact (table vs constant), so
        # disagreement can only be fp ties.  Off-grid offsets are covered
        # by test_fused_frontend_still_decodes_offgrid instead: there the
        # OLD path's per-sample f32 rotation accumulates ~1e-4-cycle phase
        # error by block end while the deferred constant is exact, so
        # bit-level comparison on pure noise measures the old path's
        # phase noise, not an equivalence failure.
        offsets = np.array([-50e3, 0.0, 25e3], np.float64)
        cutoff = (cfg.channel_bandwidth_hz / 2) / (cfg.intermediate_rate_hz
                                                   / 2)
        kernel, gc, rot = fused.fused_kernel(
            offsets, cfg.sample_rate_hz, cfg.decimation_factor,
            cfg.decim_fir_taps_per_phase, cfg.channel_fir_taps, cutoff)
        xj = jnp.asarray(x)
        y_rot = fused.fused_channelize(xj, kernel, gc, rot,
                                       cfg.decimation_factor)
        y_raw = fused.fused_channelize(xj, kernel, gc, rot,
                                       cfg.decimation_factor, rotate=False)
        z_rot = fused.symbol_rotation(rot, cfg.decimation_factor,
                                      cfg.ref_samples_per_symbol)
        bits_a, corr_a, cnt_a = _demod_front(y_rot, cfg)
        bits_b, corr_b, cnt_b = _demod_front(y_raw, cfg, z_rot=z_rot)
        np.testing.assert_array_equal(np.asarray(cnt_a), np.asarray(cnt_b))
        # random-noise z values land on quantizer boundaries only with
        # fp-tie probability; demand near-total agreement
        agree = (np.asarray(bits_a) == np.asarray(bits_b)).mean()
        assert agree > 0.999, agree

    def test_fused_frontend_still_decodes_offgrid(self):
        """End-to-end through MulticarrierFrontend(fused=True) with an
        off-grid carrier (non-periodic rotation): frames must decode."""
        from tetraear_tpu.models.multicarrier import (MulticarrierDecoder,
                                                      MulticarrierFrontend)
        fs = 2.4e6
        st = synth.make_stream_bits(num_frames=4, lead_bits=64, seed=5,
                                    golden=True)
        syms = synth.bits_to_symbols(st)
        ph = synth.synthesize_symbol_phasors(syms, mapping="ref")
        iq = synth.upsample_hold(ph, fs, fs / 130.0)
        t = np.arange(len(iq)) / fs
        off = 31_250.0                       # NOT on the 25 kHz grid
        x = (iq * np.exp(2j * np.pi * off * t)).astype(np.complex64)
        mc = MulticarrierFrontend(fused=True)
        frames = MulticarrierDecoder(1, auto_decrypt=False).decode(
            mc(x, np.array([off], np.float32)))[0]
        texts = {f.get("sds_message") for f in frames}
        assert "[TXT] HELLO HELLO" in texts


class TestSpaceToDepth:
    """fused="s2d": stride-1 space-to-depth formulation of the composite
    conv (ops/fused.s2d_kernel) — same operator, decimation folded into
    the channel dim."""

    def test_s2d_conv_matches_strided(self, rng):
        cfg = ReceiverConfig()
        n = 40_000
        x = ((rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 0.3
             ).astype(np.complex64)
        offsets = np.array([-50e3, 0.0, 25e3, 31_415.0], np.float64)
        cutoff = (cfg.channel_bandwidth_hz / 2) / (cfg.intermediate_rate_hz
                                                   / 2)
        kernel, gc, rot = fused.fused_kernel(
            offsets, cfg.sample_rate_hz, cfg.decimation_factor,
            cfg.decim_fir_taps_per_phase, cfg.channel_fir_taps, cutoff)
        L = kernel.shape[-1]
        k2 = fused.s2d_kernel(kernel, cfg.decimation_factor)
        xj = jnp.asarray(x)
        a = np.asarray(fused.fused_channelize(
            xj, kernel, gc, rot, cfg.decimation_factor))
        b = np.asarray(fused.fused_channelize_s2d(
            xj, k2, gc, L, rot, cfg.decimation_factor))
        assert a.shape == b.shape
        scale = np.abs(a).mean() + 1e-12
        assert np.abs(a - b).max() / scale < 1e-4
        # ri (un-derotated) variant
        yr, yi = fused.fused_channelize_ri(xj, kernel, gc, rot,
                                           cfg.decimation_factor,
                                           rotate=False)
        yr2, yi2 = fused.fused_channelize_s2d_ri(xj, k2, gc, L,
                                                 cfg.decimation_factor)
        assert np.abs(np.asarray(yr) - np.asarray(yr2)).max() / scale < 1e-4
        assert np.abs(np.asarray(yi) - np.asarray(yi2)).max() / scale < 1e-4

    def test_s2d_frontend_decodes(self):
        from tetraear_tpu.models.multicarrier import (MulticarrierDecoder,
                                                      MulticarrierFrontend)
        fs = 2.4e6
        st = synth.make_stream_bits(num_frames=4, lead_bits=64, seed=7,
                                    golden=True)
        syms = synth.bits_to_symbols(st)
        ph = synth.synthesize_symbol_phasors(syms, mapping="ref")
        iq = synth.upsample_hold(ph, fs, fs / 130.0)
        t = np.arange(len(iq)) / fs
        x = (iq * np.exp(2j * np.pi * 25e3 * t)).astype(np.complex64)
        offs = np.array([25e3], np.float32)
        mc = MulticarrierFrontend(fused="s2d")
        frames = MulticarrierDecoder(1, auto_decrypt=False).decode(
            mc(x, offs))[0]
        texts = {f.get("sds_message") for f in frames}
        assert "[TXT] HELLO HELLO" in texts

    def test_s2d_output_folded_matches(self, rng):
        """fold=4 output-folded s2d conv (128 output channels for 16
        carriers) must equal the plain s2d pair, including non-multiple
        m_out tails and every fold residue."""
        cfg = ReceiverConfig()
        cutoff = (cfg.channel_bandwidth_hz / 2) / (cfg.intermediate_rate_hz
                                                   / 2)
        offsets = ((np.arange(16) - 8) * 25e3).astype(np.float64)
        kernel, gc, rot = fused.fused_kernel(
            offsets, cfg.sample_rate_hz, cfg.decimation_factor,
            cfg.decim_fir_taps_per_phase, cfg.channel_fir_taps, cutoff)
        L = kernel.shape[-1]
        k2 = fused.s2d_kernel(kernel, cfg.decimation_factor)
        for fold in (2, 4):
            kf = fused.s2d_of_kernel(kernel, cfg.decimation_factor, fold)
            # four consecutive decim multiples cover every m_out % fold
            # residue class for fold<=4
            for n in (40_000, 40_000 + cfg.decimation_factor,
                      40_000 + 2 * cfg.decimation_factor,
                      40_000 + 3 * cfg.decimation_factor):
                x = ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
                     * 0.3).astype(np.complex64)
                xj = jnp.asarray(x)
                yr, yi = fused.fused_channelize_s2d_ri(
                    xj, k2, gc, L, cfg.decimation_factor)
                yrf, yif = fused.fused_channelize_s2d_of_ri(
                    xj, kf, gc, L, cfg.decimation_factor, fold)
                assert yrf.shape == yr.shape
                scale = np.abs(np.asarray(yr)).mean() + 1e-12
                assert (np.abs(np.asarray(yr) - np.asarray(yrf)).max()
                        / scale < 1e-5)
                assert (np.abs(np.asarray(yi) - np.asarray(yif)).max()
                        / scale < 1e-5)

    def test_s2d_of_frontend_decodes(self):
        from tetraear_tpu.models.multicarrier import (MulticarrierDecoder,
                                                      MulticarrierFrontend)
        fs = 2.4e6
        st = synth.make_stream_bits(num_frames=4, lead_bits=64, seed=7,
                                    golden=True)
        syms = synth.bits_to_symbols(st)
        ph = synth.synthesize_symbol_phasors(syms, mapping="ref")
        iq = synth.upsample_hold(ph, fs, fs / 130.0)
        t = np.arange(len(iq)) / fs
        x = (iq * np.exp(2j * np.pi * 25e3 * t)).astype(np.complex64)
        offs = np.array([25e3, 0.0], np.float32)
        mc = MulticarrierFrontend(fused="s2d_of")
        frames = MulticarrierDecoder(2, auto_decrypt=False).decode(
            mc(x, offs))[0]
        texts = {f.get("sds_message") for f in frames}
        assert "[TXT] HELLO HELLO" in texts

    def test_s2d_pfb_kernel_exact(self, rng):
        """PFB composite (gc=0: pad_l + n exceeds the naive s2d window —
        the regression that required output slicing) must match the
        strided conv exactly."""
        cfg = ReceiverConfig()
        n = 96 * 500
        x = ((rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 0.3
             ).astype(np.complex64)
        kernel, gc, rot = fused.pfb_kernel(96, cfg.sample_rate_hz)
        L = kernel.shape[-1]
        k2 = fused.s2d_kernel(kernel, cfg.decimation_factor)
        xj = jnp.asarray(x)
        a = np.asarray(fused.fused_channelize(
            xj, kernel, gc, rot, cfg.decimation_factor))
        b = np.asarray(fused.fused_channelize_s2d(
            xj, k2, gc, L, rot, cfg.decimation_factor))
        assert a.shape == b.shape
        scale = np.abs(a).mean() + 1e-12
        assert np.abs(a - b).max() / scale < 1e-5


class TestExtractCandidates:
    def test_hierarchical_selection_finds_planted_syncs(self, rng):
        """The segment-max hierarchical top-K (large-stream path,
        n_seg >= 4K) must recover every planted sync position exactly,
        with CRC verdicts equal to the host oracle."""
        import jax.numpy as jnp

        from tetraear_tpu import constants as C
        from tetraear_tpu.models.multicarrier import extract_candidates
        from tetraear_tpu.ops import sync as sync_ops
        from tetraear_tpu.ops.crc import soft_crc_check_host
        from tetraear_tpu.utils import synth

        k = 8
        planted = [1000, 6000, 25000, 60000, 100000]
        bits = rng.integers(0, 2, 140_000).astype(np.uint8)
        for i, at in enumerate(planted):
            slot = synth.make_mac_resource_frame_bits(
                b"HELLO HELLO", seed=100 + i)
            bits[at:at + 510] = slot
        bj = jnp.asarray(bits[None])
        corr = sync_ops.best_correlation(bj)
        assert corr.shape[-1] >= 4 * k * 128      # hierarchical path
        pos, ccorr, valid, frames, crc_ok = extract_candidates(
            bj, corr, jnp.asarray([bits.size]), k, 0.95)
        got = set(np.asarray(pos)[0][np.asarray(valid)[0]].tolist())
        want = {at + 216 for at in planted}
        assert want <= got, (sorted(got), sorted(want))
        # verdicts match the host oracle on the same windows
        for j in range(k):
            if not bool(np.asarray(valid)[0][j]):
                continue
            f = np.asarray(frames)[0, j]
            data = np.concatenate([f[:108], f[122:230]])
            assert bool(np.asarray(crc_ok)[0, j]) == soft_crc_check_host(
                data)

    def test_onehot_windows_match_clamped_gather(self, rng):
        """_windows_onehot == the legacy clamped gather bit-for-bit,
        including adversarial starts (tile boundaries, r=0/127, ends
        past the stream where the clamp repeats the last bit)."""
        import jax.numpy as jnp

        from tetraear_tpu import constants as C
        from tetraear_tpu.models.multicarrier import _windows_onehot

        b = 5000
        bits = rng.integers(0, 2, (3, b)).astype(np.uint8)
        starts = np.array([[0, 1, 127, 128, 129, 255, 4489, 4490,
                            4600, 4900, 4977, 4999]] * 3, np.int32)
        got = np.asarray(_windows_onehot(jnp.asarray(bits),
                                         jnp.asarray(starts)))
        for row in range(3):
            for j, s in enumerate(starts[row]):
                idx = np.minimum(s + np.arange(C.BITS_PER_SLOT), b - 1)
                np.testing.assert_array_equal(got[row, j], bits[row, idx])

    def test_onehot_candidates_equal_vmap(self, rng, monkeypatch):
        """Full extract_candidates parity: TETRAEAR_CAND_GATHER=onehot
        produces identical (pos, corr, valid, frames, crc) to the
        legacy vmap gather, on a stream with planted frames AND rows
        whose top-k spills into masked/clamped territory."""
        import jax.numpy as jnp

        from tetraear_tpu.models.multicarrier import extract_candidates
        from tetraear_tpu.ops import sync as sync_ops
        from tetraear_tpu.utils import synth

        bits = rng.integers(0, 2, (2, 9000)).astype(np.uint8)
        bits[0, 700:1210] = synth.make_mac_resource_frame_bits(
            b"HELLO", seed=3)
        bits[1, 8400:8910] = synth.make_mac_resource_frame_bits(
            b"EDGE", seed=4)
        bj = jnp.asarray(bits)
        corr = sync_ops.best_correlation(bj)
        vb = jnp.asarray([9000, 9000])

        def run():
            return [np.asarray(o) for o in
                    extract_candidates(bj, corr, vb, 16, 0.9)]

        monkeypatch.setenv("TETRAEAR_CAND_GATHER", "vmap")
        legacy = run()
        monkeypatch.setenv("TETRAEAR_CAND_GATHER", "onehot")
        fast = run()
        for a, c in zip(legacy, fast):
            np.testing.assert_array_equal(a, c)

    def test_small_stream_plain_topk_path(self, rng):
        """Streams too short for segmentation use plain top_k and still
        find the planted sync."""
        import jax.numpy as jnp

        from tetraear_tpu.models.multicarrier import extract_candidates
        from tetraear_tpu.ops import sync as sync_ops
        from tetraear_tpu.utils import synth

        bits = rng.integers(0, 2, 1200).astype(np.uint8)
        bits[300:810] = synth.make_mac_resource_frame_bits(b"HI", seed=7)
        bj = jnp.asarray(bits[None])
        corr = sync_ops.best_correlation(bj)
        pos, _, valid, _, _ = extract_candidates(
            bj, corr, jnp.asarray([bits.size]), 64, 0.95)
        got = set(np.asarray(pos)[0][np.asarray(valid)[0]].tolist())
        assert 516 in got


class TestBlockBatched:
    """Block-batched fused pipeline (MulticarrierFrontend.batched /
    _compiled_fused_batch): B independent blocks per dispatch must equal
    the per-block pipeline's outputs, stacked (VERDICT r3 item 3 — the
    dispatch-floor amortization must not change any decision)."""

    @pytest.mark.parametrize("variant", ["s2d", "s2d_of", True])
    def test_batched_equals_per_block(self, variant):
        rng = np.random.default_rng(11)
        cfg = ReceiverConfig()
        nb, B = 26_000, 3
        offsets = np.array([-50e3, -25e3, 0.0, 25e3], np.float32)
        xb = ((rng.standard_normal((B, nb))
               + 1j * rng.standard_normal((B, nb))) * 0.2
              ).astype(np.complex64)
        # plant a real burst in block 1, carrier 2 (offset 0) so the
        # comparison covers real candidates, not just noise
        st = synth.make_stream_bits(num_frames=2, lead_bits=64, seed=3,
                                    golden=True)
        ph = synth.synthesize_symbol_phasors(synth.bits_to_symbols(st),
                                             mapping="ref")
        iq = synth.upsample_hold(ph, 2.4e6, 2.4e6 / 130.0)[:nb]
        xb[1, :len(iq)] += iq.astype(np.complex64)

        mc = MulticarrierFrontend(num_candidates=16, threshold=0.80,
                                  fused=variant)
        rb = mc.batched(xb, offsets)
        for b in range(B):
            r1 = mc(xb[b], offsets)
            np.testing.assert_array_equal(np.asarray(rb.bits[b]),
                                          np.asarray(r1.bits))
            np.testing.assert_allclose(np.asarray(rb.sync_corr[b]),
                                       np.asarray(r1.sync_corr),
                                       rtol=0, atol=1e-5)
            np.testing.assert_array_equal(np.asarray(rb.count[b]),
                                          np.asarray(r1.count))
            np.testing.assert_array_equal(np.asarray(rb.cand_pos[b]),
                                          np.asarray(r1.cand_pos))
            np.testing.assert_array_equal(np.asarray(rb.cand_valid[b]),
                                          np.asarray(r1.cand_valid))
            np.testing.assert_array_equal(np.asarray(rb.frame_bits[b]),
                                          np.asarray(r1.frame_bits))
            np.testing.assert_array_equal(np.asarray(rb.crc_ok[b]),
                                          np.asarray(r1.crc_ok))

    def test_batched_requires_fused(self):
        mc = MulticarrierFrontend(fused=False)
        with pytest.raises(ValueError):
            mc.batched(np.zeros((2, 1000), np.complex64),
                       np.array([0.0], np.float32))

    @pytest.mark.parametrize("variant", ["s2d", "s2d_mono", False])
    def test_pfb_batched_equals_per_block(self, variant):
        from tetraear_tpu.models.multicarrier import PfbMulticarrierFrontend
        rng = np.random.default_rng(5)
        nb, B = 12_480, 2
        xb = ((rng.standard_normal((B, nb))
               + 1j * rng.standard_normal((B, nb))) * 0.2
              ).astype(np.complex64)
        pfb = PfbMulticarrierFrontend(num_candidates=8, threshold=0.80,
                                      fused=variant)
        rb = pfb.batched(xb)
        for b in range(B):
            r1 = pfb(xb[b])
            np.testing.assert_array_equal(np.asarray(rb.bits[b]),
                                          np.asarray(r1.bits))
            np.testing.assert_allclose(np.asarray(rb.sync_corr[b]),
                                       np.asarray(r1.sync_corr),
                                       rtol=0, atol=1e-5)
            np.testing.assert_array_equal(np.asarray(rb.cand_pos[b]),
                                          np.asarray(r1.cand_pos))
            np.testing.assert_array_equal(np.asarray(rb.crc_ok[b]),
                                          np.asarray(r1.crc_ok))

    def test_pfb_batched_rejects_pallas(self):
        """The Pallas variants are gone: asking for one fails loudly."""
        from tetraear_tpu.models.multicarrier import PfbMulticarrierFrontend
        pfb = PfbMulticarrierFrontend(fused="pallas")
        with pytest.raises(ValueError):
            pfb.batched(np.zeros((2, 9600), np.complex64))


class TestPfbHalfHandoff:
    """fused="s2d_hb16": bf16 conv->tail handoff must keep decisions on
    real bursts identical to the f32 split path (noise-marginal bits may
    differ; the planted-burst candidates/CRC must not)."""

    def test_hb16_decodes_planted_burst_identically(self):
        from tetraear_tpu.models.multicarrier import PfbMulticarrierFrontend
        fs = 2.4e6
        st = synth.make_stream_bits(num_frames=3, lead_bits=64, seed=9,
                                    golden=True)
        ph = synth.synthesize_symbol_phasors(synth.bits_to_symbols(st),
                                             mapping="ref")
        iq = synth.upsample_hold(ph, fs, fs / 130.0)
        t = np.arange(len(iq)) / fs
        x = (iq * np.exp(2j * np.pi * 50e3 * t)).astype(np.complex64)

        a = PfbMulticarrierFrontend(num_candidates=16, threshold=0.80,
                                    fused="s2d")(x)
        b = PfbMulticarrierFrontend(num_candidates=16, threshold=0.80,
                                    fused="s2d_hb16")(x)
        va, vb = np.asarray(a.cand_valid), np.asarray(b.cand_valid)
        # the channel carrying the burst must agree candidate-for-
        # candidate (positions and CRC verdicts)
        hot = np.where(np.asarray(a.crc_ok & a.cand_valid).any(axis=-1))[0]
        assert hot.size >= 1
        for c in hot:
            np.testing.assert_array_equal(va[c], vb[c])
            np.testing.assert_array_equal(np.asarray(a.cand_pos)[c][va[c]],
                                          np.asarray(b.cand_pos)[c][vb[c]])
            np.testing.assert_array_equal(np.asarray(a.crc_ok)[c][va[c]],
                                          np.asarray(b.crc_ok)[c][vb[c]])

    def test_hb16_batched_parity(self):
        from tetraear_tpu.models.multicarrier import PfbMulticarrierFrontend
        rng = np.random.default_rng(6)
        xb = ((rng.standard_normal((2, 12_480))
               + 1j * rng.standard_normal((2, 12_480))) * 0.2
              ).astype(np.complex64)
        pfb = PfbMulticarrierFrontend(num_candidates=8, threshold=0.80,
                                      fused="s2d_hb16")
        rb = pfb.batched(xb)
        r0 = pfb(xb[0])
        np.testing.assert_array_equal(np.asarray(rb.bits[0]),
                                      np.asarray(r0.bits))
