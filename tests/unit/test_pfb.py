"""Polyphase DFT filterbank channelizer tests (PAPERS.md technique)."""

import numpy as np
import jax.numpy as jnp

from tetraear_tpu.ops import ddc, pfb


class TestPfbChannelize:
    def test_matches_direct_formula(self, rng):
        """Exact agreement with the defining per-channel sum."""
        C, D, P = 8, 4, 6
        taps = pfb.design_prototype(C, P)
        n = 800
        x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
             ).astype(np.complex64)
        got = np.asarray(pfb.pfb_channelize(jnp.asarray(x), C, D, taps,
                                            chunk=64))
        pc = len(taps)
        xp = np.concatenate([np.zeros(pc, complex), x])
        M = n // D
        want = np.zeros((C, M), complex)
        for m in range(M):
            win = np.array([xp[m * D - k + pc] for k in range(pc)])
            for c in range(C):
                ph = np.exp(-2j * np.pi * c
                            * (m * D - np.arange(pc)) / C)
                want[c, m] = np.sum(taps * win * ph)
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel < 1e-5

    def test_channel_equals_ddc_plus_fir(self, rng):
        """Each filterbank channel == mix-to-baseband + same-prototype
        causal FIR decimation."""
        C, D = 8, 4
        taps = pfb.design_prototype(C, 6)
        pc = len(taps)
        n = 1600
        x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
             ).astype(np.complex64)
        got = np.asarray(pfb.pfb_channelize(jnp.asarray(x), C, D, taps))
        for c_test in (1, 5):
            fc = c_test / C              # normalized (fs = 1)
            xc = np.asarray(ddc.frequency_shift(jnp.asarray(x), fc, 1.0))
            full = np.convolve(np.concatenate([np.zeros(pc), xc]),
                               taps)[pc:pc + n]
            want = full[::D][:n // D]
            rel = (np.linalg.norm(got[c_test] - want)
                   / np.linalg.norm(want))
            assert rel < 1e-3, c_test

    def test_channel_isolation(self, rng):
        """A tone on channel 3's center lands in channel 3, not neighbours."""
        C, D = 16, 8
        n = 4096
        t = np.arange(n)
        tone = np.exp(2j * np.pi * (3 / C) * t).astype(np.complex64)
        out = np.asarray(pfb.pfb_channelize(jnp.asarray(tone), C, D))
        power = np.abs(out[:, 20:]).mean(axis=1)
        assert power[3] > 10 * power[(3 + 2) % C]
        assert power[3] > 10 * power[(3 - 2) % C]

    def test_offsets_layout(self):
        offs = pfb.channel_offsets_hz(96, 2.4e6)
        assert offs[0] == 0.0
        assert offs[1] == 25e3
        assert offs[-1] == -25e3
        assert len(offs) == 96


class TestPfbFrontend:
    def test_active_channels_decode(self):
        """3 active 25 kHz-grid carriers among 96 each recover their own
        message through the full PFB pipeline."""
        from tetraear_tpu.models.multicarrier import (MulticarrierDecoder,
                                                      PfbMulticarrierFrontend)
        from tetraear_tpu.utils import synth
        fs = 2.4e6
        x = None
        actives = {-50e3: 1, 0.0: 2, 75e3: 3}
        for off, seed in actives.items():
            st = synth.make_stream_bits(num_frames=4, lead_bits=64,
                                        seed=seed, golden=True,
                                        payload=f"PFB CH {seed}".encode())
            syms = synth.bits_to_symbols(st)
            ph = synth.synthesize_symbol_phasors(syms, mapping="ref")
            iq = synth.upsample_hold(ph, fs, fs / 130.0)
            if x is None:
                x = np.zeros(len(iq), np.complex64)
            t = np.arange(len(x)) / fs
            x += (iq[:len(x)] * np.exp(2j * np.pi * off * t)
                  ).astype(np.complex64)

        mc = PfbMulticarrierFrontend()
        assert mc.num_channels == 96
        res = mc(x)
        assert res.bits.shape[0] == 96
        offs = mc.channel_offsets_hz()
        dec = MulticarrierDecoder(96, auto_decrypt=False)
        per = dec.decode(res)
        for off, seed in actives.items():
            c = int(np.argmin(np.abs(offs - off)))
            texts = {f.get("sds_message") for f in per[c]}
            assert f"[TXT] PFB CH {seed}" in texts, (off, texts)

    def test_fused_variants_decision_identical(self, rng):
        """fused='s2d' / 's2d_mono' / True (strided) PFB frontends
        produce identical bits/crc over the full 96-channel band."""
        from tetraear_tpu.models.multicarrier import PfbMulticarrierFrontend
        n = 48_000
        x = ((rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 0.1
             ).astype(np.complex64)
        ref = PfbMulticarrierFrontend(num_candidates=16, fused="s2d")(x)
        for v in ("s2d_mono", True):
            got = PfbMulticarrierFrontend(num_candidates=16, fused=v)(x)
            np.testing.assert_array_equal(np.asarray(ref.bits),
                                          np.asarray(got.bits)), v
            np.testing.assert_array_equal(np.asarray(ref.crc_ok),
                                          np.asarray(got.crc_ok)), v
