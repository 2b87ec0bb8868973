"""Multi-carrier device pipeline (BASELINE config 4): one wideband block ->
per-carrier bits, dense sync scores, fixed-K frame candidates with batched
CRC verdicts — all in a single jitted program.

This is the flagship "model": the whole per-block decode compute, batched
over carriers, with only the data-dependent MAC/SDS parsing left to the
host.  Ragged outputs (0..N sync hits per carrier) are returned as
fixed-capacity top-K candidates with validity masks (SURVEY.md §7 hard
parts: jit-friendly raggedness).
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from tetraear_tpu import constants as C
from tetraear_tpu.config import ReceiverConfig
from tetraear_tpu.ops import channelizer, dqpsk, fir, sync, timing
from tetraear_tpu.ops.crc import soft_crc_check_batch


class MulticarrierResult(NamedTuple):
    bits: jnp.ndarray        # (C, B) uint8 demodulated bit streams
    sync_corr: jnp.ndarray   # (C, B-21) float32 best-of-TS1/TS2
    count: jnp.ndarray       # (C,) int32 valid symbol count per carrier
    cand_pos: jnp.ndarray    # (C, K) int32 candidate sync bit positions
    cand_corr: jnp.ndarray   # (C, K) float32 candidate correlations
    cand_valid: jnp.ndarray  # (C, K) bool — corr >= threshold & in-bounds
    frame_bits: jnp.ndarray  # (C, K, 510) uint8 candidate frame windows
    crc_ok: jnp.ndarray      # (C, K) bool — device soft-CRC verdict


def _window_mode() -> str:
    """Candidate-window extraction: "onehot" (gather-free tile matmul,
    the accelerator default) or "vmap" (the per-row gather, the CPU
    default).  Both are bit-identical (pinned by tests/unit/
    test_fused_frontend.py).  On CPU the indexed gather is near-free
    while the one-hot einsums are ~GFLOPs of real work.  Which one the
    GPU should take is not measured yet."""
    v = os.environ.get("TETRAEAR_CAND_GATHER")
    if v is None:
        return "onehot" if jax.default_backend() != "cpu" else "vmap"
    if v not in ("vmap", "onehot"):
        raise ValueError(f"TETRAEAR_CAND_GATHER={v!r} invalid")
    return v


def _windows_onehot(bits: jnp.ndarray, start: jnp.ndarray) -> jnp.ndarray:
    """Gather-free candidate-window extraction, bit-identical to the
    clamped gather ``bits[c, min(start+j, b-1)]``.

    The bit stream is tiled into 128-bit segments (pure reshape), each
    candidate's 6 consecutive tiles are selected by a one-hot MATMUL
    over the segment axis (no gather), and the sub-tile shift r in
    [0,128) is applied by two levels of one-hot-weighted STATIC slices
    (8 x 16).  Padding
    replicates the last bit so out-of-range reads equal the legacy
    clamp exactly.  All arithmetic is one-hot selection of 0/1 values
    in bf16 with f32 accumulation — exact by construction (pinned by
    tests/unit/test_fused_frontend.py)."""
    S = 128
    b = bits.shape[-1]
    lead = bits.shape[:-1] + start.shape[-1:]          # (..., K)
    flat = bits.reshape(-1, b)
    n = flat.shape[0]
    kk = start.shape[-1]
    st = start.reshape(n, kk).astype(jnp.int32)
    # max read index: start + 509; pad (last-bit replicate) to tile grid
    # with 6 spare tiles so every q+i tile row exists
    pad_to = (-(-(b + C.BITS_PER_SLOT) // S) + 6) * S
    padf = jnp.concatenate(
        [flat, jnp.broadcast_to(flat[:, -1:], (n, pad_to - b))], axis=-1)
    nseg = pad_to // S
    r_tiles = padf.reshape(n, nseg, S)
    q, r = st // S, st % S
    ohq = (q[..., None]
           == jnp.arange(nseg, dtype=jnp.int32)).astype(jnp.bfloat16)
    # T[n, k, i*S:(i+1)*S] = tile q+i of row n  (6 shifted one-hot
    # matmuls; ~10 GFLOP at the 96-channel bench shape)
    parts = [
        jnp.einsum("nkq,nqt->nkt", ohq[:, :, : nseg - i],
                   r_tiles[:, i:, :].astype(jnp.bfloat16),
                   preferred_element_type=jnp.float32)
        for i in range(6)
    ]
    t6 = jnp.concatenate(parts, axis=-1)               # (n, K, 768) f32
    # fine shift r = 16*a + u via two one-hot-weighted static-slice sums
    a, u = r // 16, r % 16
    oha = (a[..., None] == jnp.arange(8)).astype(jnp.float32)
    t8 = jnp.stack([t6[..., 16 * i:16 * i + C.BITS_PER_SLOT + 15]
                    for i in range(8)], axis=-2)       # (n, K, 8, 525)
    t1 = jnp.sum(oha[..., None] * t8, axis=-2)         # (n, K, 525)
    ohu = (u[..., None] == jnp.arange(16)).astype(jnp.float32)
    t16 = jnp.stack([t1[..., i:i + C.BITS_PER_SLOT]
                     for i in range(16)], axis=-2)     # (n, K, 16, 510)
    frames = jnp.sum(ohu[..., None] * t16, axis=-2)
    return frames.astype(jnp.uint8).reshape(lead + (C.BITS_PER_SLOT,))


def extract_candidates(bits: jnp.ndarray, corr: jnp.ndarray,
                       valid_bits: jnp.ndarray, k: int,
                       threshold: float) -> tuple:
    """Top-K sync candidates + 510-bit frame windows + batched CRC.

    bits: (..., B); corr: (..., B-21); valid_bits: (...,) count of valid
    bits per row (padded tails are masked out).
    """
    b = bits.shape[-1]
    ncorr = corr.shape[-1]
    pos_idx = jnp.arange(ncorr, dtype=jnp.int32)
    # a window starting at p covers bits [p-216, p-216+510)
    in_bounds = ((pos_idx >= C.SYNC_TO_FRAME_START_BITS)
                 & (pos_idx[None, ...] - C.SYNC_TO_FRAME_START_BITS
                    + C.BITS_PER_SLOT <= valid_bits[..., None]))
    in_bounds = jnp.broadcast_to(in_bounds.reshape(corr.shape), corr.shape)
    masked = jnp.where(in_bounds, corr, -1.0)
    # hierarchical top-K: segment-max reduce, then top_k over the ~1000
    # segment maxima, then refine to the in-segment argmax, instead of
    # lax.top_k over the full (C, 131k) bench stream.
    # True syncs are >=510 bits apart so a 128-bit segment holds at most
    # one — the only semantic change is that near-duplicate positions of
    # the SAME sync (+/-1-bit 20/22 matches) collapse to the best one,
    # which downstream consumers prefer anyway.
    seg = 128
    n_seg = -(-ncorr // seg)
    if n_seg < 4 * k:
        # small blocks: plain top_k is cheap and k may exceed n_seg
        top_corr, top_pos = jax.lax.top_k(masked, k)      # (..., K)
    else:
        padded = jnp.pad(masked, [(0, 0)] * (masked.ndim - 1)
                         + [(0, n_seg * seg - ncorr)], constant_values=-1.0)
        segs = padded.reshape(masked.shape[:-1] + (n_seg, seg))
        seg_max = segs.max(axis=-1)
        seg_arg = segs.argmax(axis=-1).astype(jnp.int32)
        top_corr, top_seg = jax.lax.top_k(seg_max, k)     # (..., K)
        top_pos = (top_seg * seg
                   + jnp.take_along_axis(seg_arg, top_seg, axis=-1))
    start = jnp.maximum(top_pos - C.SYNC_TO_FRAME_START_BITS, 0)
    if _window_mode() == "onehot":
        frames = _windows_onehot(bits, start)
    else:
        win = start[..., None] + jnp.arange(C.BITS_PER_SLOT)[None, :]
        win = jnp.minimum(win, b - 1)
        # batched gather WITHOUT materializing the (C, K, B) broadcast
        # of the bit streams first (at 96 channels x 64 candidates x
        # 131k bench bits the broadcast is an ~800 MB u8 intermediate)
        flat_bits = bits.reshape(-1, b)
        flat_win = win.reshape(flat_bits.shape[0], -1, C.BITS_PER_SLOT)
        frames = jax.vmap(lambda bb, ww: bb[ww])(flat_bits, flat_win)
        frames = frames.reshape(win.shape)
    valid = (top_corr >= threshold)
    # CRC verdicts straight from the gathered candidate frames: the data
    # region (window offsets [0,108) u [122,230), sync-overlap geometry)
    # through the batched GF(2)-matmul soft check.  The previous dense
    # sliding-conv CRC scored EVERY window position — ~190 GFLOP at the
    # 96-channel bench shape for verdicts only K candidates consume;
    # this is the same verdict function on the same windows at ~1/2000th the FLOPs.
    # Verdicts at invalid (clamped) candidates are masked by `valid`.
    data_bits = jnp.concatenate(
        [frames[..., C.BURST_BLOCK1[0]:C.BURST_BLOCK1[1]],
         frames[..., C.BURST_BLOCK2[0]:C.BURST_BLOCK2[1]]], axis=-1)
    crc_ok = soft_crc_check_batch(data_bits)
    return top_pos.astype(jnp.int32), top_corr, valid, frames.astype(jnp.uint8), crc_ok


def _demod_front(y: jnp.ndarray, cfg: ReceiverConfig,
                 z_rot: tuple | None = None) -> tuple:
    """Post-channelizer demod stages: timing -> demod -> sync scores.

    z_rot: per-carrier (cos, sin) of the deferred residual rotation
    (ops/fused.symbol_rotation).  |y|^2 timing is rotation-invariant and
    the rotation enters z as a per-carrier constant, so callers using
    fused_channelize(rotate=False) pass it here — one (C, 1) broadcast
    multiply at symbol rate instead of the (C, M) channel-rate rotation."""
    ts = timing.best_phase_pick(y, cfg.ref_samples_per_symbol)
    if z_rot is None:
        hard = dqpsk.demodulate_hard(ts.symbols, profile="ref")
    else:
        s = ts.symbols
        z = s[..., 1:] * jnp.conj(s[..., :-1])
        rot = jax.lax.complex(jnp.asarray(z_rot[0], jnp.float32),
                              -jnp.asarray(z_rot[1], jnp.float32))
        z = z * rot[..., None]
        zr, zi = jnp.real(z), jnp.imag(z)
        hard = dqpsk.quantize_z_ref(zr, zi)
        # best_phase_pick zero-pads past `count`; atan2(0,0)=0 put those
        # in bin 0 on the legacy path while quantize_z_ref falls through
        # to 3 — keep the padded bits identical across paths
        hard = jnp.where((zr == 0) & (zi == 0), jnp.uint8(0), hard)
    bits = dqpsk.symbols_to_bits(hard)
    corr = sync.best_correlation(bits)
    return bits, corr, ts.count


@functools.lru_cache(maxsize=8)
def _candidates_compiled(k: int, threshold: float):
    """The candidates+CRC stage as its OWN dispatched program, shared
    by every front-end (identical outputs to the single-program
    _demod_tail)."""
    @jax.jit
    def run(bits, corr, count):
        valid_bits = jnp.maximum(count - 1, 0) * 2
        return extract_candidates(bits, corr, valid_bits, k, threshold)
    return run


def _demod_tail(y: jnp.ndarray, cfg: ReceiverConfig, k: int,
                threshold: float) -> MulticarrierResult:
    """Single-program variant (used inside larger jits); prefer the
    two-program _demod_front + _candidates_compiled pipeline in
    host-called frontends (see _candidates_compiled docstring)."""
    bits, corr, count = _demod_front(y, cfg)
    valid_bits = jnp.maximum(count - 1, 0) * 2
    pos, ccorr, valid, frames, crc_ok = extract_candidates(
        bits, corr, valid_bits, k, threshold)
    return MulticarrierResult(bits, corr, count, pos, ccorr, valid,
                              frames, crc_ok)


def _multicarrier_block(x: jnp.ndarray, offsets_hz: jnp.ndarray,
                        cfg: ReceiverConfig, k: int, threshold: float,
                        start_index) -> MulticarrierResult:
    decim = cfg.decimation_factor
    taps_d = jnp.asarray(fir.design_decimation_fir(
        decim, cfg.decim_fir_taps_per_phase))
    cutoff = (cfg.channel_bandwidth_hz / 2) / (cfg.intermediate_rate_hz / 2)
    taps_c = jnp.asarray(fir.design_channel_fir(cfg.channel_fir_taps, cutoff))

    y = channelizer.channelize(x, offsets_hz, cfg.sample_rate_hz, decim,
                               taps=taps_d, start_index=start_index)
    y = fir.fir_filter_same(y, taps_c)
    return _demod_tail(y, cfg, k, threshold)


def _stage_list(conv_prog, kernel_dev, tail_prog, cand) -> list:
    """The split-dispatch step as (name, jitted program, extra args):
    each program takes the previous one's outputs followed by its extra
    args, the first one the input block.  Lets a caller compile, time and
    size each dispatched program of the step on its own."""
    return [("conv", conv_prog, (kernel_dev,)), ("tail", tail_prog, ()),
            ("candidates", cand, ())]


class MulticarrierFrontend:
    """Jitted multi-carrier block pipeline with a fixed candidate budget.

    ``fused=True`` replaces the staged mixer + decimation FIR + channel
    FIR with one dense multi-channel convolution (ops/fused.py) — the
    same linear operator as one implicit GEMM; requires concrete (host)
    carrier offsets at call time.  ``fused="s2d"`` uses the
    space-to-depth stride-1 formulation of the same conv
    (ops/fused.s2d_kernel): decimation folded into the channel
    dimension.
    """

    def __init__(self, config: ReceiverConfig | None = None,
                 num_candidates: int = 64, threshold: float = 0.80,
                 fused: bool | str = False):
        self.config = config or ReceiverConfig()
        self.num_candidates = num_candidates
        self.threshold = threshold
        self.fused = fused

    @functools.lru_cache(maxsize=8)
    def _compiled(self, n: int, c: int):
        cfg, k, thr = self.config, self.num_candidates, self.threshold

        @jax.jit
        def front(x, offsets, start_index):
            decim = cfg.decimation_factor
            taps_d = jnp.asarray(fir.design_decimation_fir(
                decim, cfg.decim_fir_taps_per_phase))
            cutoff = ((cfg.channel_bandwidth_hz / 2)
                      / (cfg.intermediate_rate_hz / 2))
            taps_c = jnp.asarray(fir.design_channel_fir(
                cfg.channel_fir_taps, cutoff))
            y = channelizer.channelize(x, offsets, cfg.sample_rate_hz,
                                       decim, taps=taps_d,
                                       start_index=start_index)
            y = fir.fir_filter_same(y, taps_c)
            return _demod_front(y, cfg)

        cand = _candidates_compiled(k, thr)

        def run(x, offsets, start_index):
            bits, corr, count = front(x, offsets, start_index)
            pos, ccorr, valid, frames, crc_ok = cand(bits, corr, count)
            return MulticarrierResult(bits, corr, count, pos, ccorr,
                                      valid, frames, crc_ok)
        return run

    @functools.lru_cache(maxsize=8)
    def _fused_stages(self, offs_key: tuple):
        """Build the fused-variant device programs once per offset set.

        Returns (kernel_dev, front, conv_prog, tail_prog): `front(x,
        kern, start_index)` is the composed single-block front-end;
        for the split-dispatch variants conv_prog/tail_prog are the
        underlying stage programs (the batched path re-vmaps them),
        else None.
        """
        from tetraear_tpu.ops import fused
        cfg = self.config
        decim = cfg.decimation_factor
        cutoff = ((cfg.channel_bandwidth_hz / 2)
                  / (cfg.intermediate_rate_hz / 2))
        kernel, gc, rot_cycles = fused.fused_kernel(
            np.asarray(offs_key, np.float64), cfg.sample_rate_hz, decim,
            cfg.decim_fir_taps_per_phase, cfg.channel_fir_taps, cutoff)
        rot_np = np.asarray(rot_cycles)
        # rotation deferred to z (per-carrier constant): the (C, M)
        # channel-rate derotation stage disappears from the program
        z_rot = fused.symbol_rotation(rot_np, decim,
                                      cfg.ref_samples_per_symbol)

        if isinstance(self.fused, str) and self.fused not in (
                "s2d", "s2d_of", "fused"):
            # fail loudly: an unknown variant string must not silently
            # fall through to the legacy fused path and get
            # measured/labeled as the variant that never ran
            raise ValueError(
                f"unknown fused variant {self.fused!r}; valid: s2d, "
                "s2d_of, fused/True")
        if self.fused in ("s2d", "s2d_of"):
            # THREE dispatched programs (conv -> demod tail -> candidates)
            # so consecutive blocks can pipeline: steady-state throughput
            # is set by the slowest stage instead of the sum.  The
            # realpair tail is decision-identical on the valid region
            # (tests/unit/test_realpair.py).  "s2d_of" additionally folds
            # consecutive output positions into channels
            # (ops/fused.s2d_of_kernel) — same values, pinned by
            # tests/unit/test_fused_frontend.py.
            from tetraear_tpu.models.realpair import _demod_from_pair
            L = kernel.shape[-1]
            sps = cfg.ref_samples_per_symbol
            if self.fused == "s2d_of":
                c2 = kernel.shape[0]
                fold = max(1, min(8, 128 // c2))
                kernel_dev = jax.device_put(
                    fused.s2d_of_kernel(kernel, decim, fold))

                @jax.jit
                def conv_prog(x, kern):
                    return fused.fused_channelize_s2d_of_ri(
                        x, kern, gc, L, decim, fold)
            else:
                kernel_dev = jax.device_put(fused.s2d_kernel(kernel, decim))

                @jax.jit
                def conv_prog(x, kern):
                    return fused.fused_channelize_s2d_ri(x, kern, gc, L,
                                                         decim)

            @jax.jit
            def tail_prog(yr, yi):
                res = _demod_from_pair(yr.astype(jnp.float32),
                                       yi.astype(jnp.float32),
                                       sps, z_rot=z_rot)
                return res.bits, res.sync_corr, res.count

            def front(x, kern, start_index):
                yr, yi = conv_prog(x, kern)
                return tail_prog(yr, yi)
            return kernel_dev, front, conv_prog, tail_prog

        kernel_dev = jax.device_put(kernel)

        @jax.jit
        def front_legacy(x, kern, start_index):
            y = fused.fused_channelize(x, kern, gc, rot_np, decim,
                                       start_index, rotate=False)
            return _demod_front(y, cfg, z_rot=z_rot)
        return kernel_dev, front_legacy, None, None

    @functools.lru_cache(maxsize=8)
    def _compiled_fused(self, offs_key: tuple):
        kernel_dev, front, conv_prog, tail_prog = \
            self._fused_stages(offs_key)
        cand = _candidates_compiled(self.num_candidates, self.threshold)

        def run(x, start_index):
            bits, corr, count = front(x, kernel_dev, start_index)
            pos, ccorr, valid, frames, crc_ok = cand(bits, corr, count)
            return MulticarrierResult(bits, corr, count, pos, ccorr,
                                      valid, frames, crc_ok)
        if conv_prog is not None:
            run.stages = _stage_list(conv_prog, kernel_dev, tail_prog, cand)
        return run

    @functools.lru_cache(maxsize=8)
    def _compiled_fused_batch(self, offs_key: tuple):
        """Block-batched fused pipeline: x is (B, N) — B independent
        blocks per DISPATCH through every stage (conv, demod tail,
        candidates), so the per-program dispatch cost is paid once per
        B blocks; stage outputs equal the per-block pipeline's, stacked
        (tests/unit/test_fused_frontend).
        """
        kernel_dev, front, conv_prog, tail_prog = \
            self._fused_stages(offs_key)
        cand = _candidates_compiled(self.num_candidates, self.threshold)

        if conv_prog is not None:
            # split-dispatch variants: vmap each stage program; the
            # batched conv lowers to one conv with a real batch dim
            bconv = jax.jit(jax.vmap(conv_prog, in_axes=(0, None)))
            btail = jax.jit(jax.vmap(tail_prog))

            def runb(xb, start_index):
                yr, yi = bconv(xb, kernel_dev)
                bits, corr, count = btail(yr, yi)
                pos, ccorr, valid, frames, crc_ok = cand(bits, corr,
                                                         count)
                return MulticarrierResult(bits, corr, count, pos, ccorr,
                                          valid, frames, crc_ok)
            return runb

        bfront = jax.jit(jax.vmap(front, in_axes=(0, None, None)))

        def runb(xb, start_index):
            bits, corr, count = bfront(xb, kernel_dev, start_index)
            pos, ccorr, valid, frames, crc_ok = cand(bits, corr, count)
            return MulticarrierResult(bits, corr, count, pos, ccorr,
                                      valid, frames, crc_ok)
        return runb

    def batched(self, xb, offsets_hz, start_index: int = 0
                ) -> MulticarrierResult:
        """Process (B, N) independent blocks per dispatch (fused variants
        only); result fields carry a leading B axis."""
        if not self.fused:
            raise ValueError("batched() requires a fused variant")
        from tetraear_tpu.utils.backend import ensure_complex_on_device
        xb = ensure_complex_on_device(xb)
        offs_key = tuple(float(v) for v in np.asarray(offsets_hz))
        fn = self._compiled_fused_batch(offs_key)
        return fn(xb, jnp.int32(start_index))

    def __call__(self, x, offsets_hz, start_index: int = 0
                 ) -> MulticarrierResult:
        from tetraear_tpu.utils.backend import ensure_complex_on_device
        x = ensure_complex_on_device(x)
        if self.fused:
            offs_key = tuple(float(v) for v in np.asarray(offsets_hz))
            fn = self._compiled_fused(offs_key)
            return fn(x, jnp.int32(start_index))
        # no numpy round-trip: offsets may already live on device
        offsets = jnp.asarray(offsets_hz, jnp.float32)
        fn = self._compiled(x.shape[-1], offsets.shape[-1])
        return fn(x, offsets, jnp.int32(start_index))

    def __hash__(self):
        return hash((self.config, self.num_candidates, self.threshold,
                     self.fused))

    def __eq__(self, other):
        return (isinstance(other, MulticarrierFrontend)
                and (self.config, self.num_candidates, self.threshold,
                     self.fused)
                == (other.config, other.num_candidates, other.threshold,
                    other.fused))


class PfbMulticarrierFrontend:
    """Filterbank variant (PAPERS.md technique): ONE polyphase DFT
    filterbank channelizes the entire band — all fs/25kHz channels (96 at
    2.4 MS/s) — then the batched demod/sync/CRC stages run over every
    channel.  The prototype lowpass doubles as the channel filter, so the
    separate per-carrier FIR stage disappears.

    Compared to MulticarrierFrontend (DDC bank), this trades per-carrier
    flexibility (arbitrary offsets) for full-band coverage at lower FLOPs.
    """

    def __init__(self, config: ReceiverConfig | None = None,
                 num_candidates: int = 64, threshold: float = 0.80,
                 taps_per_branch: int = 8, fused: bool = False):
        self.config = config or ReceiverConfig()
        self.num_candidates = num_candidates
        self.threshold = threshold
        self.taps_per_branch = taps_per_branch
        # fused=True: same filterbank as ONE dense multi-channel conv
        # (ops/fused.pfb_kernel) instead of the gather-based polyphase
        # form (ops/pfb.py)
        self.fused = fused
        fs = self.config.sample_rate_hz
        self.num_channels = int(round(fs / 25e3))
        self.decim = self.config.decimation_factor

    def channel_offsets_hz(self) -> np.ndarray:
        from tetraear_tpu.ops import pfb
        return pfb.channel_offsets_hz(self.num_channels,
                                      self.config.sample_rate_hz)

    @functools.lru_cache(maxsize=4)
    def _compiled(self, n: int, batch: int = 0):
        """batch=0: x is (N,).  batch=B>0: x is (B, N) — B independent
        blocks per dispatch through every stage (same dispatch
        amortization as MulticarrierFrontend._compiled_fused_batch; the
        candidates stage is leading-dim agnostic so only the front is
        vmapped)."""
        cfg = self.config
        k, thr = self.num_candidates, self.threshold
        num_channels, decim, tpb = (self.num_channels, self.decim,
                                    self.taps_per_branch)

        cand = _candidates_compiled(k, thr)

        def _assemble(front_fn, already_batched: bool = False,
                      split: tuple | None = None):
            if batch and not already_batched:
                front_fn = jax.jit(jax.vmap(front_fn))

            def run(x):
                bits, corr, count = front_fn(x)
                pos, ccorr, valid, frames, crc_ok = cand(bits, corr,
                                                         count)
                return MulticarrierResult(bits, corr, count, pos, ccorr,
                                          valid, frames, crc_ok)
            if split is not None:
                run.stages = _stage_list(*split, cand)
            return run

        if self.fused:
            if isinstance(self.fused, str) and self.fused not in (
                    "s2d", "s2d_mono", "s2d_hb16"):
                # fail loudly: an unknown variant string must not silently
                # fall through to the legacy fused_channelize_ri path and
                # get measured/labeled as the variant that never ran
                raise ValueError(
                    f"unknown PFB fused variant {self.fused!r}; valid: "
                    "s2d, s2d_mono, s2d_hb16, True")
            from tetraear_tpu.ops import fused
            from tetraear_tpu.models.realpair import _demod_from_pair
            kernel, gc, rot = fused.pfb_kernel(
                num_channels, cfg.sample_rate_hz, taps_per_branch=tpb)
            rot_np = np.asarray(rot)
            sps = cfg.ref_samples_per_symbol
            z_rot = fused.symbol_rotation(rot_np, decim, sps)

            if self.fused == "s2d_hb16":
                # split-dispatch s2d with a HALF-PRECISION handoff: the
                # (2, 192, 832k) f32 channel pair between conv and tail
                # is 638 MB at bench scale, written then re-read across
                # the program boundary — shipping it bf16 halves that
                # traffic.  The tail's
                # |y|^2 timing sums and differential products recompute
                # in f32 from the bf16 symbols; decision parity on
                # burst fixtures is pinned by
                # tests/unit/test_fused_frontend.py (noise-marginal bits
                # MAY differ — this variant is opt-in until a verified
                # win AND clean parity on the conformance set).
                L = kernel.shape[-1]
                kernel_dev = jax.device_put(fused.s2d_kernel(kernel,
                                                             decim))

                @jax.jit
                def conv_prog_h(x, kern):
                    yr, yi = fused.fused_channelize_s2d_ri(x, kern, gc,
                                                           L, decim)
                    return (yr.astype(jnp.bfloat16),
                            yi.astype(jnp.bfloat16))

                @jax.jit
                def tail_prog_h(yr, yi):
                    res = _demod_from_pair(yr.astype(jnp.float32),
                                           yi.astype(jnp.float32),
                                           sps, z_rot=z_rot)
                    return res.bits, res.sync_corr, res.count

                if batch:
                    bconv_h = jax.jit(jax.vmap(conv_prog_h,
                                               in_axes=(0, None)))
                    btail_h = jax.jit(jax.vmap(tail_prog_h))

                    def front_h_b(x):
                        yr, yi = bconv_h(x, kernel_dev)
                        return btail_h(yr, yi)
                    return _assemble(front_h_b, already_batched=True)

                def front_h(x):
                    yr, yi = conv_prog_h(x, kernel_dev)
                    return tail_prog_h(yr, yi)
                return _assemble(front_h)

            if self.fused in ("s2d", "s2d_mono"):
                # the 16-carrier path's arrangement applied full-band:
                # (1) space-to-depth stride-1 conv (decimation folded
                #     into channels),
                # (2) conv and demod tail as TWO dispatched programs so
                #     consecutive blocks can pipeline.  "s2d_mono" keeps
                #     them in ONE program, which keeps the 638 MB
                #     channel-pair handoff inside one executable.
                L = kernel.shape[-1]
                kernel_dev = jax.device_put(fused.s2d_kernel(kernel,
                                                             decim))

                if self.fused == "s2d_mono":
                    @jax.jit
                    def front_mono(x, kern):
                        yr, yi = fused.fused_channelize_s2d_ri(
                            x, kern, gc, L, decim)
                        res = _demod_from_pair(yr, yi, sps, z_rot=z_rot)
                        return res.bits, res.sync_corr, res.count
                    if batch:
                        # kernel stays an ARGUMENT of the batched jit (a
                        # closure capture would constant-fold the device
                        # array through a D2H — CLAUDE.md)
                        bmono = jax.jit(jax.vmap(front_mono,
                                                 in_axes=(0, None)))
                        return _assemble(lambda x: bmono(x, kernel_dev),
                                         already_batched=True)
                    return _assemble(
                        lambda x: front_mono(x, kernel_dev))

                @jax.jit
                def conv_prog(x, kern):
                    return fused.fused_channelize_s2d_ri(x, kern, gc, L,
                                                         decim)

                @jax.jit
                def tail_prog(yr, yi):
                    res = _demod_from_pair(yr, yi, sps, z_rot=z_rot)
                    return res.bits, res.sync_corr, res.count

                if batch:
                    # per-stage vmap preserves the split-dispatch
                    # structure (a wholesale vmap+jit would fuse conv and
                    # tail into one program and change what is measured)
                    bconv = jax.jit(jax.vmap(conv_prog,
                                             in_axes=(0, None)))
                    btail = jax.jit(jax.vmap(tail_prog))

                    def front_s2d_b(x):
                        yr, yi = bconv(x, kernel_dev)
                        return btail(yr, yi)
                    return _assemble(front_s2d_b, already_batched=True)

                def front_s2d(x):
                    yr, yi = conv_prog(x, kernel_dev)
                    return tail_prog(yr, yi)
                return _assemble(front_s2d,
                                 split=(conv_prog, kernel_dev, tail_prog))

            kernel_dev = jax.device_put(kernel)

            @jax.jit
            def front_fused(x, kern):
                # real-pair tail: keeping re/im as f32 halves the demod's
                # memory traffic, and the gather-free realpair tail is
                # decision-identical (tests/unit/test_realpair.py).
                # rotate=False: derotation deferred to z as a per-channel
                # constant (ops/fused.symbol_rotation)
                yr, yi = fused.fused_channelize_ri(x, kern, gc, rot_np,
                                                   decim, start_index=0,
                                                   rotate=False)
                res = _demod_from_pair(yr, yi,
                                       cfg.ref_samples_per_symbol,
                                       z_rot=z_rot)
                return res.bits, res.sync_corr, res.count
            if batch:
                bfused = jax.jit(jax.vmap(front_fused, in_axes=(0, None)))
                return _assemble(lambda x: bfused(x, kernel_dev),
                                 already_batched=True)
            return _assemble(lambda x: front_fused(x, kernel_dev))

        @jax.jit
        def front(x):
            from tetraear_tpu.ops import pfb
            taps = pfb.design_prototype(num_channels, tpb)
            y = pfb.pfb_channelize(x, num_channels, decim, taps)
            return _demod_front(y, cfg)
        return _assemble(front)

    def __call__(self, x) -> MulticarrierResult:
        from tetraear_tpu.utils.backend import ensure_complex_on_device
        x = ensure_complex_on_device(x)
        return self._compiled(x.shape[-1])(x)

    def batched(self, xb) -> MulticarrierResult:
        """Process (B, N) independent blocks per dispatch; result fields
        carry a leading B axis."""
        from tetraear_tpu.utils.backend import ensure_complex_on_device
        xb = ensure_complex_on_device(xb)
        return self._compiled(int(xb.shape[-1]), int(xb.shape[0]))(xb)

    def __hash__(self):
        return hash((self.config, self.num_candidates, self.threshold,
                     self.taps_per_branch, self.fused))

    def __eq__(self, other):
        return (isinstance(other, PfbMulticarrierFrontend)
                and (self.config, self.num_candidates, self.threshold,
                     self.taps_per_branch, self.fused)
                == (other.config, other.num_candidates, other.threshold,
                    other.taps_per_branch, other.fused))


class MulticarrierDecoder:
    """Host decode over MulticarrierResult: one stateful TetraDecoder per
    carrier (fragmentation/network state is per-channel), fed from the
    device bit streams + dense sync scores (no host re-correlation)."""

    def __init__(self, num_carriers: int, auto_decrypt: bool = False):
        from tetraear_tpu.core.decoder import TetraDecoder
        self.decoders = [TetraDecoder(auto_decrypt=auto_decrypt)
                         for _ in range(num_carriers)]

    def decode(self, result: MulticarrierResult) -> list:
        """-> list of per-carrier frame lists; frames gain a 'carrier' key."""
        bits = np.asarray(result.bits)
        corr = np.asarray(result.sync_corr)
        counts = np.asarray(result.count)
        out = []
        for c, dec in enumerate(self.decoders):
            nsym = max(int(counts[c]) - 1, 0)
            nbits = 2 * nsym
            cbits = bits[c, :nbits]
            mapped = (cbits[0::2].astype(np.int64) << 1) | cbits[1::2]
            ncorr = max(0, nbits - 21)
            frames = dec.decode_frontend(cbits, mapped, corr[c, :ncorr])
            for f in frames:
                f["carrier"] = c
            out.append(frames)
        return out
