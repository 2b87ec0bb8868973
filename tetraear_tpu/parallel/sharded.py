"""Pod-scale sharded receive step (BASELINE config 5).

The full multi-carrier pipeline under `shard_map` over a (carrier, time)
mesh:

* wideband IQ is sharded along `time` (replicated over `carrier`);
* carrier offsets are sharded along `carrier`;
* each shard extends its block with overlap-save halos exchanged via
  `ppermute` (parallel/halo.py), so filtering/timing/demod on the shard
  interior is *identical* to the unsharded program;
* per-carrier symbol-timing metrics are `psum`-ed over the time axis so
  every time shard picks the same (global) sampling phase — the reference's
  whole-block argmax (processor.py:186-215) done as a collective;
* the differential demod's previous-symbol state crosses shard boundaries
  with a single-element ppermute carry (processor.py:131 state, SURVEY §5.7);
* outputs come back sharded: each time shard emits its extended bit/score
  segment; the host (or a later device stage) stitches by dropping halo
  overlap.

Shard-size contract: the local block length T and halo H must be multiples
of decim*sps (130 at reference rates) so the decimation grid and symbol
phase grid stay globally aligned across shards.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tetraear_tpu.config import ReceiverConfig
from tetraear_tpu.ops import channelizer, dqpsk, fir, sync
from tetraear_tpu.parallel.halo import extend_with_halo, carry_last
from tetraear_tpu.parallel.mesh import CARRIER_AXIS, TIME_AXIS


class ShardedResult(NamedTuple):
    bits: jnp.ndarray        # (C, n_time, B_ext) uint8 — extended segments
    sync_corr: jnp.ndarray   # (C, n_time, B_ext-21) float32
    best_phase: jnp.ndarray  # (C, n_time) int32 (same value on every shard)


def _shard_step(x_local: jnp.ndarray, offsets_local: jnp.ndarray,
                cfg: ReceiverConfig, halo: int):
    """Runs on one device: (T,) local wideband + (C_local,) offsets."""
    decim = cfg.decimation_factor
    sps = cfg.ref_samples_per_symbol
    t_local = x_local.shape[-1]
    assert t_local % (decim * sps) == 0 and halo % (decim * sps) == 0

    taps_d = jnp.asarray(fir.design_decimation_fir(
        decim, cfg.decim_fir_taps_per_phase))
    cutoff = (cfg.channel_bandwidth_hz / 2) / (cfg.intermediate_rate_hz / 2)
    taps_c = jnp.asarray(fir.design_channel_fir(cfg.channel_fir_taps, cutoff))

    # --- overlap-save: pull neighbour samples, keep mixer phase global ----
    ext = extend_with_halo(x_local, halo, halo, TIME_AXIS)     # (T+2H,)
    t_idx = lax.axis_index(TIME_AXIS)
    global_start = t_idx.astype(jnp.int32) * t_local - halo

    y = channelizer.channelize(ext, offsets_local, cfg.sample_rate_hz,
                               decim, taps=taps_d, start_index=global_start)
    y = fir.fir_filter_same(y, taps_c)                          # (Cl, (T+2H)/D)
    return _shard_demod_tail(y, cfg, halo, t_local)


def _shard_step_fused(x_local: jnp.ndarray, kern_local: jnp.ndarray,
                      rot_local: jnp.ndarray, cfg: ReceiverConfig,
                      halo: int, gc: int):
    """Fused-conv variant of _shard_step: the per-carrier modulated
    composite kernels (ops/fused.py) arrive sharded over the carrier
    axis as (C_local, 2, 2, L); the residual rotation uses the traced
    per-carrier cycle counts with global phase (same f32 precision class
    as the staged mixer's global-start oscillator)."""
    decim = cfg.decimation_factor
    sps = cfg.ref_samples_per_symbol
    t_local = x_local.shape[-1]
    assert t_local % (decim * sps) == 0 and halo % (decim * sps) == 0

    ext = extend_with_halo(x_local, halo, halo, TIME_AXIS)     # (T+2H,)
    t_idx = lax.axis_index(TIME_AXIS)
    global_start = (t_idx.astype(jnp.int32) * t_local - halo)

    c_local, _, _, L = kern_local.shape
    # block-order the local output channels [re_0..re_Cl, im_0..im_Cl] so
    # the split below is two contiguous slices (matches ops/fused.py)
    kernel = jnp.concatenate([kern_local[:, 0], kern_local[:, 1]], axis=0)
    n = ext.shape[-1]
    m_out = n // decim
    xri = jnp.stack([jnp.real(ext), jnp.imag(ext)])[None]
    pad_l = L - 1 - gc
    pad_r = max(0, (m_out - 1) * decim + gc + 1 - n)
    out = lax.conv_general_dilated(
        xri, kernel, (decim,), ((pad_l, pad_r),),
        dimension_numbers=("NCW", "OIW", "NCW"),
        precision=lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32)[0]                 # (2Cl, M)
    yr, yi = out[:c_local], out[c_local:]
    # deferred derotation (ops/fused.symbol_rotation rationale): |y|^2
    # timing is rotation-invariant and symbols spaced sps channel samples
    # apart see the residual rotation as ONE constant per carrier on z —
    # so the (Cl, M) cos/sin stage disappears; global_start drops out of
    # the differential entirely (phase differences only)
    d = rot_local * jnp.float32(decim * sps)
    d = 2.0 * jnp.pi * (d - jnp.round(d))
    y = lax.complex(yr, yi)
    return _shard_demod_tail(y, cfg, halo, t_local,
                             z_rot=(jnp.cos(d), jnp.sin(d)))


def _shard_demod_tail(y: jnp.ndarray, cfg: ReceiverConfig, halo: int,
                      t_local: int, z_rot: tuple | None = None):
    decim = cfg.decimation_factor
    sps = cfg.ref_samples_per_symbol
    # --- global best-phase: psum per-carrier phase power over time --------
    h_dec = halo // decim
    interior = y[:, h_dec:h_dec + t_local // decim]
    m_int = interior.shape[-1] // sps
    grid = interior[:, :m_int * sps].reshape(interior.shape[0], m_int, sps)
    phase_power = jnp.sum(jnp.abs(grid) ** 2, axis=1)           # (Cl, sps)
    phase_power = lax.psum(phase_power, TIME_AXIS)
    best = jnp.argmax(phase_power, axis=-1).astype(jnp.int32)   # (Cl,)

    # --- extract symbols on the global grid over the extended block ------
    ext_dec_len = y.shape[-1]
    m_ext = ext_dec_len // sps - 1
    idx = best[:, None] + jnp.arange(m_ext, dtype=jnp.int32)[None, :] * sps
    symbols = jnp.take_along_axis(y, idx, axis=-1)              # (Cl, M_ext)

    # --- differential demod with cross-shard previous-symbol carry -------
    # halo regions already overlap neighbours, so the extended segment's
    # first symbol has in-block context except on the stream's first shard;
    # carry_last additionally wires exact symbol state for pipeline modes.
    prev = carry_last(symbols, TIME_AXIS)                       # (Cl,)
    seeded = jnp.concatenate([prev[:, None], symbols], axis=-1)
    if z_rot is None:
        hard_all = dqpsk.demodulate_hard(seeded, profile="ref")  # (Cl, M_ext)
    else:
        # deferred derotation: constant per-carrier phase on z (see
        # _shard_step_fused); zero-seed z quantizes to bin 0 as the
        # atan2 path did (matches models/multicarrier._demod_front)
        z = seeded[:, 1:] * jnp.conj(seeded[:, :-1])
        z = z * lax.complex(z_rot[0], -z_rot[1])[:, None]
        zr, zi = jnp.real(z), jnp.imag(z)
        hard_all = dqpsk.quantize_z_ref(zr, zi)
        hard_all = jnp.where((zr == 0) & (zi == 0), jnp.uint8(0),
                             hard_all)
    hard = hard_all[:, 1:]                                      # drop seed diff
    bits = dqpsk.symbols_to_bits(hard)                          # (Cl, 2*(M_ext-1))
    corr = sync.best_correlation(bits)

    return (bits[:, None, :], corr[:, None, :],
            jnp.broadcast_to(best[:, None], (best.shape[0], 1)))


def _shard_step_realpair(x_ri: jnp.ndarray, table: jnp.ndarray,
                         cfg: ReceiverConfig, halo: int):
    """Complex/transcendental-free shard step (models/realpair.py rationale
    at pod scale): (2, T) local real-pair wideband + (2, C_local, P) mixer
    table pre-rolled for the halo (see build_sharded_step_realpair).

    Shard contract: T and halo must be multiples of BOTH decim*sps (demod
    grid) and the mixer period P = fs/spacing (96 at 2.4 MS/s / 25 kHz), so
    the extended block's global phase offset (-halo mod P) is identical on
    every shard and one table serves all of them.
    """
    decim = cfg.decimation_factor
    sps = cfg.ref_samples_per_symbol
    t_local = x_ri.shape[-1]
    period = table.shape[-1]
    assert t_local % (decim * sps) == 0 and halo % (decim * sps) == 0
    assert t_local % period == 0 and halo % period == 0

    taps_d = jnp.asarray(fir.design_decimation_fir(
        decim, cfg.decim_fir_taps_per_phase))
    cutoff = (cfg.channel_bandwidth_hz / 2) / (cfg.intermediate_rate_hz / 2)
    taps_c = jnp.asarray(fir.design_channel_fir(cfg.channel_fir_taps, cutoff))

    ext = extend_with_halo(x_ri, halo, halo, TIME_AXIS)      # (2, T+2H)
    n_ext = t_local + 2 * halo

    # --- mix via the shard-invariant periodic table -----------------------
    xt = ext.reshape(2, 1, n_ext // period, period)
    oc = table[0][None, :, None, :]
    osn = table[1][None, :, None, :]
    xr, xi = xt[0:1], xt[1:2]
    mr = (xr * oc - xi * osn)[0].reshape(-1, n_ext)          # (Cl, T+2H)
    mi = (xr * osn + xi * oc)[0].reshape(-1, n_ext)

    # --- FIRs (same alignment as models/realpair._realpair_block) ---------
    from tetraear_tpu.ops.fir import _conv1d_real
    g1 = (taps_d.shape[0] - 1) // 2
    yr = _conv1d_real(mr, taps_d, decim, (g1, g1))
    yi = _conv1d_real(mi, taps_d, decim, (g1, g1))
    g2 = (taps_c.shape[0] - 1) // 2
    yr = _conv1d_real(yr, taps_c, 1, (g2, g2))
    yi = _conv1d_real(yi, taps_c, 1, (g2, g2))               # (Cl, (T+2H)/D)

    # --- global best-phase: psum'd interior power (gather-free) -----------
    h_dec = halo // decim
    int_r = yr[:, h_dec:h_dec + t_local // decim]
    int_i = yi[:, h_dec:h_dec + t_local // decim]
    m_int = int_r.shape[-1] // sps
    pw = (int_r[:, :m_int * sps] ** 2 + int_i[:, :m_int * sps] ** 2)
    phase_power = pw.reshape(pw.shape[0], m_int, sps).sum(axis=1)
    phase_power = lax.psum(phase_power, TIME_AXIS)
    best = jnp.argmax(phase_power, axis=-1).astype(jnp.int32)   # (Cl,)

    # --- symbols on the global grid: exact pick at the best phase ---------
    ext_dec_len = yr.shape[-1]
    m_ext = ext_dec_len // sps - 1
    fr = jnp.stack([yr[:, p:p + m_ext * sps:sps] for p in range(sps)],
                   axis=-1)                                  # (Cl, M_ext, sps)
    fi = jnp.stack([yi[:, p:p + m_ext * sps:sps] for p in range(sps)],
                   axis=-1)
    pick = best[:, None, None]
    sym_r = jnp.take_along_axis(fr, pick, axis=-1)[..., 0]
    sym_i = jnp.take_along_axis(fi, pick, axis=-1)[..., 0]

    # --- differential demod with cross-shard carry ------------------------
    prev_r = carry_last(sym_r, TIME_AXIS)
    prev_i = carry_last(sym_i, TIME_AXIS)
    sr = jnp.concatenate([prev_r[:, None], sym_r], axis=-1)
    si = jnp.concatenate([prev_i[:, None], sym_i], axis=-1)
    zr = sr[:, 1:] * sr[:, :-1] + si[:, 1:] * si[:, :-1]
    zi = si[:, 1:] * sr[:, :-1] - sr[:, 1:] * si[:, :-1]
    hard = dqpsk.quantize_z_ref(zr, zi)[:, 1:]               # drop seed diff
    bits = dqpsk.symbols_to_bits(hard)
    corr = sync.best_correlation(bits)

    return (bits[:, None, :], corr[:, None, :],
            jnp.broadcast_to(best[:, None], (best.shape[0], 1)))


def build_sharded_step(mesh: Mesh, cfg: ReceiverConfig | None = None,
                       halo: int | None = None):
    """Compile the full sharded receive step for `mesh`.

    Returns fn(x, offsets) with x: (T_total,) complex64 (T_total divisible
    by n_time * decim * sps) and offsets: (C,) float32 (C divisible by
    n_carrier).
    """
    cfg = cfg or ReceiverConfig()
    step = cfg.decimation_factor * cfg.ref_samples_per_symbol
    if halo is None:
        # cover both FIR group delays + ~128 symbols of sync/frame span
        halo = 132 * step
    assert halo % step == 0

    fn = jax.shard_map(
        functools.partial(_shard_step, cfg=cfg, halo=halo),
        mesh=mesh,
        in_specs=(P(TIME_AXIS), P(CARRIER_AXIS)),
        out_specs=(P(CARRIER_AXIS, TIME_AXIS, None),
                   P(CARRIER_AXIS, TIME_AXIS, None),
                   P(CARRIER_AXIS, TIME_AXIS)),
        check_vma=False,
    )

    @jax.jit
    def run(x, offsets):
        return ShardedResult(*fn(x, offsets))

    return run


def build_sharded_step_fused(mesh: Mesh, offsets_hz,
                             cfg: ReceiverConfig | None = None,
                             halo: int | None = None):
    """Fused-conv pod step: the composite-kernel conv per carrier
    (ops/fused.py), sharded over the carrier axis; interiors equal the
    staged build_sharded_step (pinned by tests/unit/test_parallel.py).
    Offsets must be concrete (the kernels are host-built).

    Returns fn(x) with x: (T_total,) complex64."""
    from tetraear_tpu.ops import fused as fused_ops

    cfg = cfg or ReceiverConfig()
    step = cfg.decimation_factor * cfg.ref_samples_per_symbol
    if halo is None:
        halo = 132 * step
    assert halo % step == 0

    offs = np.asarray(offsets_hz, np.float64)
    cutoff = (cfg.channel_bandwidth_hz / 2) / (cfg.intermediate_rate_hz / 2)
    kernel, gc, rot = fused_ops.fused_kernel(
        offs, cfg.sample_rate_hz, cfg.decimation_factor,
        cfg.decim_fir_taps_per_phase, cfg.channel_fir_taps, cutoff)
    # block-ordered (2C, 2, L) -> (C, 2, 2, L) so the carrier axis is
    # shardable: kern4[c, 0/1] = the re/im output row of carrier c
    c = len(offs)
    kern_np = np.asarray(kernel)
    kern4 = np.stack([kern_np[:c], kern_np[c:]], axis=1)
    kern_dev = jax.device_put(jnp.asarray(kern4),
                              NamedSharding(mesh, P(CARRIER_AXIS)))
    rot_dev = jax.device_put(jnp.asarray(rot, jnp.float32),
                             NamedSharding(mesh, P(CARRIER_AXIS)))

    fn = jax.shard_map(
        functools.partial(_shard_step_fused, cfg=cfg, halo=halo, gc=gc),
        mesh=mesh,
        in_specs=(P(TIME_AXIS), P(CARRIER_AXIS), P(CARRIER_AXIS)),
        out_specs=(P(CARRIER_AXIS, TIME_AXIS, None),
                   P(CARRIER_AXIS, TIME_AXIS, None),
                   P(CARRIER_AXIS, TIME_AXIS)),
        check_vma=False,
    )

    @jax.jit
    def run_inner(x, kern, rot_a):
        return ShardedResult(*fn(x, kern, rot_a))

    def run(x):
        return run_inner(x, kern_dev, rot_dev)

    return run


class ShardedEtsiResult(NamedTuple):
    soft_bits: jnp.ndarray   # (C, n_time, 2*(M_ext-1)) float32 LLR stream
    best_phase: jnp.ndarray  # (C, n_time) int32 (same on every time shard)


def _shard_step_etsi(x_local: jnp.ndarray, offsets_local: jnp.ndarray,
                     cfg: ReceiverConfig, halo: int):
    """etsi-profile shard step: channelize -> rational resample (x3/10,
    RRC) to the true 4-samples/symbol 18 kHz grid -> psum'd global symbol
    timing -> soft demod with cross-shard differential carry.

    Shard contract: T_local and halo must be multiples of
    decim * 10 * sps (= 400 at reference rates): divisibility by
    decim*10 keeps the polyphase resampler's output grid globally
    aligned (3/10 of the 240 kHz index stays integer), the extra *sps
    keeps the 4-phase symbol grid shard-invariant.
    """
    from tetraear_tpu.ops import resample
    decim = cfg.decimation_factor
    sps = cfg.etsi_sps
    align = decim * 10 * sps
    t_local = x_local.shape[-1]
    assert t_local % align == 0 and halo % align == 0, (t_local, halo, align)

    taps_d = jnp.asarray(fir.design_decimation_fir(
        decim, cfg.decim_fir_taps_per_phase))
    taps_r = resample.design_rrc_resampler(3, 10, sps, cfg.rrc_alpha,
                                           cfg.rrc_span_symbols)

    ext = extend_with_halo(x_local, halo, halo, TIME_AXIS)      # (T+2H,)
    t_idx = lax.axis_index(TIME_AXIS)
    global_start = t_idx.astype(jnp.int32) * t_local - halo

    y = channelizer.channelize(ext, offsets_local, cfg.sample_rate_hz,
                               decim, taps=taps_d, start_index=global_start)
    z = resample.rational_resample(y, 3, 10, taps_r)            # 72 kHz

    # global best-phase over the 4 sampling phases (interior only)
    h_out = (halo // decim) * 3 // 10
    t_out = (t_local // decim) * 3 // 10
    interior = z[:, h_out:h_out + t_out]
    m_int = t_out // sps
    grid = interior[:, :m_int * sps].reshape(interior.shape[0], m_int, sps)
    phase_power = jnp.sum(jnp.abs(grid) ** 2, axis=1)
    phase_power = lax.psum(phase_power, TIME_AXIS)
    best = jnp.argmax(phase_power, axis=-1).astype(jnp.int32)   # (Cl,)

    m_ext = z.shape[-1] // sps - 1
    idx = best[:, None] + jnp.arange(m_ext, dtype=jnp.int32)[None, :] * sps
    symbols = jnp.take_along_axis(z, idx, axis=-1)              # (Cl, M_ext)

    # differential context comes from the halo overlap itself — the
    # extended segment's first symbol already has a predecessor in-block
    # for every owned symbol, so no cross-shard carry is needed here
    soft = dqpsk.demodulate_soft(symbols)                       # (Cl, M_ext-1, 2)
    llrs = soft.soft_bits
    flat = llrs.reshape(llrs.shape[0], -1)                      # (Cl, 2(M_ext-1))

    return (flat[:, None, :],
            jnp.broadcast_to(best[:, None], (best.shape[0], 1)))


def build_sharded_step_etsi(mesh: Mesh, cfg: ReceiverConfig | None = None,
                            halo: int | None = None):
    """Compile the etsi-profile sharded step (pod-scale downlink demod).

    Returns (fn, halo): fn(x, offsets) with x (T_total,) complex64,
    T_total / n_time and halo multiples of decim*10*sps (400).
    """
    import dataclasses
    cfg = cfg or ReceiverConfig()
    if cfg.profile != "etsi":
        cfg = dataclasses.replace(cfg, profile="etsi")
    align = cfg.decimation_factor * 10 * cfg.etsi_sps
    if halo is None:
        # FIR + RRC group delay plus >= 128 symbols of burst context
        halo = -(-(132 * cfg.decimation_factor
                   * cfg.ref_samples_per_symbol) // align) * align
    assert halo % align == 0

    fn = jax.shard_map(
        functools.partial(_shard_step_etsi, cfg=cfg, halo=halo),
        mesh=mesh,
        in_specs=(P(TIME_AXIS), P(CARRIER_AXIS)),
        out_specs=(P(CARRIER_AXIS, TIME_AXIS, None),
                   P(CARRIER_AXIS, TIME_AXIS)),
        check_vma=False,
    )

    @jax.jit
    def run(x, offsets):
        return ShardedEtsiResult(*fn(x, offsets))

    return run, halo


class ShardedDownlinkReceiver:
    """Pod-scale ETSI downlink: the sharded demod step plus host stitching
    of per-shard soft-bit segments into one global LLR stream per carrier,
    then the blind cell-acquisition walk (models/downlink.py) on each.

    Stitching: each time shard owns symbols [H_sym, H_sym + T_sym) of its
    extended segment; their soft bits concatenate exactly-once into the
    global stream (guarded by test_parallel.py equivalence tests).
    """

    def __init__(self, mesh: Mesh, num_carriers: int,
                 cfg: ReceiverConfig | None = None,
                 halo: int | None = None,
                 traffic_channel: str = "TCH/S", traffic_depth: int = 1):
        from tetraear_tpu.models.downlink import DownlinkReceiver
        self.mesh = mesh
        self.cfg = cfg or ReceiverConfig()
        self.run, self.halo = build_sharded_step_etsi(mesh, self.cfg, halo)
        self.num_carriers = num_carriers
        self._cells = [DownlinkReceiver(None, traffic_channel, traffic_depth)
                       for _ in range(num_carriers)]

    def stitch(self, result: ShardedEtsiResult, t_local: int) -> np.ndarray:
        """(C, n_time, seg) -> (C, global_bits) owned-region concatenation."""
        decim = self.cfg.decimation_factor
        sps = self.cfg.etsi_sps
        h_sym = ((self.halo // decim) * 3 // 10) // sps
        own_sym = ((t_local // decim) * 3 // 10) // sps
        soft = np.asarray(result.soft_bits)
        c_total, n_time, seg = soft.shape
        lo = 2 * h_sym
        hi = lo + 2 * own_sym
        pieces = [soft[:, k, lo:hi] for k in range(n_time)]
        return np.concatenate(pieces, axis=-1)

    def receive(self, x, offsets) -> list:
        """Wideband (T_total,) + (C,) offsets -> per-carrier downlink
        frames (list of DownlinkFrame lists)."""
        x = np.asarray(x)
        n_time = self.mesh.shape[TIME_AXIS]
        t_local = x.shape[-1] // n_time
        xs, offs = shard_inputs(self.mesh, x, offsets)
        res = self.run(xs, offs)
        llrs = self.stitch(res, t_local)
        return [self._cells[c].receive_soft(llrs[c])
                for c in range(self.num_carriers)]


def build_sharded_step_realpair(mesh: Mesh, cfg: ReceiverConfig | None = None,
                                halo: int | None = None,
                                spacing_hz: float = 25e3):
    """Complex-free sharded receive step (backend-robust pod path).

    Returns fn(x_ri, table) with x_ri: (2, T_total) float32 and table:
    (2, C, P) from realpair_shard_inputs.  T_total / n_time and halo must
    be multiples of lcm(decim*sps, P) — 6240 at reference rates — so the
    periodic mixer stays globally phase-aligned on every shard.
    """
    cfg = cfg or ReceiverConfig()
    step = cfg.decimation_factor * cfg.ref_samples_per_symbol
    period = int(round(cfg.sample_rate_hz / spacing_hz))
    if halo is None:
        import math
        lcm = step * period // math.gcd(step, period)
        halo = -(-(132 * step) // lcm) * lcm        # >= complex default
    assert halo % step == 0 and halo % period == 0

    fn = jax.shard_map(
        functools.partial(_shard_step_realpair, cfg=cfg, halo=halo),
        mesh=mesh,
        in_specs=(P(None, TIME_AXIS), P(None, CARRIER_AXIS, None)),
        out_specs=(P(CARRIER_AXIS, TIME_AXIS, None),
                   P(CARRIER_AXIS, TIME_AXIS, None),
                   P(CARRIER_AXIS, TIME_AXIS)),
        check_vma=False,
    )

    @jax.jit
    def run(x_ri, table):
        return ShardedResult(*fn(x_ri, table))

    return run, halo


def realpair_shard_inputs(mesh: Mesh, x, offsets: np.ndarray, halo: int,
                          sample_rate_hz: float, spacing_hz: float = 25e3):
    """Real-pair inputs for build_sharded_step_realpair: (2, T) wideband +
    the mixer table rolled so index j corresponds to global sample j-halo
    (every shard's extended block starts at -halo mod P)."""
    from tetraear_tpu.models.realpair import mixer_table
    x = np.asarray(x)
    if np.iscomplexobj(x):
        x_ri = np.stack([x.real, x.imag]).astype(np.float32)
    else:
        x_ri = np.asarray(x, np.float32)
    base = mixer_table(np.asarray(offsets, np.float32), sample_rate_hz,
                       spacing_hz)
    period = base.shape[-1]
    table = np.roll(base, halo % period, axis=-1)
    xs = jax.device_put(jnp.asarray(x_ri),
                        NamedSharding(mesh, P(None, TIME_AXIS)))
    tb = jax.device_put(jnp.asarray(table),
                        NamedSharding(mesh, P(None, CARRIER_AXIS, None)))
    return xs, tb


class ShardedReceiver:
    """Pod-scale receive: the sharded device step plus host stitching of
    the per-shard extended segments into a global frame stream.

    Each time shard's output segment covers its interior plus halo context;
    stitching keeps frames whose sync hit lies in the shard's owned region
    (so every frame is emitted exactly once) and rebases frame numbers onto
    the global bit stream.  Fragmentation state flows through one stateful
    decoder per carrier, fed shards in time order.
    """

    def __init__(self, mesh: Mesh, cfg: ReceiverConfig | None = None,
                 halo: int | None = None, auto_decrypt: bool = False):
        self.mesh = mesh
        self.cfg = cfg or ReceiverConfig()
        step = self.cfg.decimation_factor * self.cfg.ref_samples_per_symbol
        self.halo = halo if halo is not None else 132 * step
        self.auto_decrypt = auto_decrypt
        self.run = build_sharded_step(mesh, self.cfg, self.halo)
        self._decoders = {}

    def __call__(self, x, offsets) -> ShardedResult:
        xs, offs = shard_inputs(self.mesh, x, offsets)
        return self.run(xs, offs)

    def decode(self, result: ShardedResult, t_local: int):
        """result + per-shard input length -> list (per carrier) of frames.

        t_local: wideband samples per time shard (T_total / n_time).
        """
        from tetraear_tpu.core.decoder import TetraDecoder

        decim = self.cfg.decimation_factor
        sps = self.cfg.ref_samples_per_symbol
        halo_syms = (self.halo // decim) // sps
        own_syms = (t_local // decim) // sps
        halo_bits = 2 * halo_syms
        own_bits = 2 * own_syms

        bits_all = np.asarray(result.bits)
        corr_all = np.asarray(result.sync_corr)
        c_total, n_time = bits_all.shape[0], bits_all.shape[1]
        out = []
        for c in range(c_total):
            dec = self._decoders.setdefault(
                c, TetraDecoder(auto_decrypt=self.auto_decrypt))
            frames_c = []
            for k in range(n_time):
                seg_bits = bits_all[c, k]
                mapped = ((seg_bits[0::2].astype(np.int64) << 1)
                          | seg_bits[1::2])
                frames = dec.decode_frontend(seg_bits, mapped, corr_all[c, k])
                base_bit = k * own_bits - halo_bits   # segment -> global
                for f in frames:
                    pos = f.get("sync_position")
                    if pos is None:
                        continue
                    # owned region is always [halo_bits, halo_bits+own_bits):
                    # positions below map to global < 0 on shard 0 (zero-fill
                    # artifacts), to the neighbour's region otherwise
                    hi = halo_bits + own_bits if k < n_time - 1 else 1 << 60
                    if not (halo_bits <= pos < hi):
                        continue
                    global_start = pos - 216 + base_bit
                    f["number"] = int(global_start // 510)
                    f["timeslot"] = f["number"] % 4
                    f["sync_position"] = int(pos + base_bit)
                    f["carrier"] = c
                    f["time_shard"] = k
                    frames_c.append(f)
            out.append(frames_c)
        return out


def shard_inputs(mesh: Mesh, x: np.ndarray, offsets: np.ndarray):
    """Device_put the inputs with the layout build_sharded_step expects."""
    xs = jax.device_put(jnp.asarray(x, jnp.complex64),
                        NamedSharding(mesh, P(TIME_AXIS)))
    offs = jax.device_put(jnp.asarray(offsets, jnp.float32),
                          NamedSharding(mesh, P(CARRIER_AXIS)))
    return xs, offs
