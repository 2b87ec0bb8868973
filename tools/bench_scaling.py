#!/usr/bin/env python3
"""Scaling-efficiency benchmark for the sharded receive step (BASELINE
config 5 methodology: >=0.9 efficiency from 1 chip to N hosts).

Runs the full sharded pipeline on meshes of growing size with constant
per-device work (weak scaling) and reports samples/s plus efficiency
relative to the single-device rate.  On this machine real multi-chip
hardware is unavailable: `--virtual N` uses N virtual CPU devices, which
validates the sharding/collective program end to end but measures *host*
arithmetic — treat those efficiency numbers as correctness smoke only.
On the GPUs of one host, invoke without --virtual; across hosts, run one
process per host (tetraear_tpu.parallel.distributed).

Every timed window ends in block_until_ready.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--virtual", type=int, default=0,
                    help="force N virtual CPU devices (correctness mode)")
    ap.add_argument("--per-device-samples", type=int, default=1040 * 130)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--profile", choices=["ref", "etsi"], default="ref",
                    help="ref = ref-compat sharded step; etsi = the "
                         "rational-resampler soft-demod pod step "
                         "(build_sharded_step_etsi)")
    ap.add_argument("--overhead", action="store_true",
                    help="also time the SAME total workload on a 1-device "
                         "mesh and report sharding overhead efficiency "
                         "T_unsharded/T_sharded.  On shared-core virtual "
                         "devices this is the honest scaling measurement: "
                         "naive weak-scaling wall-clock is bounded by "
                         "cores/devices regardless of the program, while "
                         "this ratio isolates what sharding itself costs "
                         "(halos, collectives, padding).")
    args = ap.parse_args()

    import os
    if args.virtual:
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count="
                        f"{args.virtual}").strip()
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax

    from tetraear_tpu.config import ReceiverConfig
    from tetraear_tpu.parallel.mesh import make_mesh
    from tetraear_tpu.parallel.sharded import (build_sharded_step,
                                               build_sharded_step_etsi,
                                               shard_inputs)

    cfg = ReceiverConfig()
    devices = jax.devices()
    n_dev = len(devices)
    print(f"# backend={jax.default_backend()} devices={n_dev}")

    rng = np.random.default_rng(0)
    results = {}
    sizes = [s for s in (1, 2, 4, 8, 16, 32) if s <= n_dev]
    for n in sizes:
        time_axis = 1 if n == 1 else 2
        carrier_axis = n // time_axis
        mesh = make_mesh(carrier=carrier_axis, time=time_axis,
                         devices=devices[:n])
        t_local = args.per_device_samples
        if args.profile == "etsi":
            align = cfg.decimation_factor * 10 * cfg.etsi_sps     # 400
            t_local = max(align, (t_local // align) * align)
        total = time_axis * t_local
        x = (rng.standard_normal(total) + 1j * rng.standard_normal(total)
             ).astype(np.complex64) * 0.1
        offsets = ((np.arange(carrier_axis) * 25e3) - 25e3 * carrier_axis / 2
                   ).astype(np.float32)
        if args.profile == "etsi":
            run, _halo = build_sharded_step_etsi(mesh, cfg, halo=4 * 400)
        else:
            run = build_sharded_step(mesh, cfg, halo=132 * 130)
        xs, offs = shard_inputs(mesh, x, offsets)

        def step():
            return run(xs, offs)

        def timed(step_fn):
            jax.block_until_ready(step_fn())             # compile + warm
            t0 = time.perf_counter()
            for _i in range(args.iters):
                out = step_fn()
            jax.block_until_ready(out)
            return (time.perf_counter() - t0) / args.iters

        dt = timed(step)
        sps = total * carrier_axis / dt            # carrier-stream samples/s
        results[n] = sps
        base = results[sizes[0]] * n / sizes[0]
        eff = sps / base if base else 0.0
        rec = {"devices": n, "mesh": [carrier_axis, time_axis],
               "samples_per_sec": round(sps, 1),
               "weak_scaling_efficiency": round(eff, 3)}
        if args.overhead and n > 1:
            # same total workload (same x, same offsets, same program
            # family) on a single device: the ratio strips the shared-core
            # oversubscription that dominates virtual-device wall clock
            mesh1 = make_mesh(carrier=1, time=1, devices=devices[:1])
            if args.profile == "etsi":
                run1, _h = build_sharded_step_etsi(mesh1, cfg, halo=4 * 400)
            else:
                run1 = build_sharded_step(mesh1, cfg, halo=132 * 130)
            xs1, offs1 = shard_inputs(mesh1, x, offsets)
            dt1 = timed(lambda: run1(xs1, offs1))
            rec["sharding_overhead_efficiency"] = round(dt1 / dt, 3)
        print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
