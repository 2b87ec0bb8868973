#!/usr/bin/env python3
"""Communication volume of the sharded receive steps, read out of the
compiled programs.

Method: lower + compile each sharded step on an 8-virtual-device mesh at
bench-scale per-shard shapes, then read every collective instruction
(collective-permute / all-reduce / all-gather / all-to-all) with its
exact operand bytes from the optimized HLO, and the per-device FLOP and
byte counts from XLA's cost analysis.  No hand estimates: if the program
had hidden communication, it would show here.  No time is modelled: how
long these bytes take over NVLink is a measurement for the cards.

Run: compile-only on any host (nothing executes); one JSON line per
(step, mesh) on stdout.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from collections import Counter
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402

_DTYPE_BYTES = {"f32": 4, "c64": 8, "s32": 4, "u8": 1, "pred": 1,
                "bf16": 2, "f64": 8, "s8": 1, "u32": 4}


def _shape_bytes(shape: str) -> int:
    m = re.match(r"([a-z0-9]+)\[([0-9,]*)\]", shape)
    if not m:
        return 0
    dt, dims = m.groups()
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * _DTYPE_BYTES.get(dt, 4)


def _collectives(hlo_text: str) -> list[dict]:
    out = []
    for shape, kind in re.findall(
            r"= (\S+) (collective-permute|all-reduce|all-gather|"
            r"all-to-all)\(", hlo_text):
        out.append({"kind": kind, "shape": shape,
                    "bytes": _shape_bytes(shape)})
    return out


def analyze(carrier: int, time_: int, variant: str, scale: int) -> dict:
    import jax
    from tetraear_tpu.config import ReceiverConfig
    from tetraear_tpu.parallel.mesh import make_mesh
    from tetraear_tpu.parallel import sharded as sh

    cfg = ReceiverConfig()
    step = cfg.decimation_factor * cfg.ref_samples_per_symbol
    n_dev = carrier * time_
    mesh = make_mesh(carrier=carrier, time=time_,
                     devices=jax.devices()[:n_dev])
    # grid-aligned (multiples of 25 kHz): the realpair periodic mixer
    # requires it, and it matches the bench carrier set
    offsets = ((np.arange(carrier) - carrier // 2) * 25e3
               ).astype(np.float32)

    t_local = scale * 1040 * step            # per-shard (weak scaling)
    x = np.zeros(time_ * t_local, np.complex64)

    if variant == "fused":
        run = sh.build_sharded_step_fused(mesh, offsets, cfg,
                                          halo=132 * step)
        xs, _ = sh.shard_inputs(mesh, x, offsets)
        lowered = jax.jit(run).lower(xs)
    elif variant == "realpair":
        run, halo = sh.build_sharded_step_realpair(mesh, cfg)
        import math
        lcm = step * 96 // math.gcd(step, 96)
        t_rp = -(-t_local // lcm) * lcm
        xr = np.zeros(time_ * t_rp, np.complex64)
        xs, table = sh.realpair_shard_inputs(mesh, xr, offsets, halo,
                                             cfg.sample_rate_hz)
        lowered = jax.jit(run).lower(xs, table)
        t_local = t_rp
    elif variant == "etsi":
        align = cfg.decimation_factor * 10 * cfg.etsi_sps
        t_e = -(-t_local // align) * align
        xe = np.zeros(time_ * t_e, np.complex64)
        run, _ = sh.build_sharded_step_etsi(mesh, cfg, halo=2 * align)
        xs, offs = sh.shard_inputs(mesh, xe, offsets)
        lowered = jax.jit(run).lower(xs, offs)
        t_local = t_e
    else:
        raise ValueError(variant)

    comp = lowered.compile()
    colls = _collectives(comp.as_text())
    ca = comp.cost_analysis()
    if isinstance(ca, list):
        ca = ca[0]
    flops = float(ca.get("flops", 0.0)) if ca else 0.0
    hbm = float(ca.get("bytes accessed", 0.0)) if ca else 0.0

    permute_bytes = sum(c["bytes"] for c in colls
                        if c["kind"] == "collective-permute")
    reduce_bytes = sum(c["bytes"] for c in colls
                       if c["kind"] == "all-reduce")
    other_bytes = sum(c["bytes"] for c in colls
                      if c["kind"] in ("all-gather", "all-to-all"))
    return {
        "variant": variant, "mesh": f"{carrier}x{time_}",
        "per_shard_samples": int(t_local),
        "collectives": dict(Counter(
            f'{c["kind"]} {c["shape"]}' for c in colls)),
        "permute_bytes": permute_bytes,
        "allreduce_bytes": reduce_bytes,
        "other_collective_bytes": other_bytes,
        "flops_per_device": flops,
        "hbm_bytes_per_device": hbm,
        "collective_bytes_per_input_byte":
            (permute_bytes + reduce_bytes + other_bytes)
            / max(8.0 * t_local, 1.0),
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=8,
                    help="per-shard block scale (8 = bench scale)")
    args = ap.parse_args()

    import os
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    import jax
    jax.config.update("jax_platforms", "cpu")

    for carrier, time_ in ((8, 1), (4, 2), (2, 4), (1, 8)):
        for variant in ("fused", "realpair", "etsi"):
            try:
                row = analyze(carrier, time_, variant, args.scale)
            except Exception as e:                     # pragma: no cover
                row = {"variant": variant, "mesh": f"{carrier}x{time_}",
                       "error": f"{type(e).__name__}: {e}"}
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
