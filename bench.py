#!/usr/bin/env python3
"""Benchmark: wideband IQ samples/s through the multi-carrier demod+decode
device pipeline (BASELINE config 4: TETRA carriers channelized from one
wideband stream, demodulated, sync-correlated, CRC-checked on the device).

    python bench.py [--tiers fused_s2d,pfb,single] [--scale 8] [--iters 6]

Every tier runs in this one process on the GPU.  A tier is compiled and
warmed on its first block (reported as compile seconds), then `iters`
blocks are dispatched back to back and the window ends in
block_until_ready.  Each tier prints one JSON line naming the device it
ran on; the first tier's line is printed again last as the headline.
With no GPU the script exits non-zero and prints no result.

vs_baseline = samples_per_sec / 2.4e6: the reference's pure-Python chain
sustains at best ~2.4 MS/s (BASELINE.md "Realized throughput").
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

BASELINE_SPS = 2.4e6
TIERS = ("fused_s2d", "fused_s2d_of", "pfb", "realpair64", "single")
DEFAULT_TIERS = ("fused_s2d", "pfb", "single")


def _rate(step, inputs: list, n: int, iters: int) -> tuple:
    """(samples/s over `iters` steps, compile+first-step seconds)."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(step(inputs[0]))
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = None
    for i in range(iters):
        out = step(inputs[i % len(inputs)])
    jax.block_until_ready(out)
    return n * iters / (time.perf_counter() - t0), compile_s


def run_tier(tier: str, num_carriers: int = 16, scale: int = 8,
             iters: int = 6, symbols: int = 8000) -> dict:
    """Time one tier on JAX's default device; returns its record.  A
    block is `symbols` x `scale` symbols of 130 samples (the default is
    the 8,320,000-sample bench block)."""
    import jax
    import jax.numpy as jnp

    from tetraear_tpu.config import ReceiverConfig
    from tetraear_tpu.models.multicarrier import (MulticarrierFrontend,
                                                  PfbMulticarrierFrontend)
    from tetraear_tpu.models.realpair import RealPairFrontend, mixer_table

    cfg = ReceiverConfig()
    step = cfg.decimation_factor * cfg.ref_samples_per_symbol
    n = symbols * step * scale
    n = (n // 96) * 96                # mixer-table tiling contract
    rng = np.random.default_rng(0)
    # grid-aligned carrier set (multiples of 25 kHz) so the periodic-table
    # mixer of the real-pair tier applies
    offsets = ((np.arange(num_carriers) - num_carriers // 2) * 25e3
               ).astype(np.float32)
    xs_np = [(rng.standard_normal(n) + 1j * rng.standard_normal(n)
              ).astype(np.complex64) * 0.1 for _ in range(2)]

    carriers = num_carriers
    if tier in ("fused_s2d", "fused_s2d_of"):
        mc = MulticarrierFrontend(cfg, num_candidates=64, threshold=0.80,
                                  fused=tier.removeprefix("fused_"))
        fn = mc._compiled_fused(tuple(float(v) for v in offsets))
        xs = [jax.device_put(x) for x in xs_np]
        zero = jnp.int32(0)
        sps, compile_s = _rate(lambda x: fn(x, zero), xs, n, iters)
        variant = f"{tier}_demod_decode"
    elif tier == "pfb":
        # every 25 kHz channel of the 2.4 MHz capture, one dense conv
        pfb = PfbMulticarrierFrontend(cfg, num_candidates=64,
                                      threshold=0.80, fused="s2d")
        xs = [jax.device_put(x) for x in xs_np]
        sps, compile_s = _rate(pfb, xs, n, iters)
        variant, carriers = "pfb_demod_decode", pfb.num_channels
    elif tier == "realpair64":
        rp = RealPairFrontend(cfg, num_candidates=64, threshold=0.80)
        table = jax.device_put(jnp.asarray(
            mixer_table(offsets, cfg.sample_rate_hz)))
        fn = rp._compiled(n, num_carriers)
        xs = [jax.device_put(np.stack([x.real, x.imag]).astype(np.float32))
              for x in xs_np]
        sps, compile_s = _rate(lambda x: fn(x, table), xs, n, iters)
        variant = "demod_decode_realpair"
    elif tier == "single":
        # single-carrier Frontend on CLI-sized blocks — directly comparable
        # to the baseline (the reference is single-channel at 2.4 MS/s)
        from tetraear_tpu.models.receiver import Frontend
        fe = Frontend(cfg)
        n = min(2048, symbols) * step
        fn = fe._compiled(n, False)
        xs = [jax.device_put(x[:n]) for x in xs_np]
        zero = jnp.float32(0.0)
        sps, compile_s = _rate(lambda x: fn(x, zero), xs, n, iters * 4)
        variant, carriers = "singlecarrier_demod_sync", 1
    else:
        raise ValueError(f"unknown tier {tier!r}; valid: {TIERS}")
    dev = jax.devices()[0]
    scope = "" if carriers == 1 else f"{carriers}carrier_"
    return {"metric": f"iq_samples_per_sec_per_chip_{scope}{variant}",
            "value": round(sps, 1), "unit": "samples/s",
            "vs_baseline": round(sps / BASELINE_SPS, 2),
            "compile_s": round(compile_s, 3), "block_samples": n,
            "platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": len(jax.devices())}


def gpu_name_and_power() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of the card(s)."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except OSError as e:
        return f"nvidia-smi unavailable ({e})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tiers", type=str, default=",".join(DEFAULT_TIERS),
                    help=f"comma-separated subset of {TIERS}")
    ap.add_argument("--carriers", type=int, default=16)
    ap.add_argument("--scale", type=int, default=8,
                    help="block = 8000 symbols x 130 samples x scale")
    ap.add_argument("--iters", type=int, default=6)
    args = ap.parse_args(argv)
    tiers = [t.strip() for t in args.tiers.split(",") if t.strip()]
    bad = [t for t in tiers if t not in TIERS]
    if bad:
        ap.error(f"unknown tiers {bad}; valid: {TIERS}")

    import jax

    from tetraear_tpu.utils.backend import enable_compile_cache

    if jax.devices()[0].platform != "gpu":
        print(f"bench: no GPU (JAX's default backend is "
              f"{jax.devices()[0].platform})", file=sys.stderr)
        return 2
    enable_compile_cache()
    card = gpu_name_and_power()
    records = []
    for tier in tiers:
        rec = run_tier(tier, args.carriers, args.scale, args.iters)
        rec["tier"], rec["gpu"] = tier, card
        records.append(rec)
        print(json.dumps(rec), flush=True)
    print(json.dumps(records[0]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
