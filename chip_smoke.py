#!/usr/bin/env python3
"""Prove the TETRA receive path runs on the GPU, end to end, in one process.

    python chip_smoke.py                 # one GPU: every phase below
    python chip_smoke.py --gpus 4        # four GPUs: the sharded phase only

Phases (each prints one ``PHASE {...}`` JSON line; any failure exits
non-zero):

  kernels    the channelizer convs at the bench widths (16-carrier s2d and
             s2d_of, 96-channel PFB s2d), compiled for the card, timed, and
             compared with the float64 reference ops/fused.conv_reference.
  golden     ``decode --profile ref-exact`` on the four reference-golden
             fixtures, bit-exact against ``*.golden.jsonl``; ``decode``
             (ref-compat) on the same files, equal to a CPU decode.
  ddc16      ``decode --carriers 16`` on a seeded wideband capture of two
             8,320,000-sample blocks with golden frames planted on several
             carriers at different SNRs and tuning offsets: every planted
             frame recovered and bit-identical to a CPU decode of the file,
             the rest of the decode within the MAX_* bounds.
  pfb96      ``decode --carriers 96 --pfb`` on the same capture.
  downlink   ``downlink`` (etsi profile) on a ``tools/make_fixture.py
             --downlink`` capture, equal to a CPU decode.
  pytest     ``pytest -m gpu --device gpu`` in this process.
  sharded    (--gpus 4 only) the (carrier, time) sharded receive step on a
             (2, 2) mesh of four cards against the unsharded step on one.

Every phase reports the compile seconds and the steady seconds (timed with
block_until_ready) of the step programs it runs, their
``memory_analysis()``, and the device's peak_bytes_in_use.  The last line
of stdout is the one-line JSON result.  With no GPU the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
FIXTURES = REPO / "tests" / "conformance" / "fixtures"
GOLDEN_CASES = ("clean", "noisy_offset", "encrypted", "long_mixed")
BLOCK = 8_320_000          # bench.py's block: 64,000 symbols of 130 samples
FS = 2.4e6

# Precision of every device stage, as pinned in code.
PRECISION = {
    "channelizer convs (ops/fused, ops/fir, ops/resample, sharded)":
        "HIGHEST: f32 operands, no TF32",
    "PFB real-pair IDFT matmuls (ops/pfb)": "HIGHEST",
    "symbol pick at the best phase (realpair, sharded)":
        "take_along_axis: exact selection",
    "sync correlation conv (ops/sync)":
        "DEFAULT: +/-1 operands, exact at any precision",
    "CRC GF(2) einsum (ops/crc)": "int32: exact",
    "candidate windows (models/multicarrier one-hot)":
        "bf16 0/1 operands, f32 accumulation: exact",
    "FFTs (spectrum, resample, PFB gather form)": "f32 FFT",
}


# --------------------------------------------------------------------------
# measurement helpers
# --------------------------------------------------------------------------

def _memory(compiled) -> dict | None:
    ma = compiled.memory_analysis()
    if ma is None:
        return None
    return {k: int(getattr(ma, k)) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")}


def run_stages(stages: list, x, device) -> tuple:
    """Compile each (name, jitted, extra_args) stage on `device` for the
    inputs it will see, time one steady call of each (best of three, each
    ended by block_until_ready), and return (outputs of every stage,
    per-stage stats).  Each stage is called with the previous stage's
    outputs followed by its extra args; the first with `x`."""
    import jax

    stats, outs = [], []
    args = (jax.device_put(x, device),)
    for name, fn, extra in stages:
        full = args + tuple(jax.device_put(e, device) for e in extra)
        t0 = time.perf_counter()
        compiled = fn.lower(*full).compile()
        compile_s = time.perf_counter() - t0
        jax.block_until_ready(compiled(*full))
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            out = jax.block_until_ready(compiled(*full))
            best = min(best, time.perf_counter() - t0)
        stats.append({"stage": name, "compile_s": compile_s,
                      "steady_s": best, "memory": _memory(compiled)})
        args = tuple(out) if isinstance(out, (tuple, list)) else (out,)
        outs.append(args)
    return outs, stats


def peak_bytes(device) -> int | None:
    ms = device.memory_stats()
    return None if ms is None else int(ms.get("peak_bytes_in_use", 0))


def _cli(argv: list) -> float:
    """tetraear_tpu.ui.cli.main in this process; returns wall seconds."""
    from tetraear_tpu.ui.cli import main

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        rc = main(argv)
    if rc != 0:
        raise RuntimeError(f"cli {argv[0]} exited {rc}")
    return time.perf_counter() - t0


def _rows(path) -> list:
    return [json.loads(line) for line in Path(path).read_text().splitlines()]


def _compare_frames(got: list, ref: list) -> dict:
    """Frame lists from two decodes of one file: how many frames differ,
    and how many bits differ inside frames present in both."""
    key = lambda f: (f.get("carrier"), f.get("number"),  # noqa: E731
                     f.get("sync_position"))
    a = {key(f): f for f in got}
    b = {key(f): f for f in ref}
    bit_diff = 0
    field_diff = 0
    for k in a.keys() & b.keys():
        fa, fb = a[k], b[k]
        if "bits" in fa and "bits" in fb:
            bit_diff += int(np.sum(np.asarray(fa["bits"])
                                   != np.asarray(fb["bits"])))
        field_diff += any(fa.get(f) != fb.get(f) for f in (
            "type_name", "sds_message", "decoded_text", "mac_pdu"))
    return {"frames": len(got), "frames_ref": len(ref),
            "only_one_side": len(a.keys() ^ b.keys()),
            "field_mismatch": field_diff, "bit_mismatch": bit_diff}


# --------------------------------------------------------------------------
# inputs
# --------------------------------------------------------------------------

# (grid, channel index, SNR dB in the 25 kHz channel, residual tuning Hz):
# "ddc" channels sit on the 16-carrier grid carrier_grid(16) (-137.5,
# -12.5, +112.5 kHz), "pfb" ones on the 25 kHz PFB grid (+500, -600,
# +900 kHz).  The synthetic bursts are sample-and-hold, whose spectrum
# leaks far beyond 25 kHz, so plants keep >= 100 kHz apart.
PLANTS = (("ddc", 2, 40.0, 0.0), ("ddc", 7, 34.0, 40.0),
          ("ddc", 12, 30.0, -80.0), ("pfb", 20, 40.0, 0.0),
          ("pfb", 72, 34.0, 40.0), ("pfb", 36, 30.0, -80.0))
FRAMES_PER_BURST = 4


def plant_offset_hz(grid: str, index: int) -> float:
    from tetraear_tpu.ops.channelizer import carrier_grid
    from tetraear_tpu.ops.pfb import channel_offsets_hz

    if grid == "ddc":
        return float(carrier_grid(16)[index])
    return float(channel_offsets_hz(96, FS)[index])


def _clean_burst(payload: bytes, seed: int) -> np.ndarray:
    """Golden-frame burst bits that the host decoder walk recovers whole
    from clean bits (every frame with its payload and burst CRC), and
    whose data matches at most 18 of a training sequence's 22 bits away
    from the planted syncs (the walk takes syncs greedily, so a near-sync
    in a frame's data could shadow the true one behind it at the first
    bit error).  Tries seeds from `seed` up."""
    from tetraear_tpu import constants as C
    from tetraear_tpu.core.decoder import TetraDecoder
    from tetraear_tpu.utils import synth

    pats = np.stack([C.TS1, C.TS2]).astype(np.int64) * 2 - 1
    syncs = 64 + 216 + 510 * np.arange(FRAMES_PER_BURST)
    for s in range(seed, seed + 1000):
        st = synth.make_stream_bits(num_frames=FRAMES_PER_BURST,
                                    lead_bits=64, seed=s, golden=True,
                                    payload=payload)
        pm = st.astype(np.int64) * 2 - 1
        win = np.lib.stride_tricks.sliding_window_view(pm, 22)
        agree = ((22 + win @ pats.T) // 2).max(axis=1)   # matching bits
        if np.delete(agree, syncs).max() > 18:
            continue
        mapped = (st[0::2].astype(np.int64) << 1) | st[1::2]
        frames = TetraDecoder(auto_decrypt=False).decode_frontend(
            st, mapped, (agree / 22.0).astype(np.float32))
        if sum(f.get("burst_crc", False) and f.get("sds_message")
               == f"[TXT] {payload.decode()}"
               for f in frames) == FRAMES_PER_BURST:
            return st
    raise RuntimeError("no clean burst seed found")


def make_band_capture(path, n_blocks: int, block: int,
                      bursts_per_block: int = 2, seed: int = 7) -> list:
    """Seeded wideband capture: complex noise over the whole 2.4 MHz band
    plus golden-frame bursts (utils/synth, the 130-sample ref symbol grid)
    on the PLANTS channels.  Bursts sit inside blocks, never across a
    block edge; `block` is a multiple of the 130-sample symbol.  Writes complex64 to `path`; returns the planted
    (grid, index, payload, frames) list."""
    from tetraear_tpu.io.replay import save_iq
    from tetraear_tpu.utils import synth

    rng = np.random.default_rng(seed)
    n = n_blocks * block
    sigma = 0.05
    x = (sigma / np.sqrt(2)) * (rng.standard_normal(n)
                                + 1j * rng.standard_normal(n))
    x = x.astype(np.complex64)
    in_channel_noise = sigma ** 2 * 25e3 / FS
    planted = []
    t_full = np.arange(n) / FS
    for p, (grid, idx, snr_db, tune_hz) in enumerate(PLANTS):
        amp = np.sqrt(in_channel_noise * 10 ** (snr_db / 10))
        f = plant_offset_hz(grid, idx) + tune_hz
        # one symbol clock per carrier, as a base station keeps: every
        # burst of a carrier starts on the same 130-sample grid phase
        clock = int(rng.integers(0, 130))
        for b in range(n_blocks):
            for j in range(bursts_per_block):
                payload = f"{grid.upper()}{idx:02d} B{b}{j}".encode()
                st = _clean_burst(payload, 1000 * p + 100 * b + 10 * j)
                ph = synth.synthesize_symbol_phasors(
                    synth.bits_to_symbols(st), mapping="ref",
                    phase0=rng.uniform(0, 2 * np.pi))
                iq = synth.upsample_hold(ph, FS, FS / 130.0)
                span = block // bursts_per_block // 130 * 130
                slack = span - len(iq)
                assert slack > 0, "block too short for its bursts"
                start = (b * block + j * span + clock
                         + 130 * int(rng.integers(0, (slack - clock) // 130)))
                sl = slice(start, start + len(iq))
                x[sl] += (amp * iq * np.exp(2j * np.pi * f * t_full[sl])
                          ).astype(np.complex64)
                planted.append((grid, idx, payload.decode(),
                                FRAMES_PER_BURST))
    save_iq(path, x, sample_rate=FS, center_frequency=392.5e6)
    return planted


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def _load_golden(name: str) -> tuple:
    lines = (FIXTURES / f"{name}.golden.jsonl").read_text().splitlines()
    return json.loads(lines[0])["__meta__"], [json.loads(x) for x in lines[1:]]


def _golden_mismatches(frames: list, golden: list) -> int:
    """Golden keys that differ (the reference schema; keys this repo adds
    are ignored, and 'chunk' is the golden loop's own bookkeeping)."""
    bad = abs(len(frames) - len(golden))
    for mine, gold in zip(frames, golden):
        mine = json.loads(json.dumps(mine, sort_keys=True))
        bad += sum(1 for k, v in gold.items()
                   if k != "chunk" and mine.get(k) != v)
    return bad


def _sanitized(frames: list) -> list:
    sys.path.insert(0, str(REPO / "tests" / "conformance"))
    from test_golden_fixtures import _sanitize
    return [_sanitize(f) for f in frames]


def _decode_fixture(name: str, profile: str, device, workdir: Path) -> tuple:
    """(frames, seconds) of one golden fixture decoded on `device`: the
    decode CLI, or for a capture tuned off centre the library path with
    the offset the golden was made with (the decode CLI takes none)."""
    import jax
    from tetraear_tpu.config import ReceiverConfig
    from tetraear_tpu.core.decoder import TetraDecoder
    from tetraear_tpu.io.replay import load_iq
    from tetraear_tpu.models.receiver import SignalProcessor

    meta, _ = _load_golden(name)
    ext = "sc16" if name == "long_mixed" else "cf32"
    src = str(FIXTURES / f"{name}.{ext}")
    with jax.default_device(device):
        if meta.get("freq_offset_hz"):
            t0 = time.perf_counter()
            sp = SignalProcessor(config=ReceiverConfig(profile=profile))
            sym = sp.process(np.asarray(load_iq(src)),
                             freq_offset=meta["freq_offset_hz"])
            frames = _sanitized(TetraDecoder(
                auto_decrypt=meta["auto_decrypt"]).decode(sym))
            return frames, time.perf_counter() - t0
        o = workdir / f"{name}_{profile}_{device.platform}.jsonl"
        dt = _cli(["decode", src, "--profile", profile, "--chunk-size",
                   str(meta.get("chunk_samples", 262_144)), "-o", str(o)]
                  + (["--auto-decrypt"] if meta["auto_decrypt"] else []))
        return _rows(o), dt


def phase_golden(device, cpu, workdir: Path, cases=GOLDEN_CASES) -> dict:
    """ref-exact bit-exact vs golden; ref-compat equal to the CPU decode
    with the golden's frame count."""
    import jax
    import jax.numpy as jnp
    from tetraear_tpu.config import ReceiverConfig
    from tetraear_tpu.models.receiver import Frontend

    out = {"cases": {}}
    for name in cases:
        _, golden = _load_golden(name)
        exact, t_exact = _decode_fixture(name, "ref-exact", device, workdir)
        compat, t_compat = _decode_fixture(name, "ref-compat", device,
                                           workdir)
        compat_cpu, _ = _decode_fixture(name, "ref-compat", cpu, workdir)
        out["cases"][name] = {
            "exact_s": t_exact, "compat_s": t_compat,
            "golden_frames": len(golden), "exact_frames": len(exact),
            "exact_mismatch": _golden_mismatches(exact, golden),
            "compat_frames": len(compat),
            "compat_vs_cpu": _compare_frames(compat, compat_cpu)}

    stats = []
    with jax.default_device(device):
        x = np.zeros(262_144, np.complex64)
        for profile in ("ref-exact", "ref-compat"):
            fe = Frontend(ReceiverConfig(profile=profile))
            _, st = run_stages([(profile, fe._compiled(x.shape[-1], False),
                                 (jnp.float32(0.0),))], x, device)
            stats += st
    out["stages"] = stats
    out["ok"] = all(
        r["exact_mismatch"] == 0 and r["exact_frames"] == r["golden_frames"]
        and r["compat_frames"] == r["golden_frames"]
        and r["compat_vs_cpu"]["only_one_side"] == 0
        and r["compat_vs_cpu"]["field_mismatch"] == 0
        and r["compat_vs_cpu"]["bit_mismatch"] == 0
        for r in out["cases"].values())
    return out


# Bounds on GPU-vs-CPU differences of one decode (the planted frames must
# be bit-identical): the convs run in f32 on both devices but sum in
# another order, so a decision whose value lies within rounding of a
# sector boundary can flip.  Those sit in noise, not in the planted bursts.
MAX_STREAM_BIT_FLIPS = 1e-4      # of all demodulated bits of a block
MAX_NOISE_FRAME_DIFF = 0.02      # of all frames (junk syncs found in noise)


def phase_wideband(device, cpu, capture: Path, planted: list, pfb: bool,
                   block: int, workdir: Path) -> dict:
    """decode --carriers 16 (pfb=False) or --carriers 96 --pfb on the band
    capture: every planted frame of this grid recovered with its payload
    and CRC, the planted frames bit-identical to the CPU decode of the
    file, and the rest of the decode within the MAX_* bounds."""
    import jax
    from tetraear_tpu.io.replay import load_iq
    from tetraear_tpu.models.multicarrier import (MulticarrierFrontend,
                                                  PfbMulticarrierFrontend)
    from tetraear_tpu.ops.channelizer import carrier_grid

    grid = "pfb" if pfb else "ddc"
    argv = ["decode", str(capture), "--chunk-size", str(block)] + (
        ["--carriers", "96", "--pfb"] if pfb else ["--carriers", "16"])
    rows = {}
    out = {}
    for tag, dev in (("gpu", device), ("cpu", cpu)):
        o = workdir / f"{grid}_{tag}.jsonl"
        with jax.default_device(dev):
            out[f"cli_{tag}_s"] = _cli(argv + ["-o", str(o)])
        rows[tag] = _rows(o)

    texts = {f"[TXT] {p[2]}" for p in planted if p[0] == grid}
    missing = []
    for g, idx, payload, nframes in planted:
        if g != grid:
            continue
        hits = [r for r in rows["gpu"] if r.get("carrier") == idx
                and r.get("sds_message") == f"[TXT] {payload}"
                and r.get("burst_crc")]
        if len(hits) < nframes:
            missing.append((idx, payload, len(hits), nframes))
    out["planted_frames"] = sum(p[3] for p in planted if p[0] == grid)
    out["missing"] = missing
    plant_rows = {t: [r for r in rows[t] if r.get("sds_message") in texts]
                  for t in rows}
    out["planted_vs_cpu"] = _compare_frames(plant_rows["gpu"],
                                            plant_rows["cpu"])
    out["all_vs_cpu"] = _compare_frames(rows["gpu"], rows["cpu"])

    block0 = np.asarray(load_iq(str(capture))[:block], np.complex64)
    bits = {}
    for tag, dev in (("gpu", device), ("cpu", cpu)):
        with jax.default_device(dev):
            if pfb:
                run = PfbMulticarrierFrontend(fused="s2d")._compiled(block)
            else:
                run = MulticarrierFrontend(fused="s2d")._compiled_fused(
                    tuple(float(v) for v in carrier_grid(16)))
            outs, stats = run_stages(run.stages, block0, dev)
        bits[tag] = np.asarray(outs[1][0])          # the tail's bit streams
        if tag == "gpu":
            out["stages"] = stats
    out["stream_bits"] = int(bits["gpu"].size)
    out["stream_bit_flips"] = int(np.sum(bits["gpu"] != bits["cpu"]))
    out["bounds"] = {"stream_bit_flips": MAX_STREAM_BIT_FLIPS,
                     "noise_frame_diff": MAX_NOISE_FRAME_DIFF}
    p, a = out["planted_vs_cpu"], out["all_vs_cpu"]
    noise_diff = a["only_one_side"] + a["field_mismatch"]
    out["ok"] = (not missing and p["only_one_side"] == 0
                 and p["field_mismatch"] == 0 and p["bit_mismatch"] == 0
                 and noise_diff <= MAX_NOISE_FRAME_DIFF * max(a["frames"], 1)
                 and out["stream_bit_flips"]
                 <= MAX_STREAM_BIT_FLIPS * out["stream_bits"])
    return out


def phase_downlink(device, cpu, workdir: Path, slots: int = 16) -> dict:
    """`downlink` (etsi profile) on a make_fixture --downlink capture:
    SYNC decoded, every checked slot CRC-valid, the SDS payload present,
    and the same frames as the CPU decode."""
    import jax
    import jax.numpy as jnp
    from tetraear_tpu.io.replay import load_iq
    from tetraear_tpu.models.receiver_etsi import EtsiReceiver

    cap = workdir / "downlink.cf32"
    subprocess.run(
        [sys.executable, str(REPO / "tools" / "make_fixture.py"), str(cap),
         "--downlink", "--slots", str(slots), "--payload", "SMOKE SDS"],
        check=True, capture_output=True, text=True,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    rows = {}
    out = {}
    for tag, dev in (("gpu", device), ("cpu", cpu)):
        o = workdir / f"downlink_{tag}.jsonl"
        with jax.default_device(dev):
            out[f"cli_{tag}_s"] = _cli(["downlink", str(cap), "-o", str(o)])
        rows[tag] = _rows(o)
    got = rows["gpu"]
    checked = [r for r in got if r["crc_ok"] is not None]
    out["slots"] = len(got)
    out["crc_pass"] = sum(bool(r["crc_ok"]) for r in checked)
    out["crc_checked"] = len(checked)
    out["sync_mcc"] = sorted({r["mcc"] for r in got if r["burst"] == "SB"})
    out["sds_found"] = any(
        bytes.fromhex(r["mac_data"] or "").find(b"SMOKE SDS") >= 0
        for r in got)
    out["equal_cpu"] = got == rows["cpu"]
    with jax.default_device(device):
        iq = np.asarray(load_iq(str(cap)), np.complex64)
        rx = EtsiReceiver()
        _, out["stages"] = run_stages(
            [("etsi_demod", rx._compiled(iq.shape[-1]),
              (jnp.float32(0.0),))], iq, device)
    out["ok"] = (len(got) > 0 and out["crc_pass"] == out["crc_checked"] > 0
                 and out["sync_mcc"] == [262] and out["sds_found"]
                 and out["equal_cpu"])
    return out


def _bench_kernels() -> dict:
    """Composite kernels at the bench widths: name -> (kernel, gc)."""
    from tetraear_tpu.config import ReceiverConfig
    from tetraear_tpu.ops import fused
    from tetraear_tpu.ops.channelizer import carrier_grid

    cfg = ReceiverConfig()
    cutoff = (cfg.channel_bandwidth_hz / 2) / (cfg.intermediate_rate_hz / 2)
    k16, gc16, _ = fused.fused_kernel(
        np.asarray(carrier_grid(16), np.float64), cfg.sample_rate_hz,
        cfg.decimation_factor, cfg.decim_fir_taps_per_phase,
        cfg.channel_fir_taps, cutoff)
    kp, gcp, _ = fused.pfb_kernel(96, cfg.sample_rate_hz)
    return {"16c": (k16, gc16), "pfb96": (kp, gcp)}


def conv_cases() -> list:
    """(name, jitted conv x -> (C2, M) rows, extra args, kernel, gc): the
    XLA convs the front-ends run (s2d, and s2d_of for the DDC bank)."""
    import jax
    from tetraear_tpu.ops import fused

    d = 10
    cases = []
    for width, (k, gc) in _bench_kernels().items():
        L = k.shape[-1]
        cases.append((f"s2d_{width}", jax.jit(
            lambda x, kk, gc=gc, L=L: fused._s2d_conv(x, kk, gc, L, d)),
            (fused.s2d_kernel(k, d),), k, gc))
        if width == "16c":
            cases.append((f"s2d_of_{width}", jax.jit(
                lambda x, kk, gc=gc, L=L: fused._s2d_conv_folded(
                    x, kk, gc, L, d, 4)),
                (fused.s2d_of_kernel(k, d, 4),), k, gc))
    return cases


def phase_kernels(device, n: int = BLOCK, ref_outputs: int = 4096,
                  seed: int = 3) -> dict:
    """Each channelizer conv as compiled for the device, timed at a real
    block and compared with the float64 reference on its first outputs."""
    import jax
    from tetraear_tpu.ops import fused

    d = 10
    rng = np.random.default_rng(seed)
    x_np = ((rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 0.3
            ).astype(np.complex64)
    out = {"cases": {}}
    with jax.default_device(device):
        for name, fn, extra, k, gc in conv_cases():
            ((y,),), st = run_stages([(name, fn, extra)], x_np, device)
            m = min(ref_outputs, y.shape[-1])
            ref = fused.conv_reference(x_np[:m * d + k.shape[-1]],
                                       np.asarray(k), gc, d, m)
            err = float(np.abs(np.asarray(y[:, :m]) - ref).max()
                        / np.abs(ref).mean())
            flops = 2.0 * y.shape[0] * y.shape[-1] * k.shape[1] * k.shape[-1]
            out["cases"][name] = {**st[0], "rel_err": err,
                                  "gflop": flops / 1e9,
                                  "shape": list(y.shape)}
    # f32 accumulation over ~1,500 terms: 1e-4 bounds it with margin,
    # and TF32 operands (about 1e-3 relative) would exceed it
    out["tolerance"] = 1e-4
    out["ok"] = all(c["rel_err"] < out["tolerance"]
                    for c in out["cases"].values())
    return out


class _Tally:
    """pytest plugin counting test outcomes."""

    def __init__(self):
        self.counts = {"passed": 0, "failed": 0, "skipped": 0}

    def pytest_runtest_logreport(self, report):
        if report.failed:
            self.counts["failed"] += 1
        elif report.skipped:
            self.counts["skipped"] += 1
        elif report.when == "call":
            self.counts["passed"] += 1


def phase_pytest(device_opt: str = "gpu") -> dict:
    """``pytest -m gpu --device gpu`` in this process: every test must
    run and pass (a skip means the card was not reached)."""
    import pytest

    tally = _Tally()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        rc = pytest.main(["-q", "-m", "gpu", "--device", device_opt,
                          "-p", "no:cacheprovider",
                          str(REPO / "tests" / "unit" / "test_gpu.py")],
                         plugins=[tally])
    c = tally.counts
    return {"rc": int(rc), **c, "seconds": time.perf_counter() - t0,
            "ok": int(rc) == 0 and c["passed"] > 0
            and c["failed"] == c["skipped"] == 0}


def phase_sharded(devices, samples_per_shard: int = BLOCK // 2,
                  carriers: int = 16, seed: int = 5) -> dict:
    """The (carrier, time) sharded receive step (parallel/sharded.py, as
    tests/unit/test_parallel.py pins it) on a (2, 2) mesh over four
    devices against the unsharded step on the first device: owned-interior
    bits equal on the golden carrier, >= 99.5 % equal on noise carriers
    (fp reassociation flips deep-fade decisions), one best phase per
    carrier across time shards, and an output spanning all four
    devices."""
    import jax
    from tetraear_tpu.config import ReceiverConfig
    from tetraear_tpu.models.multicarrier import MulticarrierFrontend
    from tetraear_tpu.parallel.mesh import make_mesh
    from tetraear_tpu.parallel.sharded import build_sharded_step, shard_inputs
    from tetraear_tpu.utils import synth

    cfg = ReceiverConfig()
    step = cfg.decimation_factor * cfg.ref_samples_per_symbol
    n_time = 2
    t_local = (samples_per_shard // step) * step
    total = n_time * t_local
    mesh = make_mesh(carrier=2, time=n_time, devices=list(devices)[:4])

    st = synth.make_stream_bits(num_frames=8, lead_bits=64, seed=2,
                                golden=True)
    sig = synth.upsample_hold(synth.synthesize_symbol_phasors(
        synth.bits_to_symbols(st), mapping="ref"), FS, FS / 130.0)
    rng = np.random.default_rng(seed)
    x = 0.05 * (rng.standard_normal(total) + 1j * rng.standard_normal(total))
    # bursts at the start, across the shard boundary and at the end,
    # where they fit without overlapping
    last = -len(sig)
    for at in (0, t_local - len(sig) // 2, total - len(sig) - 1):
        if at >= last + len(sig) and at + len(sig) <= total:
            x[at:at + len(sig)] += sig
            last = at
    x = x.astype(np.complex64)
    offsets = ((np.arange(carriers) - carriers // 2) * 25e3
               ).astype(np.float32)                 # carrier 8 at 0 Hz

    out = {"mesh": dict(mesh.shape), "samples": total}
    with jax.default_device(devices[0]):
        t0 = time.perf_counter()
        ref = MulticarrierFrontend(cfg)(x, offsets)
        ref_bits = np.asarray(jax.block_until_ready(ref.bits))
        out["unsharded_s"] = time.perf_counter() - t0
    run = build_sharded_step(mesh, cfg)
    xs, offs = shard_inputs(mesh, x, offsets)
    t0 = time.perf_counter()
    compiled = run.lower(xs, offs).compile()
    out["compile_s"] = time.perf_counter() - t0
    res = jax.block_until_ready(compiled(xs, offs))
    t0 = time.perf_counter()
    res = jax.block_until_ready(compiled(xs, offs))
    out["steady_s"] = time.perf_counter() - t0
    out["memory"] = _memory(compiled)
    out["output_devices"] = len(res.bits.sharding.device_set)
    bits = np.asarray(res.bits)
    best = np.asarray(res.best_phase)

    halo_syms = (132 * step // cfg.decimation_factor
                 ) // cfg.ref_samples_per_symbol
    own_syms = (t_local // cfg.decimation_factor) // cfg.ref_samples_per_symbol
    agree = []
    for c in range(carriers):
        for k in range(n_time):
            seg = bits[c, k]
            off = k * own_syms - halo_syms
            j0 = halo_syms + 8
            j1 = halo_syms + own_syms - 8
            local = seg[2 * (j0 - 1):2 * (j1 - 1)]
            g0 = 2 * (j0 - 1 + off)
            refseg = ref_bits[c, g0:g0 + local.size]
            agree.append((c, k, float((local == refseg).mean())))
    golden_c = carriers // 2
    out["golden_carrier_agreement"] = min(a for c, _, a in agree
                                          if c == golden_c)
    out["noise_carrier_agreement"] = min(a for c, _, a in agree
                                         if c != golden_c)
    out["best_phase_consistent"] = bool((best[:, 0] == best[:, 1]).all())
    out["peak_bytes"] = [peak_bytes(d) for d in list(devices)[:4]]
    out["ok"] = (out["output_devices"] == 4
                 and out["golden_carrier_agreement"] == 1.0
                 and out["noise_carrier_agreement"] >= 0.995
                 and out["best_phase_consistent"])
    return out


# --------------------------------------------------------------------------

def _header(device_count: int) -> None:
    import jax
    from tetraear_tpu.utils.backend import enable_compile_cache

    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except OSError as e:
        smi = f"nvidia-smi unavailable ({e})"
    print(f"nvidia-smi: {smi}")
    print(f"jax {jax.__version__}; devices: {device_count} x "
          f"{jax.devices()[0].device_kind}")
    print(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    print(f"compile cache: {enable_compile_cache()}")
    print("precision: " + json.dumps(PRECISION))
    sys.stdout.flush()


def _report(name: str, res: dict, device) -> bool:
    res = {"phase": name, **res}
    if device is not None:
        res["peak_bytes_in_use"] = peak_bytes(device)
    print("PHASE " + json.dumps(res, default=str))
    sys.stdout.flush()
    return bool(res["ok"])


PHASES = ("kernels", "golden", "ddc16", "pfb96", "downlink", "pytest")


def run_phases(dev, cpu, phases=PHASES, block: int = BLOCK,
               bursts_per_block: int = 2, device_opt: str = "gpu") -> bool:
    """Run the one-device phases on `dev` (host comparisons on `cpu`),
    printing one PHASE line each; True when every phase passed."""
    ok = True
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        work = Path(tmp)
        planted = None
        capture = work / "band.cf32"
        for name in phases:
            t0 = time.perf_counter()
            if name in ("ddc16", "pfb96") and planted is None:
                planted = make_band_capture(capture, 2, block,
                                            bursts_per_block)
            if name == "kernels":
                res = phase_kernels(dev, n=block)
            elif name == "golden":
                res = phase_golden(dev, cpu, work)
            elif name in ("ddc16", "pfb96"):
                res = phase_wideband(dev, cpu, capture, planted,
                                     name == "pfb96", block, work)
            elif name == "downlink":
                res = phase_downlink(dev, cpu, work)
            elif name == "pytest":
                res = phase_pytest(device_opt)
            else:
                raise ValueError(f"unknown phase {name!r}; valid: {PHASES}")
            res["phase_s"] = time.perf_counter() - t0
            ok = _report(name, res, dev) and ok
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gpus", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded phase on four GPUs")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"no GPU: JAX's default backend is {devices[0].platform}",
              file=sys.stderr)
        return 2
    if len(devices) < args.gpus:
        print(f"need {args.gpus} GPUs, JAX sees {len(devices)}",
              file=sys.stderr)
        return 2
    _header(len(devices))
    dev = devices[0]
    if args.gpus == 4:
        ok = _report("sharded", phase_sharded(devices), None)
    else:
        ok = run_phases(dev, jax.devices("cpu")[0])
    if not ok:
        print("chip smoke FAILED", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
