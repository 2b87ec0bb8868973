"""bench.py contract tests: every tier runs in this one process and its
record names the device; without a GPU the script refuses to measure.

The tiers run here on the CPU at a tiny block only to pin the record's
shape; no number from such a run is a device measurement.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]


@pytest.fixture(scope="module")
def bench():
    sys.path.insert(0, str(REPO))
    import bench as b
    return b


class TestMeasure:
    def test_tier_child_contract(self, bench):
        rec = bench.run_tier("single", num_carriers=4, scale=1, iters=1,
                             symbols=400)
        assert rec["metric"] == ("iq_samples_per_sec_per_chip_"
                                 "singlecarrier_demod_sync")
        assert rec["value"] > 0 and rec["unit"] == "samples/s"
        assert rec["block_samples"] == 400 * 130

    @pytest.mark.parametrize("tier,carriers", [
        ("fused_s2d", 4), ("fused_s2d_of", 4), ("pfb", 96),
        ("realpair64", 4)])
    def test_every_tier_runs_in_process(self, bench, tier, carriers):
        rec = bench.run_tier(tier, num_carriers=4, scale=1, iters=2,
                             symbols=480)
        assert rec["metric"].startswith(
            f"iq_samples_per_sec_per_chip_{carriers}carrier_")
        assert rec["value"] > 0 and rec["compile_s"] >= 0

    def test_unknown_tier_raises(self, bench):
        with pytest.raises(ValueError):
            bench.run_tier("fused_pallas_bf16", 4, 1, 1, symbols=400)


class TestResultLine:
    def test_accelerator_line(self, bench):
        import jax
        rec = bench.run_tier("single", num_carriers=4, scale=1, iters=1,
                             symbols=400)
        dev = jax.devices()[0]
        assert (rec["platform"], rec["device_kind"], rec["device_count"]) \
            == (dev.platform, dev.device_kind, len(jax.devices()))
        assert rec["vs_baseline"] == round(rec["value"] / 2.4e6, 2)

    def test_no_result(self, bench, capsys):
        """No GPU: a non-zero exit and no JSON result on stdout."""
        assert bench.main(["--tiers", "single"]) != 0
        assert capsys.readouterr().out.strip() == ""

    def test_removed_tiers_are_refused(self, bench):
        with pytest.raises(SystemExit) as e:
            bench.main(["--tiers", "fused_pallas_bf16"])
        assert e.value.code == 2


class TestCliContract:
    @pytest.mark.slow
    def test_one_json_line(self):
        """As a script on a host without a GPU: exit non-zero, print
        nothing on stdout (there is no CPU fallback)."""
        import os
        proc = subprocess.run(
            [sys.executable, str(REPO / "bench.py")],
            capture_output=True, text=True, timeout=300,
            env={**os.environ, "JAX_PLATFORMS": "cpu"})
        assert proc.returncode != 0
        assert proc.stdout.strip() == ""
        assert "no GPU" in proc.stderr
