"""chip_smoke.py rehearsed on the host: each phase function at a tiny size
on two CPU devices (the "card" and the host it is compared with), the
sharded phase on four virtual devices, and the script's refusal to run
without a GPU.  No number from these runs is a device measurement."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))
import chip_smoke as cs  # noqa: E402

BLOCK = 520_000          # 4,000 symbols of 130 samples


@pytest.fixture(scope="module")
def devs():
    return jax.devices()[0], jax.devices()[1]


@pytest.fixture(scope="module")
def band(tmp_path_factory):
    path = tmp_path_factory.mktemp("band") / "band.cf32"
    planted = cs.make_band_capture(path, 2, BLOCK, bursts_per_block=2)
    return path, planted


class TestScript:
    def _run(self, script, cwd):
        return subprocess.run(
            [sys.executable, str(script)], capture_output=True, text=True,
            timeout=300, cwd=str(cwd),
            env={**os.environ, "JAX_PLATFORMS": "cpu"})

    def test_no_gpu_exits_nonzero(self, tmp_path):
        proc = self._run(REPO / "chip_smoke.py", tmp_path)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
        assert "no GPU" in proc.stderr

    def test_script_alone_fails(self, tmp_path):
        lone = tmp_path / "chip_smoke.py"
        shutil.copy(REPO / "chip_smoke.py", lone)
        proc = self._run(lone, tmp_path)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


class TestPhases:
    def test_kernels(self, devs):
        res = cs.phase_kernels(devs[0], n=40_000, ref_outputs=500)
        assert res["ok"], res
        assert set(res["cases"]) == {"s2d_16c", "s2d_of_16c", "s2d_pfb96"}
        assert res["cases"]["s2d_pfb96"]["shape"] == [192, 4000]

    def test_golden(self, devs, tmp_path):
        res = cs.phase_golden(devs[0], devs[1], tmp_path)
        assert res["ok"], res["cases"]
        assert set(res["cases"]) == set(cs.GOLDEN_CASES)
        assert {s["stage"] for s in res["stages"]} == {"ref-exact",
                                                        "ref-compat"}

    @pytest.mark.parametrize("pfb", [False, True])
    def test_wideband(self, devs, band, tmp_path, pfb):
        path, planted = band
        res = cs.phase_wideband(devs[0], devs[1], path, planted, pfb, BLOCK,
                                tmp_path)
        assert res["ok"], {k: v for k, v in res.items() if k != "stages"}
        assert res["planted_frames"] == 3 * 2 * 2 * cs.FRAMES_PER_BURST
        assert [s["stage"] for s in res["stages"]] == ["conv", "tail",
                                                       "candidates"]

    def test_downlink(self, devs, tmp_path):
        res = cs.phase_downlink(devs[0], devs[1], tmp_path, slots=8)
        assert res["ok"], {k: v for k, v in res.items() if k != "stages"}

    def test_sharded_on_four_devices(self):
        res = cs.phase_sharded(jax.devices()[:4],
                               samples_per_shard=1040 * 130, carriers=4)
        assert res["ok"], res
        assert res["output_devices"] == 4
        assert res["mesh"] == {"carrier": 2, "time": 2}

    def test_pytest_phase_counts_skips_as_failure(self):
        res = cs.phase_pytest(device_opt="cpu")
        assert res["skipped"] > 0 and res["passed"] == 0
        assert not res["ok"]

    def test_run_phases_prints_one_line_per_phase(self, devs, capsys):
        assert cs.run_phases(devs[0], devs[1], phases=("kernels",),
                             block=20_000)
        lines = [x for x in capsys.readouterr().out.splitlines()
                 if x.startswith("PHASE ")]
        assert len(lines) == 1
        rec = json.loads(lines[0][len("PHASE "):])
        assert rec["phase"] == "kernels" and rec["ok"]
        assert "phase_s" in rec and "peak_bytes_in_use" in rec


class TestHelpers:
    def test_clean_burst_has_no_near_sync(self):
        from tetraear_tpu import constants as C
        st = cs._clean_burst(b"DDC02 B00", 0)
        pats = np.stack([C.TS1, C.TS2]).astype(np.int64) * 2 - 1
        win = np.lib.stride_tricks.sliding_window_view(
            st.astype(np.int64) * 2 - 1, 22)
        agree = ((22 + win @ pats.T) // 2).max(axis=1)
        syncs = 64 + 216 + 510 * np.arange(cs.FRAMES_PER_BURST)
        assert (agree[syncs] == 22).all()
        assert np.delete(agree, syncs).max() <= 18

    def test_compare_frames_counts_differences(self):
        a = [{"carrier": 0, "number": 1, "sync_position": 5,
              "bits": [0, 1, 1], "sds_message": "x"},
             {"carrier": 1, "number": 2, "sync_position": 9, "bits": [1]}]
        b = [{"carrier": 0, "number": 1, "sync_position": 5,
              "bits": [0, 0, 0], "sds_message": "y"}]
        r = cs._compare_frames(a, b)
        assert r == {"frames": 2, "frames_ref": 1, "only_one_side": 1,
                     "field_mismatch": 1, "bit_mismatch": 2}

    def test_plants_sit_on_their_grids(self):
        from tetraear_tpu.ops.channelizer import carrier_grid
        for grid, idx, _, _ in cs.PLANTS:
            f = cs.plant_offset_hz(grid, idx)
            if grid == "ddc":
                assert f in carrier_grid(16)
            else:
                assert f % 25e3 == 0 and abs(f) < 1.2e6
