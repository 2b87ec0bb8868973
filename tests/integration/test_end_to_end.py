"""End-to-end integration: fixtures -> CLI decode -> JSONL; capture loop;
scanner on synthetic sources; IO round-trips; audio blocks."""

import json
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tetraear_tpu import constants as C
from tetraear_tpu.audio import blocks
from tetraear_tpu.audio.voice import VoiceProcessor
from tetraear_tpu.io.recorder import (JsonlFrameRecorder, read_jsonl_frames,
                                      sanitize_frame)
from tetraear_tpu.io.replay import (FileReplaySource, SyntheticSource,
                                    load_iq, save_iq)
from tetraear_tpu.signal.detector import TetraSignalDetector
from tetraear_tpu.signal.scanner import FrequencyScanner
from tetraear_tpu.ui.capture_loop import CaptureLoop
from tetraear_tpu.utils import synth

REPO = Path(__file__).resolve().parents[2]


@pytest.fixture(scope="module")
def golden_iq(tmp_path_factory):
    """A .cf32 fixture with 6 golden frames on the 130-sample symbol grid."""
    stream = synth.make_stream_bits(num_frames=6, lead_bits=64, seed=2,
                                    golden=True)
    syms = synth.bits_to_symbols(stream)
    phasors = synth.synthesize_symbol_phasors(syms, mapping="ref")
    iq = synth.upsample_hold(phasors, 2.4e6, 2.4e6 / 130.0).astype(np.complex64)
    path = tmp_path_factory.mktemp("iq") / "golden.cf32"
    save_iq(path, iq, sample_rate=2.4e6, center_frequency=392.5e6)
    return path


class TestIO:
    @pytest.mark.parametrize("ext", [".cf32", ".cs16", ".cs8", ".npy"])
    def test_iq_roundtrip(self, tmp_path, ext, rng):
        x = (rng.standard_normal(1000) + 1j * rng.standard_normal(1000)
             ).astype(np.complex64) * 0.1
        p = tmp_path / f"t{ext}"
        save_iq(p, x, sample_rate=2.4e6)
        y = load_iq(p)
        assert y.dtype == np.complex64 and len(y) == len(x)
        tol = {".cf32": 1e-6, ".npy": 1e-6, ".cs16": 1e-3, ".cs8": 2e-2}[ext]
        np.testing.assert_allclose(y, x, atol=tol)

    def test_replay_source_reads_and_exhausts(self, golden_iq):
        src = FileReplaySource(golden_iq)
        assert src.open()
        assert src.sample_rate == 2.4e6          # from sidecar
        a = src.read_samples(1000)
        assert len(a) == 1000
        rest = src.read_samples(10_000_000)
        assert src.exhausted
        assert len(rest) < 10_000_000
        src.close()

    def test_replay_loop_mode(self, golden_iq):
        src = FileReplaySource(golden_iq, loop=True)
        src.open()
        total = len(load_iq(golden_iq))
        a = src.read_samples(total + 500)
        assert len(a) == total + 500

    def test_jsonl_sanitize_and_roundtrip(self, tmp_path):
        p = tmp_path / "frames.jsonl"
        frame = {
            "number": np.int64(3),
            "bits": np.array([0, 1, 1]),
            "crc": np.bool_(True),
            "mac_pdu": {"data": b"\x01\x02"},
            "conf": np.float32(0.5),
        }
        with JsonlFrameRecorder(p) as rec:
            rec.write(frame)
        rows = list(read_jsonl_frames(p))
        assert rows[0]["number"] == 3
        assert rows[0]["bits"] == [0, 1, 1]
        assert rows[0]["crc"] is True
        assert rows[0]["mac_pdu"]["data"] == "0102"

    def test_sanitize_nested(self):
        out = sanitize_frame({"a": [np.int32(1), {"b": b"\xff"}]})
        assert out == {"a": [1, {"b": "ff"}]}


class TestCaptureLoop:
    def test_replay_decodes_frames(self, golden_iq):
        src = FileReplaySource(golden_iq)
        loop = CaptureLoop(src, sample_rate=2.4e6, auto_decrypt=False,
                           always_decode=True, afc=False)
        frames = []
        loop.on_frame = frames.append
        loop.run(max_chunks=10)
        assert loop.chunks_processed >= 1
        assert len(frames) >= 4
        assert frames[0]["mac_pdu"]["data"] == b"HELLO HELLO"

    def test_retune_applied(self, golden_iq):
        src = FileReplaySource(golden_iq)
        loop = CaptureLoop(src, sample_rate=2.4e6, always_decode=True)
        loop.set_frequency(393e6)
        loop.run(max_chunks=1)
        assert loop.frequency == 393e6
        assert src.frequency == 393e6


class TestDetectorScanner:
    def test_detector_flags_synthetic_tetra(self):
        rng = np.random.default_rng(0)
        syms = rng.integers(0, 4, 4000)
        x = synth.synthesize_iq(syms, snr_db=25, mapping="pi4")
        det = TetraSignalDetector()
        res = det.analyze_signal(x)
        assert res["signal_present"]
        assert res["modulation_confidence"] > 0.2
        assert 0.0 <= res["confidence"] <= 1.0

    def test_detector_rejects_noise(self):
        rng = np.random.default_rng(1)
        x = 0.001 * (rng.standard_normal(100_000)
                     + 1j * rng.standard_normal(100_000)).astype(np.complex64)
        det = TetraSignalDetector()
        res = det.analyze_signal(x)
        assert not res["is_tetra"]

    def test_scanner_synthetic_sweep(self):
        src = SyntheticSource(active_frequencies=(392.5e6,), snr_db=25)
        src.open()
        scanner = FrequencyScanner(src, settle_s=0.0)
        hot = scanner.scan_frequency(392.5e6, dwell_time=0.05)
        cold = scanner.scan_frequency(391.0e6, dwell_time=0.05)
        assert hot["power_db"] > cold["power_db"] + 10

    def test_scan_range_returns_list(self):
        src = SyntheticSource(active_frequencies=(), snr_db=30)
        src.open()
        scanner = FrequencyScanner(src, settle_s=0.0)
        found = scanner.scan_range(390e6, 390.1e6)
        assert isinstance(found, list)


class TestAudioBlocks:
    def test_hard_bits_block_layout(self):
        bits = np.ones(432, np.uint8)
        block = blocks.block_from_hard_bits(bits)
        assert len(block) == C.CODEC_BLOCK_BYTES
        shorts = struct.unpack(f"<{C.CODEC_BLOCK_SHORTS}h", block)
        assert shorts[0] == C.CODEC_FRAME_HEADER
        assert shorts[1] == 127 and shorts[114] == 127
        assert shorts[115] == 0                   # gap between ranges
        assert shorts[116] == 127 and shorts[229] == 127
        assert shorts[230] == 0
        assert shorts[435] == 127 and shorts[436] == 0

    def test_soft_llr_block(self):
        llrs = np.linspace(-1, 1, 432)
        block = blocks.block_from_soft_llrs(llrs)
        shorts = struct.unpack(f"<{C.CODEC_BLOCK_SHORTS}h", block)
        assert shorts[1] == -127
        assert max(shorts[1:]) <= 127 and min(shorts[1:]) >= -127

    def test_symbols_block_quirks(self):
        frame = {"position": 0}
        syms = np.random.default_rng(0).integers(0, 4, 300)
        block = blocks.block_from_symbols(frame, syms, 133)
        assert block is not None and len(block) == C.CODEC_BLOCK_BYTES
        # missing position -> None
        assert blocks.block_from_symbols({}, syms, 133) is None
        # too-short symbol stream -> None
        assert blocks.block_from_symbols(frame, syms[:100], 133) is None

    def test_validate_block(self):
        assert not blocks.validate_block(b"short")
        good = blocks.block_from_hard_bits(np.zeros(432, np.uint8))
        assert blocks.validate_block(good)


class TestVoiceProcessor:
    def test_missing_codec_not_working(self, tmp_path):
        vp = VoiceProcessor(codec_dir=tmp_path)
        assert not vp.working
        assert vp.decode_frame(b"\x21\x6b" + bytes(1378)).size == 0

    def test_mocked_codec_chain(self, tmp_path):
        """Fake cdecoder/sdecoder scripts exercise the full two-stage chain
        without the real exes (reference test strategy,
        tests/unit/test_voice_processor.py:73-93)."""
        cdec = tmp_path / "cdecoder"
        sdec = tmp_path / "sdecoder"
        # cdecoder writes 552 bytes of serial data; sdecoder writes PCM
        cdec.write_text("#!/bin/sh\nhead -c 552 /dev/zero > \"$2\"\n")
        pcm = np.linspace(-0.4, 0.4, 480)
        pcm_i16 = (pcm * 32767).astype(np.int16).tobytes()
        pcm_file = tmp_path / "pcm.bin"
        pcm_file.write_bytes(pcm_i16)
        sdec.write_text(f"#!/bin/sh\ncp {pcm_file} \"$2\"\n")
        cdec.chmod(0o755)
        sdec.chmod(0o755)
        vp = VoiceProcessor(codec_dir=tmp_path)
        assert vp.working
        block = blocks.block_from_hard_bits(np.ones(432, np.uint8))
        audio = vp.decode_frame(block)
        assert audio.size == 480
        assert abs(float(np.max(audio)) - 0.4) < 0.01

    def test_silent_output_rejected(self, tmp_path):
        cdec = tmp_path / "cdecoder"
        sdec = tmp_path / "sdecoder"
        cdec.write_text("#!/bin/sh\nhead -c 552 /dev/zero > \"$2\"\n")
        sdec.write_text("#!/bin/sh\nhead -c 960 /dev/zero > \"$2\"\n")
        cdec.chmod(0o755)
        sdec.chmod(0o755)
        vp = VoiceProcessor(codec_dir=tmp_path)
        block = blocks.block_from_hard_bits(np.ones(432, np.uint8))
        assert vp.decode_frame(block).size == 0

    def test_invalid_header_rejected(self, tmp_path):
        cdec = tmp_path / "cdecoder"
        sdec = tmp_path / "sdecoder"
        cdec.write_text("#!/bin/sh\n")
        sdec.write_text("#!/bin/sh\n")
        cdec.chmod(0o755)
        sdec.chmod(0o755)
        vp = VoiceProcessor(codec_dir=tmp_path)
        assert vp.decode_frame(bytes(1380)).size == 0


class TestCLI:
    def test_decode_subcommand(self, golden_iq, tmp_path):
        out = tmp_path / "frames.jsonl"
        result = subprocess.run(
            [sys.executable, "-m", "tetraear_tpu", "decode", str(golden_iq),
             "-o", str(out), "--no-bits"],
            capture_output=True, text=True, timeout=300,
            env={**__import__("os").environ, "PYTHONPATH": str(REPO),
                 "TETRAEAR_TPU_LOG_DIR": str(tmp_path / "logs"),
                 "JAX_PLATFORMS": "cpu"},
            cwd=str(tmp_path))
        assert result.returncode == 0, result.stderr[-2000:]
        assert "[DONE]" in result.stdout
        rows = list(read_jsonl_frames(out))
        assert len(rows) >= 4
        assert rows[0]["type_name"] == "MAC-RESOURCE"
        assert "bits" not in rows[0]
        assert rows[0]["mac_pdu"]["data"] == bytes(b"HELLO HELLO").hex()

    def test_decode_conv_variant_validation(self, golden_iq, tmp_path):
        """--conv combinations invalid for the selected frontend fail
        up front with a clear message, not a mid-run traceback."""
        result = subprocess.run(
            [sys.executable, "-m", "tetraear_tpu", "decode",
             str(golden_iq), "--carriers", "3", "--conv", "s2d_mono"],
            capture_output=True, text=True, timeout=300,
            env={**__import__("os").environ, "PYTHONPATH": str(REPO),
                 "TETRAEAR_TPU_LOG_DIR": str(tmp_path / "logs"),
                 "JAX_PLATFORMS": "cpu"},
            cwd=str(tmp_path))
        assert result.returncode != 0
        assert "PFB (--pfb) variant" in result.stderr
        assert "Traceback" not in result.stderr

    def test_waterfall_subcommand(self, golden_iq, tmp_path):
        """`waterfall <iq> -o x.png` writes a spec-valid PNG of the
        capture (the headless pixel surface, MIGRATION.md GUI map)."""
        out = tmp_path / "wf.png"
        result = subprocess.run(
            [sys.executable, "-m", "tetraear_tpu", "waterfall",
             str(golden_iq), "-o", str(out), "--rows", "32"],
            capture_output=True, text=True, timeout=300,
            env={**__import__("os").environ, "PYTHONPATH": str(REPO),
                 "TETRAEAR_TPU_LOG_DIR": str(tmp_path / "logs"),
                 "JAX_PLATFORMS": "cpu"},
            cwd=str(tmp_path))
        assert result.returncode == 0, result.stderr[-2000:]
        d = out.read_bytes()
        assert d[:8] == b"\x89PNG\r\n\x1a\n"
        import struct
        w, h = struct.unpack(">II", d[16:24])
        assert (w, h) == (2048, 32)

    def test_codec_subcommand_roundtrip(self, tmp_path):
        """`codec encode` + `codec decode` through the real spec-derived
        executables: PCM -> .tet blocks -> WAV with sane duration."""
        import wave

        from tetraear_tpu.utils.synth import make_test_speech
        pcm_path = tmp_path / "sp.pcm"
        make_test_speech(0.5).tofile(pcm_path)
        env = {**__import__("os").environ, "PYTHONPATH": str(REPO),
               "TETRAEAR_TPU_LOG_DIR": str(tmp_path / "logs"),
               "JAX_PLATFORMS": "cpu"}
        r1 = subprocess.run(
            [sys.executable, "-m", "tetraear_tpu", "codec", "encode",
             str(pcm_path), "-o", str(tmp_path / "sp.tet")],
            capture_output=True, text=True, timeout=300, env=env,
            cwd=str(tmp_path))
        if "not found" in r1.stdout:
            pytest.skip("codec binaries not built")
        assert r1.returncode == 0, r1.stderr[-2000:]
        assert (tmp_path / "sp.tet").stat().st_size % 1380 == 0
        r2 = subprocess.run(
            [sys.executable, "-m", "tetraear_tpu", "codec", "decode",
             str(tmp_path / "sp.tet"), "-o", str(tmp_path / "sp.wav")],
            capture_output=True, text=True, timeout=300, env=env,
            cwd=str(tmp_path))
        assert r2.returncode == 0, r2.stderr[-2000:]
        with wave.open(str(tmp_path / "sp.wav")) as w:
            assert w.getframerate() == 8000
            assert w.getnframes() >= 4000    # >= the input duration

    @pytest.mark.slow
    def test_listen_subcommand_replay(self, golden_iq, tmp_path):
        result = subprocess.run(
            [sys.executable, "-m", "tetraear_tpu", "listen",
             "--iq-file", str(golden_iq), "--max-chunks", "4",
             "--no-auto-decrypt", "--no-afc"],
            capture_output=True, text=True, timeout=300,
            env={**__import__("os").environ, "PYTHONPATH": str(REPO),
                 "TETRAEAR_TPU_LOG_DIR": str(tmp_path / "logs"),
                 "JAX_PLATFORMS": "cpu"},
            cwd=str(tmp_path))
        assert result.returncode == 0, result.stderr[-2000:]
        assert "TetraEar-TPU - CLI Mode" in result.stdout
        assert "Decoded" in result.stdout

    def test_cli_no_command_shows_help(self):
        from tetraear_tpu.ui.cli import main
        assert main([]) == 2


class TestMulticarrierDecode:
    def test_three_carrier_end_to_end(self, tmp_path):
        """Wideband fixture with distinct messages on 3 carriers -> each
        carrier's decoder recovers its own payload (config 4 end to end)."""
        import numpy as np
        from tetraear_tpu.models.multicarrier import (MulticarrierDecoder,
                                                      MulticarrierFrontend)
        from tetraear_tpu.utils import synth

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

        mc = MulticarrierFrontend()
        dec = MulticarrierDecoder(3, auto_decrypt=False)
        offsets = np.array([-25e3, 0.0, 25e3], np.float32)
        per_carrier = dec.decode(mc(x, offsets))
        assert len(per_carrier) == 3
        for c, frames in enumerate(per_carrier):
            assert len(frames) >= 2, f"carrier {c}"
            texts = {f.get("sds_message") for f in frames}
            assert f"[TXT] CARRIER {c + 1} MSG" in texts
            assert all(f["carrier"] == c for f in frames)

    def test_decode_frontend_matches_decode(self, rng):
        """decode_frontend on device outputs == decode on raw symbols."""
        import numpy as np
        from tetraear_tpu.core.decoder import TetraDecoder
        from tetraear_tpu.utils import synth
        stream = synth.make_stream_bits(num_frames=3, lead_bits=64, seed=2,
                                        golden=True)
        symbols = synth.bits_to_symbols(stream)
        a = TetraDecoder(auto_decrypt=False).decode(symbols)

        import jax.numpy as jnp
        from tetraear_tpu.ops.sync import best_correlation
        dec = TetraDecoder(auto_decrypt=False)
        bits, mapped = dec.symbols_to_bits(symbols)
        corr = np.asarray(best_correlation(
            jnp.asarray(bits.astype(np.uint8))))
        b = dec.decode_frontend(bits, mapped, corr)
        assert len(a) == len(b)
        for fa, fb in zip(a, b):
            assert fa["type_name"] == fb["type_name"]
            assert np.array_equal(fa["bits"], fb["bits"])


class TestEtsiProfileEndToEnd:
    def test_etsi_decodes_true_rate_signal_ref_cannot(self, tmp_path):
        """Flagship capability: a true pi/4-DQPSK transmission at the real
        18 kHz TETRA symbol rate decodes fully under the etsi profile
        (100% CRC + SDS text) while the reference-parity chain gets
        nothing (its truncated integer-sps clock slips, SURVEY.md §6)."""
        from tetraear_tpu.config import ReceiverConfig
        from tetraear_tpu.core.decoder import TetraDecoder
        from tetraear_tpu.models.receiver import SignalProcessor
        from tetraear_tpu.utils import synth

        stream = synth.make_stream_bits(num_frames=6, lead_bits=64, seed=2,
                                        golden=True)
        syms = synth.bits_to_symbols(stream)
        ph = synth.synthesize_symbol_phasors(syms, mapping="pi4")
        iq = synth.upsample_hold(ph, 2.4e6, 18000.0).astype(np.complex64)

        ref_frames = TetraDecoder(auto_decrypt=False).decode(
            SignalProcessor().process(iq))
        etsi_sp = SignalProcessor(config=ReceiverConfig(profile="etsi"))
        etsi_frames = TetraDecoder(auto_decrypt=False).decode(
            etsi_sp.process(iq))

        assert len(ref_frames) == 0
        assert len(etsi_frames) >= 4
        assert all(f["burst_crc"] for f in etsi_frames)
        assert all(f.get("sds_message") == "[TXT] HELLO HELLO"
                   for f in etsi_frames)


class TestWidebandScan:
    def test_wideband_sweep_finds_active_channel(self):
        from tetraear_tpu.io.replay import SyntheticSource
        from tetraear_tpu.signal.scanner import FrequencyScanner
        src = SyntheticSource(active_frequencies=(392.5e6,), snr_db=25,
                              frequency=392.5e6)
        src.open()
        scanner = FrequencyScanner(src, settle_s=0.0)
        results = scanner.scan_wideband(392.5e6, num_samples=512 * 1024,
                                        validate=False)
        assert len(results) > 50                     # ~96 channels per sweep
        by_freq = {round(r["frequency_mhz"], 3): r["power_db"]
                   for r in results}
        active = by_freq[392.5]
        far = by_freq[392.2]
        assert active > far + 10


class TestThroughputMeter:
    def test_meter_rates(self):
        from tetraear_tpu.utils.metrics import ThroughputMeter

        class Clock:
            t = 0.0

            def __call__(self):
                return self.t
        clock = Clock()
        m = ThroughputMeter(window_s=5.0, clock=clock)
        for _ in range(10):
            clock.t += 0.1
            m.record(240_000, 2)
        r = m.rates()
        assert abs(r["samples_per_sec"] - 240_000 / 0.1) / (240_000 / 0.1) < 0.2
        assert m.total_frames == 20
        assert "MS/s" in m.summary()


class TestDownlinkCLI:
    @pytest.mark.slow
    def test_downlink_simulate_roundtrip(self, tmp_path):
        out = tmp_path / "dl.jsonl"
        result = subprocess.run(
            [sys.executable, "-m", "tetraear_tpu", "downlink", "--simulate",
             "--slots", "8", "-o", str(out)],
            capture_output=True, text=True, timeout=300,
            env={**__import__("os").environ, "PYTHONPATH": str(REPO),
                 "TETRAEAR_TPU_LOG_DIR": str(tmp_path / "logs"),
                 "JAX_PLATFORMS": "cpu"},
            cwd=str(tmp_path))
        assert result.returncode == 0, result.stderr[-2000:]
        assert "[DONE]" in result.stdout
        assert "MCC=262" in result.stdout
        assert "voice block" in result.stdout
        rows = [json.loads(line) for line in out.read_text().splitlines()]
        assert len(rows) >= 6
        # TCH slots carry no block CRC and report null; every checked
        # (non-traffic) slot must pass
        assert all(r["crc_ok"] for r in rows if r["crc_ok"] is not None)
        assert all(r["crc_ok"] is None for r in rows
                   if r["channel"].startswith("TCH"))
        sbs = [r for r in rows if r["burst"] == "SB"]
        assert sbs and all(r["mcc"] == 262 for r in sbs)
        assert any(r["voice"] for r in rows)
        assert any(r["sds"] and "DOWNLINK SDS" in r["sds"] for r in rows)


class TestTuiCLI:
    @pytest.mark.slow
    def test_tui_headless_replay(self, tmp_path):
        """`tetraear_tpu tui` over a replay file: renders the live view
        headlessly (no tty -> no key thread) and exits when the capture
        loop drains; SDS text reaches the view and the session summary."""
        import os
        import subprocess
        import sys
        fx = tmp_path / "f.cf32"
        gen = subprocess.run(
            [sys.executable, "/root/repo/tools/make_fixture.py", str(fx),
             "--frames", "6"],
            capture_output=True, text=True, timeout=300)
        assert gen.returncode == 0, gen.stderr[-500:]
        proc = subprocess.run(
            [sys.executable, "-m", "tetraear_tpu", "tui", "--iq-file",
             str(fx), "--no-afc", "--max-chunks", "4"],
            capture_output=True, text=True, timeout=300,
            env={**os.environ, "PYTHONPATH": "/root/repo",
                 "TETRAEAR_TPU_LOG_DIR": str(tmp_path / "logs"),
                 "JAX_PLATFORMS": "cpu"},
            cwd=str(tmp_path))
        assert proc.returncode == 0, proc.stderr[-1200:]
        assert "HELLO HELLO" in proc.stdout
        assert "Frames:" in proc.stdout        # session summary line


class TestPfbDecodeCLI:
    def test_full_band_pfb_decode(self, tmp_path):
        """`decode --carriers N --pfb` decodes every 25 kHz channel; a
        carrier planted at +50 kHz lands in PFB channel 2 with its text."""
        import json
        import os
        import subprocess
        import sys

        import numpy as np
        from tetraear_tpu.io.replay import save_iq
        from tetraear_tpu.utils import synth
        st = synth.make_stream_bits(num_frames=5, lead_bits=64, seed=2,
                                    golden=True, payload=b"PFB CH2")
        syms = synth.bits_to_symbols(st)
        ph = synth.synthesize_symbol_phasors(syms, mapping="ref")
        iq = synth.upsample_hold(ph, 2.4e6, 2.4e6 / 130.0)
        t = np.arange(len(iq)) / 2.4e6
        x = (iq * np.exp(2j * np.pi * 50e3 * t)).astype(np.complex64)
        fx = tmp_path / "pfb.cf32"
        save_iq(fx, x, sample_rate=2.4e6, center_frequency=392.5e6)

        out = tmp_path / "o.jsonl"
        proc = subprocess.run(
            [sys.executable, "-m", "tetraear_tpu", "decode", str(fx),
             "--carriers", "1", "--pfb", "--no-bits", "-o", str(out)],
            capture_output=True, text=True, timeout=420,
            env={**os.environ, "PYTHONPATH": "/root/repo",
                 "TETRAEAR_TPU_LOG_DIR": str(tmp_path / "logs"),
                 "JAX_PLATFORMS": "cpu"},
            cwd=str(tmp_path))
        assert proc.returncode == 0, proc.stderr[-1200:]
        assert "96 carriers" in proc.stdout
        rows = [json.loads(l) for l in out.read_text().splitlines()]
        ch2 = [r for r in rows if r.get("carrier") == 2]
        assert any("PFB CH2" in (r.get("sds_message") or "") for r in ch2)
