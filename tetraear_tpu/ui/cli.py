"""Command-line front-end.

Reference parity: `tetraear_tpu listen` is the `--no-gui` CLI mode
(ui/modern.py:5422-5657) with the same flags (-f/-g/-s/--scan/
--auto-decrypt/-v); `tetraear_tpu decode` is the offline conformance path
(continuous_capture.py shape: IQ -> frames JSONL).  There is no GUI in this
build — accelerator hosts are headless; the waterfall/table surface is the
JSONL + log streams.
"""

from __future__ import annotations

import argparse
import sys
import time
from datetime import datetime
from pathlib import Path

_ANSI = {"red": "\x1b[31m", "green": "\x1b[32m", "yellow": "\x1b[33m",
         "blue": "\x1b[34m", "magenta": "\x1b[35m", "cyan": "\x1b[36m",
         "white": "\x1b[37m", "reset": "\x1b[0m"}


def _c(color: str, text: str) -> str:
    if sys.stdout.isatty():
        return f"{_ANSI[color]}{text}{_ANSI['reset']}"
    return text


class CLITetraListener:
    """Colored frame/status printer (ui/modern.py:5422-5493)."""

    _TYPE_COLORS = [("MAC-RESOURCE", "blue"), ("MAC-BROADCAST", "yellow"),
                    ("MAC-FRAG", "green"), ("MAC-SUPPL", "magenta"),
                    ("MAC-U-SIGNAL", "red"), ("MAC-DATA", "cyan")]

    def __init__(self, loop):
        self.loop = loop
        self.start_time = datetime.now()
        self.signal_active = False
        self.frame_count = 0
        loop.on_status = self.on_status
        loop.on_error = self.on_error
        loop.on_signal = self.on_signal
        loop.on_signal_lost = self.on_signal_lost
        loop.on_frame = self.on_frame

    def on_status(self, msg):
        print(_c("cyan", f"[STATUS] {msg}"))

    def on_error(self, msg):
        print(_c("red", f"[ERROR] {msg}"))

    def on_signal(self, freq, snr):
        if not self.signal_active:
            print(_c("green", f"[SIGNAL] TETRA Detected at {freq / 1e6:.4f} "
                              f"MHz (SNR: {snr:.1f} dB)"))
            self.signal_active = True

    def on_signal_lost(self):
        if self.signal_active:
            print(_c("yellow", f"[SIGNAL] Signal Lost "
                               f"(decoded {self.frame_count} frames)"))
            self.signal_active = False

    def on_frame(self, frame):
        self.frame_count += 1
        ts = datetime.now().strftime("%H:%M:%S.%f")[:-3]
        fn = frame.get("number", "?")
        ftype = frame.get("type_name", "Unknown")
        color = "white"
        for key, col in self._TYPE_COLORS:
            if key in ftype:
                color = col
                break
        enc = ""
        if frame.get("decrypted"):
            enc = _c("green", "[DEC]")
        elif frame.get("encrypted"):
            enc = _c("red", "[ENC]")
        content = ""
        if "sds_message" in frame:
            content = _c("cyan", f"SDS: {frame['sds_message']}")
        elif "decoded_text" in frame:
            content = _c("cyan", f"TXT: {frame['decoded_text']}")
        elif frame.get("has_voice"):
            content = _c("green", "Voice Audio")
        print(f"[{ts}] #{fn:<4} {_c(color, f'{ftype:<15}')} {enc} {content}")


def _receiver_config(args):
    from tetraear_tpu.config import ReceiverConfig
    profile = getattr(args, "profile", "ref-compat")
    if profile == "ref-compat":
        return None
    return ReceiverConfig(profile=profile,
                          sample_rate_hz=args.sample_rate * 1e6)


def _make_source(args):
    from tetraear_tpu.io.replay import FileReplaySource, SyntheticSource
    if args.iq_file:
        return FileReplaySource(args.iq_file,
                                sample_rate=args.sample_rate * 1e6,
                                frequency=args.frequency * 1e6,
                                loop=getattr(args, "loop", False),
                                realtime=getattr(args, "realtime", False))
    if getattr(args, "synthetic", False):
        return SyntheticSource(active_frequencies=(args.frequency * 1e6,),
                               sample_rate=args.sample_rate * 1e6,
                               frequency=args.frequency * 1e6)
    from tetraear_tpu.io.capture import BladeRFCapture
    return BladeRFCapture(frequency=args.frequency * 1e6,
                          sample_rate=args.sample_rate * 1e6,
                          gain=args.gain,
                          device_identifier=getattr(args, "device", None))


def _load_keys(args, loop_or_decoder):
    if getattr(args, "key_file", None):
        keys = []
        for line in Path(args.key_file).read_text().splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            keys.append(line.split(":")[-1])
        loop_or_decoder.set_keys(keys)


def cmd_tui(args) -> int:
    """Interactive terminal UI (ui/tui.py): live waterfall + tables +
    SDS feed + key toggles + voice playback — the terminal counterpart of
    the reference's ModernTetraGUI (modern.py:2518-5420)."""
    from tetraear_tpu.audio.playback import AudioSink
    from tetraear_tpu.ui.capture_loop import CaptureLoop
    from tetraear_tpu.ui.logging_setup import get_records_dir
    from tetraear_tpu.ui.tui import TerminalUI

    source = _make_source(args)
    loop = CaptureLoop(
        source,
        frequency=args.frequency * 1e6,
        sample_rate=args.sample_rate * 1e6,
        auto_decrypt=args.auto_decrypt,
        always_decode=bool(args.iq_file or args.synthetic),
        afc=not args.no_afc,
        overlap=args.overlap,
        receiver_config=_receiver_config(args),
    )
    _load_keys(args, loop)
    sink = AudioSink(record_dir=(str(get_records_dir())
                                 if args.record else None))
    ui = TerminalUI(loop, audio_sink=sink)
    try:
        ui.run(max_chunks=args.max_chunks, duration_s=args.duration)
    except KeyboardInterrupt:
        loop.stop(join=False)
    print(ui.state.session.summary())
    return 0


def cmd_listen(args) -> int:
    from tetraear_tpu.io.recorder import JsonlFrameRecorder
    from tetraear_tpu.ui.capture_loop import CaptureLoop
    from tetraear_tpu.ui.logging_setup import get_records_dir

    print(_c("cyan", "TetraEar-TPU - CLI Mode"))
    print(f"Frequency: {args.frequency} MHz")
    print(f"Gain: {args.gain} dB")
    print(f"Sample Rate: {args.sample_rate} MHz")

    source = _make_source(args)
    loop = CaptureLoop(
        source,
        frequency=args.frequency * 1e6,
        sample_rate=args.sample_rate * 1e6,
        auto_decrypt=args.auto_decrypt,
        monitor_raw=args.monitor_audio,
        records_dir=str(get_records_dir()) if args.record else None,
        always_decode=bool(args.iq_file or args.synthetic),
        afc=not args.no_afc,
        overlap=args.overlap,
        receiver_config=_receiver_config(args),
    )
    listener = CLITetraListener(loop)
    from tetraear_tpu.ui.session import SessionAggregator
    session = SessionAggregator()
    _orig_on_frame = loop.on_frame

    def _frame_with_session(frame):
        session.on_frame(frame)
        _orig_on_frame(frame)
    loop.on_frame = _frame_with_session
    _load_keys(args, loop)

    wf_buffer = None
    if args.waterfall:
        from tetraear_tpu.ui.waterfall import WaterfallBuffer
        wf_buffer = WaterfallBuffer()
        loop.on_spectrum = lambda freqs, power: wf_buffer.update_spectrum(
            freqs, power)

    recorder = None
    if args.out_jsonl:
        recorder = JsonlFrameRecorder(args.out_jsonl)
        prev = loop.on_frame

        def on_frame(frame):
            recorder.write(frame)
            prev(frame)
        loop.on_frame = on_frame

    from tetraear_tpu.utils.metrics import profile_trace
    try:
        with profile_trace(args.trace_dir):
            loop.run(max_chunks=args.max_chunks)
    except KeyboardInterrupt:
        print(_c("yellow", "\nStopping..."))
        loop.stop(join=False)
    finally:
        if recorder:
            recorder.close()
        if wf_buffer is not None and wf_buffer.history:
            from tetraear_tpu.ui.waterfall import (render_waterfall_rgb,
                                                   save_ppm)
            save_ppm(args.waterfall, render_waterfall_rgb(wf_buffer))
            print(f"Waterfall image: {args.waterfall}")
    print(f"Decoded {listener.frame_count} frames "
          f"from {loop.chunks_processed} chunks")
    print(loop.meter.summary())
    print(session.summary())
    return 0


def cmd_uplink(args) -> int:
    """Isolated uplink-burst monitor: NUB/CB located by midamble
    correlation, decoded with cell scrambling learned from the downlink
    (models/uplink.py) — mobile-side monitoring the reference (downlink-
    only, SURVEY §1) has no equivalent of.  --simulate synthesizes a
    burst sequence (legacy-layout + true U-* CMCE layer 3) first."""
    import dataclasses
    import json

    import numpy as np
    from tetraear_tpu.models.uplink import UplinkMonitor, UplinkTransmitter
    from tetraear_tpu.ops.scramble import extended_colour_code
    from tetraear_tpu.protocol.layer3 import describe_pdu

    ecc = extended_colour_code(args.mcc, args.mnc, args.colour_code)
    if args.simulate:
        from tetraear_tpu.protocol import cmce, sds_tl
        from tetraear_tpu.utils.synth import make_mac_block_bits
        tx = UplinkTransmitter(ecc)
        bursts_tx = [
            tx.nub_bits(make_mac_block_bits(b"LEGACY UPLINK SDS", seed=1)),
            tx.access_cb(cmce.USdsData(called_party=cmce.Address(0, 0x2A),
                                       short_data_type=0,
                                       user_data=0xBEEF), ssi=0xABCD),
            tx.signalling_nub(cmce.USetup(
                basic_service_info=0, call_priority=5,
                called_party=cmce.Address(1, 0x2328)), ssi=0x777),
            tx.signalling_nub(cmce.USdsData(
                called_party=cmce.Address(1, 0x2328), short_data_type=3,
                data_bits=sds_tl.build_text_transfer("uplink report 7")),
                ssi=0x777),
        ]
        if args.continuous:
            # slot-synchronous simulation: signalling on odd slots, and
            # (when the codec is built) REAL ACELP-coded speech on TN3
            # (anchor 1:1:1 -> TN = k%4 + 1, slots 2, 6, 10, ...) — the
            # uplink mirror of `downlink --simulate` voice
            from tetraear_tpu.ops import channel_coding as cc_ops
            slot_map = {2 * i + 1: b for i, b in enumerate(bursts_tx)
                        if b.size <= 510}
            n_slots = 2 * len(bursts_tx) + 2
            from tetraear_tpu.audio.voice import VoiceEncoder
            venc = VoiceEncoder()
            voice_slots = [k for k in range(n_slots) if k % 4 == 2]
            if venc.working and voice_slots:
                from tetraear_tpu.utils.synth import make_test_speech
                voc = venc.encode_pcm_bits(
                    make_test_speech(0.06 * len(voice_slots) + 0.06)
                )[:len(voice_slots)]
                t5 = cc_ops.encode_tch(voc, "TCH/S", ecc30=ecc)
                for k, blk in zip(voice_slots, t5):
                    slot_map[k] = tx.traffic_nub(blk)
                print(f"[SIM] TN3 carries {len(t5)} uplink TCH/S blocks "
                      "of real ACELP-coded speech")
            iq = tx.transmit_slots(slot_map, n_slots,
                                   lead_bits=120, snr_db=args.snr_db,
                                   seed=2)
        else:
            iq = tx.transmit(bursts_tx, snr_db=args.snr_db, seed=2)
        if args.iq_file:
            iq.tofile(args.iq_file)
            print(f"[SIM] wrote {len(iq)} samples -> {args.iq_file}")
    else:
        if not args.iq_file:
            print(_c("red", "[FAIL] need an IQ file (or --simulate)"))
            return 1
        iq = np.fromfile(args.iq_file, dtype=np.complex64)

    t0 = time.time()
    if args.continuous:
        from tetraear_tpu.models.uplink import UplinkSlotMonitor
        anchor = tuple(int(v) for v in args.anchor.split(":"))
        frames = UplinkSlotMonitor(
            ecc, anchor=anchor,
            traffic_tns={3: "TCH/S"}).receive(iq)
    else:
        frames = UplinkMonitor(ecc).receive(iq)
    dt = time.time() - t0
    out = open(args.out_jsonl, "w") if args.out_jsonl else None
    for f in frames:
        desc = ""
        if f.layer3:
            desc = "; ".join(describe_pdu(r) for r in f.layer3)
        elif f.mac_pdu is not None:
            desc = repr(bytes(f.mac_pdu.data))[1:]
        if f.sds_message and f.sds_message not in desc:
            desc += f" {f.sds_message}"
        print(f"bit {f.start_bit:7d} {f.kind:3s} {f.channel:7s} "
              f"crc={'-' if f.crc_ok is None else 'Y' if f.crc_ok else 'n'}"
              + (f" TN{f.tn} FN{f.fn:2d} MN{f.mn:2d} slot {f.slot_index}"
                 f"{' dt%+d' % f.timing_offset if f.timing_offset else ''}"
                 if f.tn is not None else "") + f" {desc}")
        if out:
            out.write(json.dumps({
                "start_bit": f.start_bit, "kind": f.kind,
                "channel": f.channel, "crc_ok": None if f.crc_ok is None else bool(f.crc_ok),
                "sds": f.sds_message,
                "layer3": ([describe_pdu(r) for r in f.layer3]
                           if f.layer3 else None),
                "mac_data": (bytes(f.mac_pdu.data).hex()
                             if f.mac_pdu is not None else None)}) + "\n")
    if out:
        out.close()
        print(f"[OUT] {args.out_jsonl}")
    voice_seq = [f.voice_block for f in frames
                 if getattr(f, "voice_block", None)]
    if voice_seq:
        from tetraear_tpu.audio.voice import VoiceProcessor
        vp = VoiceProcessor()
        if vp.working:
            import numpy as _np
            audio = vp.decode_stream(voice_seq)
            amp = float(_np.abs(audio).max()) if audio.size else 0.0
            print(f"[VOICE] {len(voice_seq)} uplink blocks -> "
                  f"{audio.size} PCM samples ({audio.size / 8000:.2f} s, "
                  f"peak {amp:.3f}) via ACELP synthesis")
    print(f"[DONE] {len(frames)} uplink bursts "
          f"[{len(iq)/max(dt,1e-9)/1e6:.2f} MS/s]")
    return 0


def cmd_downlink(args) -> int:
    """Full ETSI downlink decode: blind cell acquisition (BSCH), TDMA
    tracking, AACH, SCH/F signalling + TCH traffic — the capability layer
    the reference lacks entirely (models/downlink.py).  With --simulate,
    synthesizes a downlink capture first and decodes it back."""
    import dataclasses
    import json

    import numpy as np
    from tetraear_tpu.models.downlink import (DownlinkConfig,
                                              DownlinkReceiver,
                                              DownlinkTransmitter)
    from tetraear_tpu.protocol.layer3 import describe_pdu

    if args.simulate:
        from tetraear_tpu.ops.channel_coding import TCH_GEOMETRY
        from tetraear_tpu.protocol import cmce, sds_tl
        from tetraear_tpu.utils.synth import make_mac_block_bits
        cell = DownlinkConfig()
        tx = DownlinkTransmitter(cell)
        rng = np.random.default_rng(0)
        # 268-bit SCH/F block fits 29 payload bytes after the 35-bit header
        payloads = {k: make_mac_block_bits(
            f"{args.message} #{k}".encode()[:29], seed=k)
            for k in range(args.slots) if k % 4 == 1}
        # real CMCE signalling on TN4: group-call lifecycle + SDS-TL text;
        # the D-SETUP's MAC channel allocation names TN3 (where the
        # traffic stream below rides) so the receiver attributes the
        # voice to call 41 / this talkgroup (call-following)
        from tetraear_tpu.protocol.mac import ChannelAllocation
        group, talker = 0x2328, 0x457
        alloc = ChannelAllocation(allocation_type=1, timeslots=0b0010,
                                  carrier_number=cell.main_carrier)
        seq = [cmce.DSetup(call_identifier=41, call_priority=5,
                           transmission_grant=1,
                           calling_party=cmce.Address(1, talker)),
               cmce.DTxGranted(call_identifier=41, transmission_grant=1,
                               transmitting_party=cmce.Address(1, talker)),
               cmce.DSdsData(calling_party=cmce.Address(1, talker),
                             short_data_type=3,
                             data_bits=sds_tl.build_text_transfer(
                                 f"{args.message} via SDS-TL")),
               cmce.DTxCeased(call_identifier=41),
               cmce.DRelease(call_identifier=41, disconnect_cause=2)]
        slot = 3
        for pdu in seq:
            if slot >= args.slots:
                break
            kw = ({"channel_allocation": alloc}
                  if isinstance(pdu, cmce.DSetup) else {})
            slot = tx.schedule_signalling(payloads, pdu, group, slot,
                                          args.slots, **kw)
        k1 = TCH_GEOMETRY[args.traffic_channel][0]
        voc = None
        if args.traffic_channel == "TCH/S":
            # real coded speech over the air: synthesized PCM through the
            # spec-derived scoder+ccoder (native/codec/) so the received
            # voice blocks decode to actual ACELP audio below
            from tetraear_tpu.audio.voice import VoiceEncoder
            from tetraear_tpu.utils.synth import make_test_speech
            venc = VoiceEncoder()
            if venc.working:
                n_blocks = max(1, args.slots // 4)
                pcm = make_test_speech(n_blocks * 0.06 + 0.06)
                voc = venc.encode_pcm_bits(pcm)[:n_blocks]
                print(f"[SIM] TCH/S carries {len(voc)} blocks of real "
                      "ACELP-coded speech (native/codec)")
        if voc is None or len(voc) == 0:
            voc = rng.integers(0, 2, (max(1, args.slots // 4), k1)
                               ).astype(np.uint8)
        bits = tx.stream_bits(args.slots, payloads=payloads,
                              tch_streams={3: (args.traffic_channel, voc,
                                               args.traffic_depth)})
        iq = tx.modulate(bits, snr_db=args.snr_db, seed=1)
        if args.iq_file:
            iq.tofile(args.iq_file)
            print(f"[SIM] wrote {len(iq)} samples -> {args.iq_file}")
    else:
        if not args.iq_file:
            print(_c("red", "[FAIL] need an IQ file (or --simulate)"))
            return 1
        iq = np.fromfile(args.iq_file, dtype=np.complex64)

    if args.survey > 0:
        from tetraear_tpu.models.downlink import survey_cells
        t0 = time.time()
        cells = survey_cells(iq, num_carriers=args.survey)
        dt = time.time() - t0
        for r in cells:
            nb = (f" neighbours={','.join(map(str, r.neighbours))}"
                  if r.neighbours else "")
            print(f"carrier {r.carrier_index:3d} ({r.offset_hz/1e3:+7.1f} "
                  f"kHz): MCC={r.mcc} MNC={r.mnc} CC={r.colour_code} "
                  f"LA={r.location_area} slots={r.slots_decoded} "
                  f"crc={100*r.crc_rate:.0f}%{nb}")
        print(f"[DONE] {len(cells)} cells found across {args.survey} "
              f"carriers  [{len(iq)/max(dt,1e-9)/1e6:.2f} MS/s]")
        return 0

    rx = DownlinkReceiver(traffic_channel=args.traffic_channel,
                          traffic_depth=args.traffic_depth)
    offset = ("auto" if args.freq_offset == "auto"
              else float(args.freq_offset))
    t0 = time.time()
    frames = rx.receive(iq, freq_offset=offset)
    dt = time.time() - t0
    if not frames:
        print(_c("yellow", "[NO CELL] no decodable synchronization burst"))
        return 1

    out = None
    if args.out_jsonl:
        out = open(args.out_jsonl, "w")
    crc_pass = 0
    voice_blocks = 0
    for f in frames:
        crc_pass += bool(f.crc_ok)
        voice_blocks += f.voice_block is not None
        desc = ""
        if f.sync_pdu:
            desc = (f"MCC={f.sync_pdu.mcc} MNC={f.sync_pdu.mnc} "
                    f"CC={f.sync_pdu.colour_code}")
        if f.sysinfo:
            desc += (f" LA={f.sysinfo.location_area} "
                     f"carrier={f.sysinfo.main_carrier}")
        if f.mac_pdu is not None:
            desc = repr(bytes(f.mac_pdu.data))[1:]
        if f.layer3:
            desc = "; ".join(describe_pdu(r) for r in f.layer3)
        if f.sds_message:
            desc += f" {f.sds_message}"
        if f.voice_block:
            desc = f"voice block ({len(f.voice_block)} B)"
            if f.call_metadata is not None:
                desc += (f" [call {f.call_metadata.call_identifier} "
                         f"tg {f.call_metadata.talkgroup_id}]")
        print(f"TN{f.tn} FN{f.fn:2d} MN{f.mn:2d} {f.burst_kind:3s} "
              f"{f.channel:11s} crc={'-' if f.crc_ok is None else 'Y' if f.crc_ok else 'n'} "
              f"aach={f.aach.downlink_usage:14s} {desc}")
        if out:
            out.write(json.dumps({
                "slot": f.slot_index, "tn": f.tn, "fn": f.fn, "mn": f.mn,
                "burst": f.burst_kind, "channel": f.channel,
                "crc_ok": None if f.crc_ok is None else bool(f.crc_ok),
                "aach_usage": f.aach.downlink_usage,
                "mcc": f.sync_pdu.mcc if f.sync_pdu else None,
                "mnc": f.sync_pdu.mnc if f.sync_pdu else None,
                "sds": f.sds_message,
                "mac_data": (bytes(f.mac_pdu.data).hex()
                             if f.mac_pdu is not None else None),
                "layer3": ([describe_pdu(r) for r in f.layer3]
                           if f.layer3 else None),
                "call": (dataclasses.asdict(f.call_metadata)
                         if f.call_metadata is not None else None),
                "voice": f.voice_block is not None}) + "\n")
    if out:
        out.close()
        print(f"[OUT] {args.out_jsonl}")
    if args.traffic_depth > 1:
        # deep-interleaved data channels resolve per TN after the walk
        for t in sorted({f.tn for f in frames if f.tch_llrs is not None}):
            blocks = rx.decode_traffic_stream(frames, tn=t)
            print(f"[TCH] TN{t}: {blocks.shape[0]} "
                  f"{args.traffic_channel} blocks de-interleaved "
                  f"(depth {args.traffic_depth})")

    voice_seq = [f.voice_block for f in frames if f.voice_block]
    if voice_seq:
        # run the received TCH/S blocks through the real codec chain
        # (cdecoder: de-interleave + Viterbi + CRC; sdecoder: ACELP
        # synthesis) — one invocation keeps decoder state across blocks
        from tetraear_tpu.audio.voice import VoiceProcessor
        vp = VoiceProcessor()
        if vp.working:
            audio = vp.decode_stream(voice_seq)
            amp = float(np.abs(audio).max()) if audio.size else 0.0
            print(f"[VOICE] {len(voice_seq)} blocks -> {audio.size} PCM "
                  f"samples ({audio.size / 8000:.2f} s, peak {amp:.3f}) "
                  "via ACELP synthesis")
            if getattr(args, "voice_wav", None) and audio.size:
                import wave
                with wave.open(args.voice_wav, "wb") as w:
                    w.setnchannels(1)
                    w.setsampwidth(2)
                    w.setframerate(8000)
                    w.writeframes((np.clip(audio, -1, 1) * 32767
                                   ).astype(np.int16).tobytes())
                print(f"[VOICE] wrote {args.voice_wav}")
        else:
            print("[VOICE] codec binaries not found "
                  "(make -C native/codec install)")
    rate = len(iq) / max(dt, 1e-9) / 1e6
    print(f"[DONE] {len(frames)} slots, {crc_pass} CRC-pass, "
          f"{voice_blocks} voice blocks  [{rate:.2f} MS/s]")
    return 0


def cmd_decode(args) -> int:
    """Offline conformance path: IQ file -> frames JSONL
    (continuous_capture.py:17-148 shape).  With --carriers N the wideband
    input is channelized on device and every carrier is decoded (config 4)."""
    import numpy as np
    from tetraear_tpu.core.decoder import TetraDecoder
    from tetraear_tpu.io.recorder import JsonlFrameRecorder
    from tetraear_tpu.io.replay import FileReplaySource
    from tetraear_tpu.models.receiver import SignalProcessor

    source = FileReplaySource(args.iq_file,
                              sample_rate=args.sample_rate * 1e6)
    if not source.open():
        print(_c("red", f"[FAIL] Could not open {args.iq_file}"))
        return 1
    if args.carriers > 0:
        return _decode_multicarrier(args, source)
    processor = SignalProcessor(sample_rate=args.sample_rate * 1e6,
                                config=_receiver_config(args))
    decoder = TetraDecoder(auto_decrypt=args.auto_decrypt)
    _load_keys(args, decoder)

    out_path = args.out_jsonl or (str(Path(args.iq_file).with_suffix("")) +
                                  "_frames.jsonl")
    chunk = args.chunk_size
    frame_count = unencrypted = 0
    t0 = time.time()
    samples_total = 0
    # per-stage timing: first chunk carries the XLA compile; steady-state
    # device wait + host decode are what scale with capture length
    t_first = t_wait = t_decode = 0.0
    n_chunks = 0

    def _fetch_hard(res) -> "np.ndarray":
        """Materialize the previous chunk's device result (the only
        blocking D2H of the loop)."""
        count = int(res.count)
        if count < 2:
            return np.array([], dtype=np.uint8)
        return np.asarray(res.hard_symbols)[:count - 1]

    with JsonlFrameRecorder(out_path, include_bits=not args.no_bits) as rec:
        # software pipeline: dispatch chunk i+1 to the device BEFORE
        # pulling + host-decoding chunk i, so device compute and host
        # parsing overlap (JAX dispatch is async; the D2H pull in
        # _fetch_hard is the only sync point).  Serial measured 20 MS/s
        # combined vs ~60 MS/s host / ~100 MS/s device individually —
        # the overlap removes the sum-of-stages penalty.
        pending = None
        while not source.exhausted:
            samples = source.read_samples(chunk)
            if len(samples) == 0:
                break
            samples_total += len(samples)
            if len(samples) < chunk:
                # pad the tail chunk to the fixed block size: one shape ->
                # one compile (trailing zeros demodulate to no sync hits)
                import numpy as _np
                samples = _np.pad(samples, (0, chunk - len(samples)))
            ts = time.time()
            res = processor.process_full(samples)
            t_stage = time.time() - ts
            n_chunks += 1
            if n_chunks == 1:
                t_first = t_stage
            if pending is None:
                pending = res
                continue
            ts = time.time()
            demod = _fetch_hard(pending)
            t_wait += time.time() - ts
            pending = res
            if len(demod) < 255:
                continue
            ts = time.time()
            frames = decoder.decode(demod)
            t_decode += time.time() - ts
            for frame in frames:
                frame_count += 1
                rec.write(frame)
                if not frame.get("encrypted", True):
                    unencrypted += 1
                    text = (frame.get("decoded_text", "")
                            or frame.get("sds_message", ""))
                    if text and not text.startswith("[BIN"):
                        print(f"[READABLE] Frame {frame_count}: {text[:100]}")
        if pending is not None:
            demod = _fetch_hard(pending)
            if len(demod) >= 255:
                for frame in decoder.decode(demod):
                    frame_count += 1
                    rec.write(frame)
                    if not frame.get("encrypted", True):
                        unencrypted += 1
                        text = (frame.get("decoded_text", "")
                                or frame.get("sds_message", ""))
                        if text and not text.startswith("[BIN"):
                            print(f"[READABLE] Frame {frame_count}: "
                                  f"{text[:100]}")
    dt = time.time() - t0
    rate = samples_total / max(dt, 1e-9)
    print(f"[DONE] {frame_count} frames ({unencrypted} clear) from "
          f"{samples_total} samples -> {out_path}")
    if n_chunks > 1:
        steady = (samples_total - chunk) / max(dt - t_first, 1e-9)
        wait_r = (samples_total - chunk) / max(t_wait, 1e-9)
        dec_r = (samples_total - chunk) / max(t_decode, 1e-9)
        print(f"[PERF] {steady / 1e6:.2f} MS/s steady-state pipelined "
              f"(device wait {wait_r / 1e6:.1f} MS/s, decode "
              f"{dec_r / 1e6:.1f} MS/s host); first chunk incl. compile "
              f"{t_first:.2f}s; total {rate / 1e6:.2f} MS/s")
    else:
        print(f"[PERF] {rate / 1e6:.2f} MS/s through demod+decode "
              f"(single chunk, compile-dominated — steady-state is higher)")
    stats = decoder.protocol_parser.get_statistics()
    print(f"[STATS] bursts={stats['total_bursts']} "
          f"crc_rate={stats['crc_success_rate']:.1f}%")
    return 0


def _decode_multicarrier(args, source) -> int:
    import numpy as np
    from tetraear_tpu.io.recorder import JsonlFrameRecorder
    from tetraear_tpu.models.multicarrier import (MulticarrierDecoder,
                                                  MulticarrierFrontend)
    from tetraear_tpu.ops.channelizer import carrier_grid

    # fused dense-conv front-ends on accelerators (decision-identical on
    # the 25 kHz grid, one space-to-depth conv); staged chains on CPU
    # where the dense kernel's extra FLOPs would lose.
    import jax
    accel = jax.default_backend() != "cpu"
    conv = getattr(args, "conv", "auto")
    # an EXPLICIT --conv is honored on every backend (fail-loudly rule:
    # the requested variant must run or error, never silently swap);
    # "auto" picks the default per backend
    if getattr(args, "pfb", False):
        # full-band polyphase filterbank: every 25 kHz channel at once
        from tetraear_tpu.models.multicarrier import PfbMulticarrierFrontend
        if conv == "s2d_of":
            raise SystemExit("--conv s2d_of is a 16-carrier variant; "
                             "the PFB supports s2d, s2d_mono, s2d_hb16")
        fused = ("s2d" if accel else False) if conv == "auto" else conv
        pfb_fe = PfbMulticarrierFrontend(fused=fused)
        args.carriers = pfb_fe.num_channels
        offsets = pfb_fe.channel_offsets_hz()
        mc = lambda samples, offs, start_index=0: pfb_fe(samples)  # noqa: E731
    else:
        if conv in ("s2d_mono", "s2d_hb16"):
            raise SystemExit(f"--conv {conv} is a PFB (--pfb) variant; "
                             "the DDC bank supports s2d, s2d_of")
        fused = ("s2d" if accel else False) if conv == "auto" else conv
        mc = MulticarrierFrontend(fused=fused)
        offsets = carrier_grid(args.carriers)
    dec = MulticarrierDecoder(args.carriers, auto_decrypt=args.auto_decrypt)
    out_path = args.out_jsonl or (str(Path(args.iq_file).with_suffix(""))
                                  + "_frames.jsonl")
    chunk = args.chunk_size
    frame_count = 0
    per_carrier = [0] * args.carriers
    t0 = time.time()
    samples_total = 0
    start_index = 0
    def _emit(res):
        nonlocal frame_count
        for frames in dec.decode(res):
            for frame in frames:
                frame_count += 1
                per_carrier[frame["carrier"]] += 1
                rec.write(frame)

    with JsonlFrameRecorder(out_path, include_bits=not args.no_bits) as rec:
        # software pipeline: dispatch chunk i+1 before host-decoding chunk
        # i so device compute overlaps host parsing (dec.decode's
        # np.asarray pulls are the only sync points)
        pending = None
        afc_hz = 0.0
        fs = args.sample_rate * 1e6
        while not source.exhausted:
            samples = source.read_samples(chunk)
            if len(samples) == 0:
                break
            samples_total += len(samples)
            if getattr(args, "afc", False):
                # grid-comb AFC: one shared tuner offset for every carrier
                # (ops/spectrum.estimate_grid_offset_hz); estimated on the
                # REAL samples (before tail-padding), EMA-smoothed, and
                # the derotation phase restarts per chunk only when the
                # estimate moves (sub-Hz jitter is clamped)
                from tetraear_tpu.ops.spectrum import estimate_grid_offset_hz
                est = estimate_grid_offset_hz(samples, fs)
            if len(samples) < chunk:
                samples = np.pad(samples, (0, chunk - len(samples)))
            if getattr(args, "afc", False):
                new = est if pending is None else 0.8 * afc_hz + 0.2 * est
                if abs(new - afc_hz) > 1.0 or pending is None:
                    afc_hz = new
                    print(f"[AFC] grid offset {afc_hz:+.0f} Hz")
                if abs(afc_hz) > 1.0:
                    t = (start_index + np.arange(len(samples))) / fs
                    samples = (samples * np.exp(-2j * np.pi * afc_hz * t)
                               ).astype(np.complex64)
            res = mc(samples, offsets, start_index=start_index)
            start_index += chunk
            if pending is not None:
                _emit(pending)
            pending = res
        if pending is not None:
            _emit(pending)
    dt = time.time() - t0
    print(f"[DONE] {frame_count} frames across {args.carriers} carriers "
          f"-> {out_path}")
    print(f"[PERF] {samples_total / max(dt, 1e-9) / 1e6:.2f} MS/s wideband "
          f"through {args.carriers}-carrier demod+decode")
    hot = {c: n for c, n in enumerate(per_carrier) if n}
    print(f"[CARRIERS] frames per carrier: {hot}")
    return 0


def cmd_scan(args) -> int:
    from tetraear_tpu.signal.scanner import FrequencyScanner
    source = _make_source(args)
    if not source.open():
        print(_c("red", "[FAIL] Could not open source"))
        return 1
    scanner = FrequencyScanner(source, sample_rate=args.sample_rate * 1e6,
                               scan_step=25e3,
                               settle_s=0.0 if (args.iq_file or args.synthetic)
                               else 0.05)
    start, stop = args.start * 1e6, args.stop * 1e6
    if args.wideband:
        center = (start + stop) / 2
        print(f"Wideband sweep centered {center / 1e6:.3f} MHz "
              f"({args.sample_rate:.1f} MHz span, one capture)...")
        results = [r for r in scanner.scan_wideband(center)
                   if start <= r["frequency"] <= stop]
        for r in sorted(results, key=lambda x: -x["power_db"])[:20]:
            tag = " *** TETRA" if r.get("is_tetra") else ""
            print(f"  {r['frequency_mhz']:.3f} MHz: "
                  f"{r['power_db']:.1f} dB{tag}")
        source.close()
        return 0
    print(f"Scanning {args.start:.3f} - {args.stop:.3f} MHz...")
    results = []
    freq = start
    while freq <= stop:
        result = scanner.scan_frequency(freq)
        if result["power_db"] > -60:
            results.append(result)
            print(f"  {freq / 1e6:.3f} MHz: {result['power_db']:.1f} dB"
                  + (" *** TETRA" if result.get("is_tetra") else " *** SIGNAL"))
        freq += 25e3
    source.close()
    if results:
        results.sort(key=lambda x: x["power_db"], reverse=True)
        best = results[0]
        print(_c("green", f"\n[OK] Best signal: "
                          f"{best['frequency'] / 1e6:.3f} MHz "
                          f"({best['power_db']:.1f} dB)"))
    else:
        print(_c("yellow", "\n[X] No strong signals found"))
    return 0


def cmd_waterfall(args) -> int:
    """Render an IQ capture's waterfall to a PNG/PPM image.

    The headless pixel-surface equivalent of the reference GUI's waterfall
    widget (modern.py:649-1362): same WaterfallBuffer history + IIR
    denoiser + blue-cyan-yellow-red colormap, batched device FFTs instead
    of a Qt repaint loop.  Interactive affordances (zoom drag,
    click-to-tune) stay TUI/compute-level — see MIGRATION.md."""
    import jax.numpy as jnp
    import numpy as np
    from tetraear_tpu.io.replay import load_iq
    from tetraear_tpu.ops.spectrum import spectrum_frames_dbfs
    from tetraear_tpu.ui.waterfall import (WaterfallBuffer,
                                           render_waterfall_rgb, save_png,
                                           save_ppm)

    x = load_iq(args.iq_file)
    if x.size == 0:
        print(_c("red", f"[FAIL] empty capture {args.iq_file}"))
        return 1
    n_fft = args.fft_size
    rows = max(1, args.rows)
    hop = max((len(x) - n_fft) // max(rows - 1, 1), 1) if len(x) > n_fft \
        else n_fft
    power = np.asarray(spectrum_frames_dbfs(jnp.asarray(x), n_fft, hop))
    if power.shape[0] == 0:
        print(_c("red", "[FAIL] capture shorter than one FFT frame"))
        return 1

    buf = WaterfallBuffer(denoise=args.denoise, history=rows)
    freqs = np.zeros(n_fft)   # buffer keys rows by time only
    for row in power[:rows]:
        buf.update_spectrum(freqs, row)
    lo = float(np.percentile(power, 5))
    hi = float(np.percentile(power, 99.9))
    rgb = render_waterfall_rgb(buf, floor_db=lo, top_db=max(hi, lo + 1.0))
    out = Path(args.out or (str(Path(args.iq_file).with_suffix(""))
                            + "_waterfall.png"))
    if out.suffix.lower() == ".ppm":
        save_ppm(out, rgb)
    else:
        save_png(out, rgb)
    print(_c("green", f"[OK] {rgb.shape[1]}x{rgb.shape[0]} waterfall "
                      f"({lo:.1f}..{hi:.1f} dBFS) -> {out}"))
    return 0


def cmd_codec(args) -> int:
    """Offline voice-codec workflows over the spec-derived executables
    (native/codec/): encode PCM/WAV -> coded .tet blocks, decode .tet ->
    WAV.  The operator-facing face of the chain `downlink --simulate`
    and the voice path use internally."""
    import wave

    import numpy as np
    from tetraear_tpu.audio.voice import VoiceEncoder, VoiceProcessor

    def read_pcm(path: Path) -> np.ndarray:
        if path.suffix.lower() == ".wav":
            with wave.open(str(path), "rb") as w:
                assert w.getsampwidth() == 2, "need 16-bit WAV"
                if w.getframerate() != 8000:
                    print(_c("yellow", f"note: {w.getframerate()} Hz WAV; "
                                       "codec expects 8 kHz"))
                channels = w.getnchannels()
                raw = w.readframes(w.getnframes())
            pcm = np.frombuffer(raw, np.int16)
            if channels > 1:
                pcm = pcm.reshape(-1, channels)[:, 0].copy()
            return pcm
        return np.fromfile(path, np.int16)

    def write_wav(path: Path, audio: np.ndarray) -> None:
        with wave.open(str(path), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(8000)
            w.writeframes((np.clip(audio, -1, 1) * 32767
                           ).astype(np.int16).tobytes())

    src = Path(args.input)
    dst = Path(args.out) if args.out else None
    if args.direction == "encode":
        enc = VoiceEncoder(codec_dir=args.codec_dir)
        if not enc.working:
            print(_c("red", "[FAIL] scoder/ccoder not found "
                            "(make -C native/codec install)"))
            return 1
        pcm = read_pcm(src)
        blocks = enc.encode_pcm(pcm)
        if not blocks:
            print(_c("red", "[FAIL] encode produced no blocks"))
            return 1
        dst = dst or src.with_suffix(".tet")
        dst.write_bytes(b"".join(blocks))
        print(_c("green", f"[OK] {len(pcm)} samples "
                          f"({len(pcm) / 8000:.2f} s) -> {len(blocks)} "
                          f"coded TCH/S blocks -> {dst}"))
        return 0

    vp = VoiceProcessor(codec_dir=args.codec_dir)
    if not vp.working:
        print(_c("red", "[FAIL] cdecoder/sdecoder not found "
                        "(make -C native/codec install)"))
        return 1
    from tetraear_tpu import constants as C
    raw = src.read_bytes()
    blk = C.CODEC_BLOCK_BYTES
    nblk = len(raw) // blk
    blocks = [raw[i * blk:(i + 1) * blk] for i in range(nblk)]
    audio = vp.decode_stream(blocks)
    if audio.size == 0:
        print(_c("red", "[FAIL] no decodable blocks"))
        return 1
    dst = dst or src.with_suffix(".wav")
    write_wav(dst, audio)
    print(_c("green", f"[OK] {nblk} blocks -> {audio.size} PCM samples "
                      f"({audio.size / 8000:.2f} s) -> {dst}"))
    return 0


def cmd_frames(args) -> int:
    """Query a frames-JSONL log: the headless face of the reference GUI's
    Calls/Groups/Users/Message-Type dropdown filters and statistics panel
    (modern.py; MIGRATION.md 'filtering' row)."""
    from tetraear_tpu.io.frames_query import (FrameFilter, filter_frames,
                                              format_frame_line,
                                              frames_stats, read_frames)
    src = Path(args.log)
    if not src.exists():
        print(_c("red", f"[FAIL] {src} not found"))
        return 1
    encrypted = None
    if args.encrypted:
        encrypted = True
    elif args.clear:
        encrypted = False
    flt = FrameFilter(
        types=tuple(t.strip().lower() for t in (args.type or [])),
        group=args.group, user=args.user,
        call_type=args.call_type.lower() if args.call_type else None,
        timeslot=args.timeslot, encrypted=encrypted,
        sds_only=args.sds_only)
    matched = filter_frames(read_frames(src), flt)

    if args.stats:
        if args.out:
            # honor both: write the matching frames AND print the panel
            # (silently dropping -o confused scripted callers) — one
            # streaming pass, no in-memory materialization (continuous-
            # capture logs can be large)
            import json as _json
            from tetraear_tpu.io.frames_query import FrameStats
            st = FrameStats()
            with open(args.out, "w", encoding="utf-8") as fp:
                for frame in matched:
                    fp.write(_json.dumps(frame) + "\n")
                    st.add(frame)
        else:
            st = frames_stats(matched)
        print(f"frames={st.total} crc_pass={st.crc_pass} "
              f"encrypted={st.encrypted} decrypted={st.decrypted} "
              f"sds={st.sds}")
        for title, counter in (("types", st.by_type), ("groups", st.groups),
                               ("users", st.users),
                               ("call types", st.call_types)):
            if counter:
                items = ", ".join(f"{k}:{v}" for k, v
                                  in counter.most_common(args.top))
                print(f"  {title}: {items}")
        return 0

    count = 0
    out_fp = open(args.out, "w", encoding="utf-8") if args.out else None
    try:
        import json as _json
        for frame in matched:
            count += 1
            if out_fp:
                out_fp.write(_json.dumps(frame) + "\n")
            else:
                print(format_frame_line(frame))
    finally:
        if out_fp:
            out_fp.close()
    where = f" -> {args.out}" if args.out else ""
    print(_c("green", f"[OK] {count} frames matched{where}"))
    return 0


def cmd_devices(_args) -> int:
    from tetraear_tpu.io.capture import BLADERF_AVAILABLE, list_bladerf_devices
    if not BLADERF_AVAILABLE:
        print("bladerf module not available on this host")
        return 1
    devices = list_bladerf_devices()
    if not devices:
        print("No BladeRF devices found")
        return 1
    for d in devices:
        print(f"serial={d['serial']} bus={d['usb_bus']} addr={d['usb_addr']}")
    return 0


def _add_common(p):
    p.add_argument("-f", "--frequency", type=float, default=390.865,
                   help="Frequency in MHz (default: 390.865)")
    p.add_argument("-g", "--gain", type=float, default=50.0,
                   help="RF gain in dB (default: 50.0)")
    p.add_argument("-s", "--sample-rate", type=float, default=2.4,
                   help="Sample rate in MHz (default: 2.4)")
    p.add_argument("--iq-file", type=str, default=None,
                   help="Replay IQ from file instead of hardware")
    p.add_argument("--synthetic", action="store_true",
                   help="Use a synthetic TETRA signal source")
    p.add_argument("--auto-decrypt", action=argparse.BooleanOptionalAction,
                   default=True, help="Enable auto-decryption")
    p.add_argument("--key-file", type=str, default=None,
                   help="ALG:ID:HEX key file for decryption")
    p.add_argument("--profile", type=str, default="ref-compat",
                   choices=["ref-exact", "ref-compat", "etsi"],
                   help="receiver DSP profile (default: ref-compat)")
    p.add_argument("-v", "--verbose", action="store_true")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="tetraear_tpu",
        description="Accelerator-native TETRA receiver",
        epilog="""examples:
  tetraear_tpu listen --iq-file cap.cf32           # replay a recording
  tetraear_tpu listen -f 392.225 --synthetic        # synthetic demo source
  tetraear_tpu decode cap.cf32 -o frames.jsonl      # offline conformance run
  tetraear_tpu scan 390 392 --synthetic             # band scan
""",
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument(
        "--platform", type=str, default="default",
        choices=["default", "cpu"],
        help="device selection: default = JAX's default backend (the GPU "
             "when one is present); cpu runs everything on the host")
    sub = parser.add_subparsers(dest="command")

    p_tui = sub.add_parser("tui", help="interactive terminal UI "
                           "(waterfall + tables + SDS + key toggles)")
    _add_common(p_tui)
    p_tui.add_argument("--device", type=str, default=None)
    p_tui.add_argument("--record", action="store_true",
                       help="record decoded voice to a WAV in records/")
    p_tui.add_argument("--loop", action="store_true",
                       help="loop replay file")
    p_tui.add_argument("--realtime", action="store_true",
                       help="pace replay at capture rate")
    p_tui.add_argument("--no-afc", action="store_true")
    p_tui.add_argument("--overlap", type=int, default=0)
    p_tui.add_argument("--max-chunks", type=int, default=None)
    p_tui.add_argument("--duration", type=float, default=None,
                       help="exit after N seconds (headless demos)")
    p_tui.set_defaults(func=cmd_tui)

    p_listen = sub.add_parser("listen", help="live/replay decode loop")
    _add_common(p_listen)
    p_listen.add_argument("-m", "--monitor-audio", action="store_true")
    p_listen.add_argument("--device", type=str, default=None)
    p_listen.add_argument("--record", action="store_true",
                          help="record codec blocks to records/")
    p_listen.add_argument("--loop", action="store_true",
                          help="loop replay file")
    p_listen.add_argument("--realtime", action="store_true",
                          help="pace replay at capture rate")
    p_listen.add_argument("--no-afc", action="store_true",
                          help="disable peak-bin AFC (use for centered replays)")
    p_listen.add_argument("--waterfall", type=str, default=None,
                          help="write a waterfall image (PPM) on exit")
    p_listen.add_argument("--overlap", type=int, default=0,
                          help="IQ samples of chunk overlap (recovers frames "
                               "straddling chunk edges; duplicates deduped)")
    p_listen.add_argument("--trace-dir", type=str, default=None,
                          help="write a jax.profiler trace of the session")
    p_listen.add_argument("--max-chunks", type=int, default=None)
    p_listen.add_argument("-o", "--out-jsonl", type=str, default=None)
    p_listen.add_argument("--no-gui", action="store_true",
                          help="(compat flag; this build is always headless)")
    p_listen.set_defaults(func=cmd_listen)

    p_decode = sub.add_parser("decode", help="offline IQ file -> frames JSONL")
    p_decode.add_argument("iq_file", type=str)
    p_decode.add_argument("-s", "--sample-rate", type=float, default=2.4)
    p_decode.add_argument("--auto-decrypt", action=argparse.BooleanOptionalAction,
                          default=False)
    p_decode.add_argument("--key-file", type=str, default=None)
    p_decode.add_argument("--chunk-size", type=int, default=256 * 1024)
    p_decode.add_argument("--profile", type=str, default="ref-compat",
                          choices=["ref-exact", "ref-compat", "etsi"])
    p_decode.add_argument("--carriers", type=int, default=0,
                          help="decode N carriers channelized from the "
                               "wideband input (25 kHz grid) instead of the "
                               "single-channel path")
    p_decode.add_argument(
        "--conv", type=str, default="auto",
        choices=("auto", "s2d", "s2d_of", "s2d_mono", "s2d_hb16"),
        help="multicarrier/PFB conv variant: auto = s2d on accelerators,"
             " staged on CPU")
    p_decode.add_argument("--pfb", action="store_true",
                          help="(with --carriers) polyphase filterbank: "
                               "decode EVERY 25 kHz channel in the band "
                               "(96 at 2.4 MS/s) in one device program")
    p_decode.add_argument("--no-bits", action="store_true",
                          help="omit raw bits from the JSONL")
    p_decode.add_argument("--afc", action="store_true",
                          help="(with --carriers) estimate the shared "
                               "tuner offset of the 25 kHz channel grid "
                               "from the folded spectrum and derotate "
                               "before channelizing (hardware ppm "
                               "correction)")
    p_decode.add_argument("-o", "--out-jsonl", type=str, default=None)
    p_decode.add_argument("-v", "--verbose", action="store_true")
    p_decode.set_defaults(func=cmd_decode)

    p_dl = sub.add_parser("downlink",
                          help="full ETSI downlink decode (BSCH/AACH/TDMA)")
    p_dl.add_argument("iq_file", type=str, nargs="?", default=None)
    p_dl.add_argument("--simulate", action="store_true",
                      help="synthesize a downlink capture and decode it")
    p_dl.add_argument("--slots", type=int, default=16,
                      help="slots to simulate")
    p_dl.add_argument("--snr-db", type=float, default=25.0)
    p_dl.add_argument("--message", type=str, default="DOWNLINK SDS")
    p_dl.add_argument("--freq-offset", type=str, default="0",
                      help="carrier offset in Hz, or 'auto' (spectral-"
                           "centroid AFC)")
    p_dl.add_argument("--survey", type=int, default=0, metavar="N",
                      help="wideband cell survey over N 25 kHz carriers "
                           "instead of single-cell decode")
    p_dl.add_argument("--traffic-channel", type=str, default="TCH/S",
                      choices=["TCH/S", "TCH/7.2", "TCH/4.8", "TCH/2.4"])
    p_dl.add_argument("--traffic-depth", type=int, default=1,
                      choices=[1, 4, 8])
    p_dl.add_argument("-o", "--out-jsonl", type=str, default=None)
    p_dl.add_argument("--voice-wav", type=str, default=None,
                      help="write decoded TCH/S voice to a WAV file")
    p_dl.add_argument("-v", "--verbose", action="store_true")
    p_dl.set_defaults(func=cmd_downlink)

    p_ul = sub.add_parser("uplink",
                          help="isolated uplink-burst monitor (NUB/CB)")
    p_ul.add_argument("iq_file", type=str, nargs="?", default=None)
    p_ul.add_argument("--simulate", action="store_true",
                      help="synthesize uplink bursts and monitor them")
    p_ul.add_argument("--snr-db", type=float, default=22.0)
    p_ul.add_argument("--mcc", type=int, default=262)
    p_ul.add_argument("--mnc", type=int, default=1001)
    p_ul.add_argument("--colour-code", type=int, default=17,
                      help="cell identity learned from the downlink BSCH "
                           "(keys the uplink scrambling)")
    p_ul.add_argument("--continuous", action="store_true",
                      help="slot-synchronous monitor locked to the "
                           "downlink TDMA clock (grid acquisition + "
                           "timing recovery + TN/FN/MN labels)")
    p_ul.add_argument("--anchor", type=str, default="1:1:1",
                      help="(--continuous) TN:FN:MN of grid slot 0, as "
                           "learned from the downlink")
    p_ul.add_argument("-o", "--out-jsonl", type=str, default=None)
    p_ul.add_argument("-v", "--verbose", action="store_true")
    p_ul.set_defaults(func=cmd_uplink)

    p_scan = sub.add_parser("scan", help="scan a frequency range")
    p_scan.add_argument("start", type=float, help="start MHz")
    p_scan.add_argument("stop", type=float, help="stop MHz")
    p_scan.add_argument("--wideband", action="store_true",
                        help="one wideband capture + batched FFT sweep "
                             "instead of per-channel retuning")
    _add_common(p_scan)
    p_scan.set_defaults(func=cmd_scan)

    p_wf = sub.add_parser("waterfall",
                          help="render an IQ capture's waterfall to PNG/PPM")
    p_wf.add_argument("iq_file", type=str, help="IQ capture (.cf32/.sc16)")
    p_wf.add_argument("-o", "--out", type=str, default=None,
                      help="output image (.png or .ppm; default: "
                           "<iq>_waterfall.png)")
    p_wf.add_argument("--rows", type=int, default=200,
                      help="waterfall rows (default 200, the GUI's "
                           "history depth)")
    p_wf.add_argument("--fft-size", type=int, default=2048,
                      help="FFT size (default 2048, modern.py:1929)")
    p_wf.add_argument("--denoise", action=argparse.BooleanOptionalAction,
                      default=True, help="IIR spectrum denoiser (alpha=0.15)")
    p_wf.set_defaults(func=cmd_waterfall)

    p_cod = sub.add_parser("codec",
                           help="offline ACELP codec: PCM/WAV <-> coded "
                                ".tet blocks")
    p_cod.add_argument("direction", choices=["encode", "decode"])
    p_cod.add_argument("input", type=str,
                       help="encode: .wav/.pcm (16-bit 8 kHz); "
                            "decode: .tet (690-short blocks)")
    p_cod.add_argument("-o", "--out", type=str, default=None)
    p_cod.add_argument("--codec-dir", type=str, default=None,
                       help="override codec binary directory")
    p_cod.set_defaults(func=cmd_codec)

    p_fr = sub.add_parser("frames",
                          help="filter/summarize a frames JSONL log "
                               "(the GUI dropdown filters, headless)")
    p_fr.add_argument("log", type=str, help="frames .jsonl from decode/listen")
    p_fr.add_argument("--type", action="append", default=None,
                      metavar="NAME",
                      help="frame type_name (repeatable, e.g. MAC-RESOURCE)")
    p_fr.add_argument("--group", type=int, default=None,
                      help="talkgroup id")
    p_fr.add_argument("--user", type=int, default=None,
                      help="SSI (matches source or destination)")
    p_fr.add_argument("--call-type", type=str, default=None,
                      help="Individual/Group/...")
    p_fr.add_argument("--timeslot", type=int, default=None)
    p_fr.add_argument("--encrypted", action="store_true",
                      help="encrypted frames only")
    p_fr.add_argument("--clear", action="store_true",
                      help="clear frames only")
    p_fr.add_argument("--sds-only", action="store_true",
                      help="frames carrying an SDS message")
    p_fr.add_argument("--stats", action="store_true",
                      help="print the statistics panel instead of lines")
    p_fr.add_argument("--top", type=int, default=8,
                      help="top-N entries per stats counter (default 8)")
    p_fr.add_argument("-o", "--out", type=str, default=None,
                      help="write matching frames as JSONL instead of text")
    p_fr.set_defaults(func=cmd_frames)

    p_dev = sub.add_parser("devices", help="list BladeRF devices")
    p_dev.set_defaults(func=cmd_devices)

    args = parser.parse_args(argv)
    if args.command is None:
        parser.print_help()
        return 2

    from tetraear_tpu.utils.backend import (apply_platform,
                                             enable_compile_cache)
    apply_platform(args.platform)
    enable_compile_cache()

    from tetraear_tpu.ui.logging_setup import get_log_dir, setup_logging
    setup_logging(verbose=getattr(args, "verbose", False))
    import logging
    logging.getLogger(__name__).info("Logging to: %s", get_log_dir())
    return args.func(args)


if __name__ == "__main__":
    raise SystemExit(main())
