"""tetraear_tpu — a GPU-native TETRA receive framework.

A from-scratch JAX/XLA/Pallas implementation of the capabilities of the
WizzardDr/TetraEar-BladeRF reference decoder: wideband IQ -> channelized
pi/4-DQPSK demodulation -> burst sync -> TETRA MAC/SDS decode, with
decryption brute-force, voice-codec plumbing, scanning, and multi-chip
scale-out over a (carrier, time) device mesh.

Layering (device vs host):
  ops/       batched JAX/Pallas DSP kernels (filters, demod, sync, CRC, FFT)
  models/    receiver pipelines assembled from ops, jit-compiled per profile
  parallel/  mesh construction, shard_map pipelines, overlap-save halos
  protocol/  host MAC/SDS/LIP byte-level parsing (sequential, stateful)
  crypto/    TEA decryption + key brute-force (host, optional C++ native)
  core/      decode orchestration, validation, location, frame schema
  signal/    detector + frequency scanner
  audio/     ETSI ACELP codec subprocess plumbing
  io/        IQ replay / capture / recorders
  ui/        CLI front-end, logging, settings
"""

__version__ = "0.1.0"

from tetraear_tpu.config import ReceiverConfig, DecoderConfig, DEFAULT_CONFIG  # noqa: F401

_LAZY = {
    "SignalProcessor": "tetraear_tpu.models.receiver",
    "TetraDecoder": "tetraear_tpu.core.decoder",
    "TetraProtocolParser": "tetraear_tpu.protocol.parser",
    "TEADecryptor": "tetraear_tpu.crypto.tea",
    "TetraKeyManager": "tetraear_tpu.crypto.keys",
    "TetraSignalValidator": "tetraear_tpu.core.validator",
    "VoiceProcessor": "tetraear_tpu.audio.voice",
    "TetraSignalDetector": "tetraear_tpu.signal.detector",
    "FrequencyScanner": "tetraear_tpu.signal.scanner",
    "BladeRFCapture": "tetraear_tpu.io.capture",
    "FileReplaySource": "tetraear_tpu.io.replay",
}

# reference facade exports (tetraear/__init__.py:37-47) plus device-pipeline additions
__all__ = ["TetraDecoder", "TEADecryptor", "TetraKeyManager",
           "TetraProtocolParser", "SignalProcessor", "BladeRFCapture",
           "TetraSignalDetector", "VoiceProcessor", "FrequencyScanner",
           "TetraSignalValidator", "FileReplaySource", "ReceiverConfig",
           "DecoderConfig"]


def __getattr__(name):
    """Lazy facade (mirrors tetraear/__init__.py:25-47) so importing the
    package does not pull JAX compilation paths until needed."""
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(_LAZY[name])
        return getattr(mod, name)
    raise AttributeError(f"module 'tetraear_tpu' has no attribute {name!r}")
