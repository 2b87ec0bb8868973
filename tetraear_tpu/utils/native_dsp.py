"""ctypes loader for the native host-DSP engine (native/hostdsp.cpp).

The device owns the dense math; these calls remove the Python interpreter
cost from the host runtime's hot bit/byte loops: the per-frame soft-CRC
gate (ops/crc.soft_crc_check_host), SC16-Q11 capture conversion
(io/capture.py:95-107) and the FM "buzz" discriminator
(ui/capture_loop._maybe_raw_audio).  Every entry point degrades to the
pure-Python/NumPy implementation when the library or toolchain is
missing — behavior is identical either way, pinned by
tests/unit/test_native_dsp.py.
"""

from __future__ import annotations

import ctypes
import logging
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "libhostdsp.so"

_lib: Optional[ctypes.CDLL] = None
_load_attempted = False


def _build() -> bool:
    try:
        result = subprocess.run(["make", "-C", str(_NATIVE_DIR),
                                 "libhostdsp.so"],
                                capture_output=True, timeout=120)
        return result.returncode == 0 and _LIB_PATH.exists()
    except Exception as e:
        logger.debug("native hostdsp build error: %s", e)
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted
    if _lib is not None or _load_attempted:
        return _lib
    _load_attempted = True
    if not _LIB_PATH.exists() and not _build():
        logger.info("native hostdsp unavailable; using NumPy fallbacks")
        return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.crc16_ccitt.restype = ctypes.c_uint16
        lib.crc16_ccitt.argtypes = [u8p, ctypes.c_long]
        lib.soft_crc_check.restype = ctypes.c_int
        lib.soft_crc_check.argtypes = [u8p, ctypes.c_long, ctypes.c_int]
        lib.soft_crc_check_batch.restype = None
        lib.soft_crc_check_batch.argtypes = [
            u8p, ctypes.c_long, ctypes.c_long, ctypes.c_int, u8p]
        lib.sc16q11_to_cf32.restype = None
        lib.sc16q11_to_cf32.argtypes = [
            ctypes.POINTER(ctypes.c_int16), ctypes.c_long,
            ctypes.POINTER(ctypes.c_float)]
        lib.fm_discriminator.restype = None
        lib.fm_discriminator.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_long,
            ctypes.POINTER(ctypes.c_float)]
        _lib = lib
    except OSError as e:
        logger.info("native hostdsp load failed: %s", e)
    return _lib


def _as_u8(bits) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(bits), dtype=np.uint8) & 1


def crc16_bits(bits) -> Optional[int]:
    """Native CRC-16-CCITT over a bit array; None when unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    arr = _as_u8(bits)
    return int(lib.crc16_ccitt(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), arr.size))


def soft_crc_check(data_bits, budget: int) -> Optional[bool]:
    """Native reference _check_crc; None when unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    arr = _as_u8(data_bits)
    return bool(lib.soft_crc_check(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), arr.size,
        budget))


def soft_crc_check_batch(frames, budget: int) -> Optional[np.ndarray]:
    """Native batched _check_crc over (F, D) frames; None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    arr = np.ascontiguousarray(np.asarray(frames), dtype=np.uint8) & 1
    f, d = arr.shape
    out = np.empty(f, np.uint8)
    lib.soft_crc_check_batch(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), f, d, budget,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out.astype(bool)


def sc16q11_to_cf32(raw: np.ndarray) -> Optional[np.ndarray]:
    """Interleaved int16 I/Q -> complex64 / 2048; None when unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    arr = np.ascontiguousarray(np.asarray(raw, np.int16))
    n_pairs = arr.size // 2
    out = np.empty(2 * n_pairs, np.float32)
    lib.sc16q11_to_cf32(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), n_pairs,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out.view(np.complex64)


def fm_discriminator(iq: np.ndarray) -> Optional[np.ndarray]:
    """angle(x[1:] * conj(x[:-1])) / pi * 0.5; None when unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    arr = np.ascontiguousarray(np.asarray(iq, np.complex64))
    if arr.size < 2:
        return np.zeros(0, np.float32)
    out = np.empty(arr.size - 1, np.float32)
    lib.fm_discriminator(
        arr.view(np.float32).ctypes.data_as(
            ctypes.POINTER(ctypes.c_float)), arr.size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out
