"""Headless spectrum-display compute: waterfall buffers, denoising,
colormap rendering, auto-calibration, follow-frequency AFC, and the
TETRA-detected status state machine.

The reference implements these inside Qt widgets (ui/modern.py:649-1362
WaterfallWidget, :3873-3968 auto-spectrum, :5223-5257 follow-frequency,
:5309-5390 status machine).  Accelerator hosts are headless, so the *compute*
behaviors live here as plain classes: feed spectra in, read display
arrays / control decisions out.  A renderer turns the waterfall history
into an RGB image (saveable as PNG via any imaging tool, or dumpable as
ANSI blocks for terminals).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, Optional, Tuple

import numpy as np


class WaterfallBuffer:
    """Scrolling spectrum history with the reference's IIR denoiser.

    History depth 200 rows (modern.py deque(200)); denoiser is a one-pole
    IIR with alpha = 0.15 (modern.py:929-938)."""

    HISTORY = 200
    DENOISE_ALPHA = 0.15

    def __init__(self, denoise: bool = True, history: int | None = None):
        # history overrides the GUI's 200-row deque for offline renders
        # (e.g. `waterfall --rows 1000`), where the cap would silently
        # truncate the export to the last 200 rows
        self.history: deque = deque(maxlen=history or self.HISTORY)
        self.denoise = denoise
        self._smoothed: Optional[np.ndarray] = None
        self.current_freqs: Optional[np.ndarray] = None
        self.current_power: Optional[np.ndarray] = None

    def update_spectrum(self, freqs: np.ndarray, power_db: np.ndarray) -> None:
        power_db = np.asarray(power_db, dtype=np.float64)
        if self.denoise:
            if self._smoothed is None or self._smoothed.shape != power_db.shape:
                self._smoothed = power_db.copy()
            else:
                a = self.DENOISE_ALPHA
                self._smoothed = a * power_db + (1 - a) * self._smoothed
            row = self._smoothed.copy()
        else:
            row = power_db
        self.current_freqs = np.asarray(freqs, dtype=np.float64)
        self.current_power = row
        self.history.append(row)

    def as_array(self) -> np.ndarray:
        """(rows, bins) float64, newest row last; empty (0, 0) when fresh."""
        if not self.history:
            return np.zeros((0, 0))
        return np.stack(list(self.history))


# blue -> cyan -> yellow -> red stops (modern.py:1003-1031 colormap)
_STOPS = np.array([
    [0.00, 0, 0, 64],
    [0.25, 0, 128, 255],
    [0.50, 0, 255, 255],
    [0.75, 255, 255, 0],
    [1.00, 255, 0, 0],
])


def colorize(power_db: np.ndarray, floor_db: float = -100.0,
             top_db: float = -20.0) -> np.ndarray:
    """Map dB values to RGB via the blue-cyan-yellow-red gradient.

    power_db: any shape -> uint8 RGB of shape power_db.shape + (3,)."""
    t = np.clip((np.asarray(power_db, float) - floor_db)
                / max(top_db - floor_db, 1e-9), 0.0, 1.0)
    out = np.empty(t.shape + (3,), np.uint8)
    for ch in range(3):
        out[..., ch] = np.interp(t, _STOPS[:, 0], _STOPS[:, ch + 1]
                                 ).astype(np.uint8)
    return out


def render_waterfall_rgb(buffer: WaterfallBuffer, floor_db: float = -100.0,
                         top_db: float = -20.0) -> np.ndarray:
    """History -> (rows, bins, 3) uint8 image, newest row at the bottom."""
    arr = buffer.as_array()
    if arr.size == 0:
        return np.zeros((0, 0, 3), np.uint8)
    return colorize(arr, floor_db, top_db)


def save_ppm(path, rgb: np.ndarray) -> None:
    """Write an RGB uint8 image as binary PPM (no imaging deps needed)."""
    rgb = np.asarray(rgb, np.uint8)
    assert rgb.ndim == 3 and rgb.shape[2] == 3
    with open(path, "wb") as f:
        f.write(f"P6\n{rgb.shape[1]} {rgb.shape[0]}\n255\n".encode())
        f.write(rgb.tobytes())


def save_png(path, rgb: np.ndarray) -> None:
    """Write an RGB uint8 image as PNG using only stdlib zlib.

    Gives the reference GUI's pixel waterfall (modern.py:649-1362) a
    shippable headless artifact (`tetraear_tpu waterfall <iq> -o x.png`)
    without an imaging dependency."""
    import struct
    import zlib

    rgb = np.asarray(rgb, np.uint8)
    assert rgb.ndim == 3 and rgb.shape[2] == 3
    h, w = rgb.shape[:2]

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    # filter byte 0 (None) prepended to each scanline
    raw = b"".join(b"\x00" + rgb[r].tobytes() for r in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def find_spike_band(freqs_mhz: np.ndarray, power_db: np.ndarray,
                    center_mhz: float, search_range_hz: float,
                    noise_floor_db: float = -85.0,
                    default_bandwidth_hz: float = 25000.0) -> Dict[str, float]:
    """Strongest spike near `center_mhz` + bandwidth estimate
    (modern.py:774-857): contiguous region around the peak above
    max(peak-6dB, baseline+6dB, noise_floor+3dB), clamped to [1k, 250k] Hz."""
    freqs = np.asarray(freqs_mhz, float)
    powers = np.asarray(power_db, float)
    fallback = {"center_mhz": float(center_mhz), "left_mhz": float(center_mhz),
                "right_mhz": float(center_mhz),
                "bandwidth_hz": float(default_bandwidth_hz)}
    if freqs.size == 0 or powers.size == 0:
        return fallback
    n = min(len(freqs), len(powers))
    freqs, powers = freqs[:n], powers[:n]
    half = search_range_hz / 1e6
    mask = (freqs >= center_mhz - half) & (freqs <= center_mhz + half)
    if not np.any(mask):
        return fallback
    idxs = np.where(mask)[0]
    peak_i = int(idxs[np.argmax(powers[idxs])])
    peak_power = float(powers[peak_i])
    local_baseline = float(np.percentile(powers[idxs], 20))
    threshold = max(peak_power - 6.0, local_baseline + 6.0,
                    noise_floor_db + 3.0)
    left_i = peak_i
    while left_i > idxs[0] and powers[left_i] >= threshold:
        left_i -= 1
    if powers[left_i] < threshold and left_i < peak_i:
        left_i += 1
    right_i = peak_i
    while right_i < idxs[-1] and powers[right_i] >= threshold:
        right_i += 1
    if powers[right_i] < threshold and right_i > peak_i:
        right_i -= 1
    left_mhz, right_mhz = float(freqs[left_i]), float(freqs[right_i])
    if right_mhz < left_mhz:
        left_mhz, right_mhz = right_mhz, left_mhz
    bandwidth_hz = float(np.clip((right_mhz - left_mhz) * 1e6, 1000.0,
                                 250000.0))
    return {"center_mhz": (left_mhz + right_mhz) / 2.0, "left_mhz": left_mhz,
            "right_mhz": right_mhz, "bandwidth_hz": bandwidth_hz}


class AutoSpectrumCalibration:
    """Percentile-based display calibration (modern.py:3873-3968).

    Returns None when throttled (<0.3 s) or when the spectrum is too flat;
    otherwise a dict of targets: top_db, bottom_db, threshold_db, zoom
    (1.0-10.0)."""

    THROTTLE_S = 0.3

    def __init__(self, clock=time.time):
        self._clock = clock
        self._last = 0.0

    def compute(self, freqs, powers) -> Optional[Dict[str, float]]:
        now = self._clock()
        if now - self._last < self.THROTTLE_S:
            return None
        self._last = now

        power = np.asarray(powers, float)
        if power.size < 32:
            return None
        finite = np.isfinite(power)
        if not np.any(finite):
            return None
        usable = power[finite]
        noise_floor = float(np.percentile(usable, 20))
        peak_power = float(np.percentile(usable, 99))
        dynamic_range = peak_power - noise_floor
        if not np.isfinite(dynamic_range) or dynamic_range < 5:
            return None

        top = peak_power + 5.0
        bottom = noise_floor - 10.0
        if bottom > top - 10.0:
            bottom = top - 10.0
        bottom = min(bottom, top - 5)
        threshold = noise_floor + dynamic_range * 0.6
        threshold = max(min(threshold, top - 2), bottom + 2)

        out = {"top_db": round(top), "bottom_db": round(bottom),
               "threshold_db": round(threshold), "zoom": 1.0}

        freq = np.asarray(freqs, float)
        if freq.size == power.size and freq.size > 0:
            freq_mhz = freq / 1e6 if np.max(np.abs(freq)) > 1e3 else freq
            full_span = float(np.max(freq_mhz) - np.min(freq_mhz))
            if full_span > 0:
                signal_mask = finite & (power > noise_floor + 6)
                if np.any(signal_mask):
                    act = freq_mhz[signal_mask]
                    active_span = float(np.max(act) - np.min(act))
                else:
                    active_span = full_span
                if active_span <= 0:
                    active_span = full_span
                desired_span = min(full_span,
                                   max(active_span * 3, full_span / 10.0))
                out["zoom"] = max(1.0, min(10.0, full_span
                                           / max(desired_span, 1e-9)))
        return out


def find_peak_near(freqs_mhz: np.ndarray, powers_db: np.ndarray,
                   center_mhz: float,
                   window_mhz: float = 0.050) -> Optional[float]:
    """Strongest bin within ±window of center, refined with parabolic
    sub-bin interpolation (the reference's Ctrl-click peak snap,
    modern.py:756-772).  Returns the peak frequency in MHz, or None when
    the window is empty."""
    freqs = np.asarray(freqs_mhz, float)
    powers = np.asarray(powers_db, float)
    mask = np.abs(freqs - center_mhz) < window_mhz
    if not np.any(mask):
        return None
    idxs = np.where(mask)[0]
    p = int(idxs[np.argmax(powers[idxs])])
    if 0 < p < len(freqs) - 1:
        y0, y1, y2 = powers[p - 1], powers[p], powers[p + 1]
        denom = y0 - 2.0 * y1 + y2
        if abs(denom) > 1e-12:
            delta = 0.5 * (y0 - y2) / denom
            delta = float(np.clip(delta, -0.5, 0.5))
            step = freqs[min(p + 1, len(freqs) - 1)] - freqs[p] \
                if p + 1 < len(freqs) else freqs[p] - freqs[p - 1]
            return float(freqs[p] + delta * step)
    return float(freqs[p])


def follow_frequency_step(freqs_mhz: np.ndarray, powers_db: np.ndarray,
                          tuned_mhz: float,
                          window_mhz: float = 0.010) -> Optional[float]:
    """One GUI-AFC retune step (modern.py:5223-5257): peak within the
    +/-10 kHz window, > -60 dB, offset > 50 Hz -> step 10% of the offset.
    Returns the new frequency in MHz, or None for no retune."""
    freqs = np.asarray(freqs_mhz, float)
    powers = np.asarray(powers_db, float)
    mask = np.abs(freqs - tuned_mhz) < window_mhz
    if not np.any(mask):
        return None
    idxs = np.where(mask)[0]
    peak_idx = int(idxs[np.argmax(powers[idxs])])
    peak_freq = float(freqs[peak_idx])
    peak_power = float(powers[peak_idx])
    offset = peak_freq - tuned_mhz
    if peak_power > -60 and abs(offset) > 0.00005:
        return tuned_mhz + offset * 0.1
    return None


class TetraStatusMachine:
    """TETRA-detected status logic (modern.py:5309-5390): minimum 5 s
    analysis window, then confidence tiers from sync/CRC rates."""

    MIN_DETECTION_TIME_S = 5.0

    def __init__(self, clock=time.time):
        self._clock = clock
        self.signal_present = False
        self.frame_count = 0
        self.sync_count = 0
        self.valid_frames = 0
        self.first_frame_time: Optional[float] = None

    def on_signal(self, present: bool) -> None:
        self.signal_present = present

    def on_frame(self, frame: dict) -> None:
        self.frame_count += 1
        if self.first_frame_time is None:
            self.first_frame_time = self._clock()
        # a decoded frame implies a sync hit; CRC pass counts as validated
        self.sync_count += 1
        if frame.get("burst_crc") is True or frame.get("decrypted"):
            self.valid_frames += 1

    def status(self) -> Tuple[str, str]:
        """-> (state, message); state in {none, analyzing, detected,
        high_confidence}."""
        if not self.signal_present or self.frame_count == 0:
            self.first_frame_time = None
            return ("none", "No TETRA Signal")
        now = self._clock()
        since_first = now - (self.first_frame_time or now)
        if since_first < self.MIN_DETECTION_TIME_S:
            remain = int(self.MIN_DETECTION_TIME_S - since_first)
            return ("analyzing", f"Signal Detected (Analyzing... {remain}s)")
        sync_rate = self.sync_count / max(self.frame_count, 1)
        crc_rate = self.valid_frames / max(self.frame_count, 1)
        has_validated = sync_rate > 0.1 or crc_rate > 0.1
        detected = (self.frame_count >= 3
                    and (has_validated or self.frame_count >= 5))
        high = (self.frame_count >= 5
                and (sync_rate > 0.2 or crc_rate > 0.3
                     or self.frame_count >= 10))
        if high:
            return ("high_confidence",
                    f"TETRA Signal Detected ({self.frame_count} frames, "
                    f"Sync: {sync_rate:.0%}, CRC: {crc_rate:.0%})")
        if detected:
            return ("detected",
                    f"TETRA Frames Decoding ({self.frame_count} frames)")
        return ("analyzing", "Signal Detected (weak validation)")
