"""Multi-carrier channelization: one wideband IQ stream -> C baseband
carrier streams.

The reference processes a single 25 kHz channel per process
(processor.py:264); multi-carrier is a new device-native capability (BASELINE
configs 4-5).  Round-1 implementation is a *modulated DDC bank*: each
carrier applies its own mixer then shares one polyphase decimating FIR,
batched over the carrier axis — one big strided convolution with C batch
rows, which XLA lowers to one batched implicit GEMM.  (A critically/2x-sampled DFT
filterbank is the planned upgrade for uniformly spaced carrier grids; the
DDC bank keeps every carrier on the exact 240 kHz grid the ref-compat
chain expects.)
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from tetraear_tpu.ops import fir


def mix_to_baseband(x: jnp.ndarray, offsets_hz: jnp.ndarray,
                    sample_rate_hz: float, start_index=0) -> jnp.ndarray:
    """x: (N,) complex; offsets_hz: (C,) -> (C, N) mixed streams.

    Mixers are generated as exp(-j*2*pi*f_c*t); phase-continuous across
    blocks via ``start_index``.
    """
    n = x.shape[-1]
    t = (start_index + jnp.arange(n, dtype=jnp.float32)) / jnp.float32(
        sample_rate_hz)
    ph = -2.0 * jnp.pi * offsets_hz[:, None] * t[None, :]
    osc = jax.lax.complex(jnp.cos(ph), jnp.sin(ph))
    return (x[None, :] * osc).astype(jnp.complex64)


def channelize(x: jnp.ndarray, offsets_hz: jnp.ndarray,
               sample_rate_hz: float, decim: int,
               taps: jnp.ndarray | None = None,
               start_index=0) -> jnp.ndarray:
    """Wideband (N,) -> (C, ceil(N/decim)) carrier basebands."""
    if taps is None:
        taps = jnp.asarray(fir.design_decimation_fir(decim))
    mixed = mix_to_baseband(x, offsets_hz, sample_rate_hz, start_index)
    return fir.fir_decimate(mixed, taps, decim)


def carrier_grid(num_carriers: int, spacing_hz: float = 25_000.0,
                 center_offset_hz: float = 0.0) -> np.ndarray:
    """Symmetric grid of carrier offsets around the capture center."""
    idx = np.arange(num_carriers) - (num_carriers - 1) / 2.0
    return (idx * spacing_hz + center_offset_hz).astype(np.float32)
