"""Burst-sync correlation as a dense matched filter.

The reference slides a 22-bit window position-by-position in Python
(decoder.py:231-259).  Here the correlation against both training sequences
is computed for *every* position at once:

    matches(pos) = sum_i [ bits[pos+i] == pattern[i] ]
                 = (L + sum_i (2*bits[pos+i]-1) * (2*pattern[i]-1)) / 2

i.e. one strided cross-correlation per pattern on +/-1-mapped bits — a single
`conv_general_dilated` with 2 output channels.  The data-dependent greedy
walk / adaptive threshold logic stays host-side (core/decoder.py parity) and
operates on this dense score array.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import lax

from tetraear_tpu import constants as C


_PATTERNS = np.stack([C.TS1, C.TS2]).astype(np.float32) * 2.0 - 1.0  # (2, 22)


def sync_correlation(bits: jnp.ndarray) -> jnp.ndarray:
    """Correlate a bit stream with TS1/TS2 at every position.

    bits: (..., N) uint8/int in {0,1}.
    Returns (..., 2, N-21) float32 of match fractions in [0, 1]
    (index 0 = TS1, 1 = TS2).  For N < 22 returns an empty last axis.
    """
    L = C.SYNC_LEN_BITS
    n = bits.shape[-1]
    if n < L:
        return jnp.zeros(bits.shape[:-1] + (2, 0), jnp.float32)

    x = bits.astype(jnp.float32) * 2.0 - 1.0
    flat = x.reshape((-1, 1, n))                       # (B, 1, N)
    rhs = jnp.asarray(_PATTERNS)[:, None, :]           # (2, 1, L)
    out = lax.conv_general_dilated(
        flat, rhs, window_strides=(1,), padding=((0, 0),),
        dimension_numbers=("NCW", "OIW", "NCW"),
        # +/-1 operands and integer sums <= 22: exact at any precision
        precision=lax.Precision.DEFAULT,
        preferred_element_type=jnp.float32)            # (B, 2, N-L+1)
    corr = (L + out) / (2.0 * L)
    return corr.reshape(bits.shape[:-1] + (2, n - L + 1))


def best_correlation(bits: jnp.ndarray) -> jnp.ndarray:
    """max over the two patterns: (..., N-21) float32."""
    return sync_correlation(bits).max(axis=-2)
