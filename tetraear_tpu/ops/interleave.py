"""TETRA block interleaving (ETSI EN 300 392-2 §8.2.4).

Block interleaver over K bits: output position i carries input position
k(i) = (a * i) mod K (1-indexed in the spec; 0-indexed here with the same
residue structure).  Standard (K, a) pairs:

    BSCH        K=120,  a=11
    SCH/HU      K=168,  a=13
    SCH/HD, BNCH, STCH  K=216, a=101
    SCH/F       K=432,  a=103

TCH/4.8 and TCH/2.4 additionally spread each coded block diagonally over
N consecutive bursts (N in {1, 4, 8}) — interleave_multiburst /
deinterleave_multiburst below; TCH/7.2 is uncoded and un-interleaved
(ops/channel_coding.TCH_GEOMETRY).

Interleave/de-interleave are pure gathers with precomputed index vectors —
fused into surrounding ops by XLA.
"""

from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp

BLOCK_PARAMS = {
    "BSCH": (120, 11),
    "SCH/HU": (168, 13),
    "SCH/HD": (216, 101),
    "BNCH": (216, 101),
    "STCH": (216, 101),
    "SCH/F": (432, 103),
}


@functools.lru_cache(maxsize=32)
def _perm(k: int, a: int) -> np.ndarray:
    """perm[i] = source index of interleaved position i.

    Spec (1-indexed): b(i) = c(k) with i = (a*k) mod K ... equivalently the
    interleaved stream at position (a*k) mod K holds input bit k."""
    i = (a * (np.arange(k, dtype=np.int64) + 1)) % k      # spec arithmetic
    perm = np.empty(k, dtype=np.int64)
    perm[i] = np.arange(k)
    return perm


@functools.lru_cache(maxsize=32)
def _inv_perm(k: int, a: int) -> np.ndarray:
    perm = _perm(k, a)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(k)
    return inv


def interleave(bits: jnp.ndarray, channel: str = "SCH/F") -> jnp.ndarray:
    k, a = BLOCK_PARAMS[channel]
    assert bits.shape[-1] == k, (bits.shape, k)
    return bits[..., jnp.asarray(_perm(k, a))]


def deinterleave(bits: jnp.ndarray, channel: str = "SCH/F") -> jnp.ndarray:
    k, a = BLOCK_PARAMS[channel]
    assert bits.shape[-1] == k, (bits.shape, k)
    return bits[..., jnp.asarray(_inv_perm(k, a))]


# ---------------------------------------------------------------------------
# N-burst diagonal interleaving (EN 300 392-2 §8.2.4.2) for the traffic
# channels TCH/4.8 and TCH/2.4 (N in {1, 4, 8}).  Type-3 bit i of block B
# lands in type-4 block B + (i mod N) at intra-block position (a·i) mod K —
# each output (block, position) receives exactly one bit because i is
# uniquely determined by the position and the block offset by i mod N.
# Edge blocks (the first/last N-1) are partially filled; the decoder zeros
# the missing contributions (erasures for the soft chain).
# ---------------------------------------------------------------------------

def interleave_multiburst(blocks: np.ndarray, depth: int,
                          channel: str = "SCH/F") -> np.ndarray:
    """(M, K) type-3 blocks -> (M + depth - 1, K) type-4 burst blocks."""
    k, a = BLOCK_PARAMS[channel]
    blocks = np.asarray(blocks)
    m = blocks.shape[0]
    assert blocks.shape[-1] == k
    out = np.zeros((m + depth - 1, k), blocks.dtype)
    i = np.arange(k)
    pos = (a * (i + 1)) % k
    off = i % depth
    for b in range(m):
        out[b + off, pos] = blocks[b, i]
    return out


def deinterleave_multiburst(bursts: np.ndarray, depth: int,
                            channel: str = "SCH/F") -> np.ndarray:
    """(M + depth - 1, K) burst blocks -> (M, K) type-3 blocks.

    Works on hard bits or soft LLRs; contributions outside the received
    window come back as zeros (erasures).
    """
    k, a = BLOCK_PARAMS[channel]
    bursts = np.asarray(bursts)
    n_out = bursts.shape[0]
    m = n_out - depth + 1
    assert m >= 1, "need at least `depth` burst blocks"
    i = np.arange(k)
    pos = (a * (i + 1)) % k
    off = i % depth
    out = np.zeros((m, k), bursts.dtype)
    for b in range(m):
        out[b, i] = bursts[b + off, pos]
    return out
