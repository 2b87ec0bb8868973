"""AACH block code: shortened (30, 14) Reed-Muller code with a
matmul maximum-likelihood decoder (ETSI EN 300 392-2 §8.2.3.2).

The TETRA Access Assignment CHannel (AACH) protects its 14-bit
ACCESS-ASSIGN PDU with a (30, 14) code obtained by shortening the
second-order Reed-Muller code RM(2, 5) = (32, 16, 8): two information
positions are fixed to zero and the corresponding codeword coordinates
deleted, preserving minimum distance 8 (3-error correction).  The
construction here derives the generator from first principles (monomial
basis {1, v_i, v_i v_j} evaluated on F_2^5, Gaussian-eliminated to
systematic form, then shortened); `tests/unit/test_rm3014.py` pins
d_min = 8 exhaustively.

Decoding is *optimal* soft-decision maximum likelihood, designed for a
matrix unit rather than ported from a serial majority-logic decoder: all 2^14
codewords form a static (16384, 30) ±1 matrix, and decoding a batch of
30-LLR blocks is one (B, 30) x (30, 16384) matmul + argmax.  At 1 MB for
the table this trades trivial memory for a single dense op — the shape
accelerators are built for — and unlike majority-logic it is exact ML on soft
inputs.

The reference implementation has no AACH handling at all (its protocol
layer starts at MAC PDU heuristics, /root/reference/tetraear/core/
protocol.py:300); this is part of the `etsi` profile's full-chain
capability (SURVEY.md §7).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

N_BITS = 30      # codeword length
K_BITS = 14      # message length
D_MIN = 8        # minimum distance (pinned by tests)


@functools.lru_cache(maxsize=1)
def generator_matrix() -> np.ndarray:
    """Systematic (14, 30) generator over F2.

    Built from RM(2,5): rows = [1, v1..v5, v_i v_j (i<j)] on the 32 points
    of F_2^5, reduced to systematic form on the first 16 coordinates, then
    shortened by dropping the last two information rows and their pivot
    columns.
    """
    pts = np.arange(32, dtype=np.uint8)
    v = np.stack([(pts >> i) & 1 for i in range(5)])            # (5, 32)
    rows = [np.ones(32, dtype=np.uint8)]
    rows.extend(v)
    for i in range(5):
        for j in range(i + 1, 5):
            rows.append(v[i] & v[j])
    g = np.stack(rows)                                          # (16, 32)

    # Gauss-Jordan to systematic form (pivots on the first 16 columns).
    g = g.copy()
    pivots = []
    r = 0
    for c in range(32):
        if r >= 16:
            break
        hit = np.flatnonzero(g[r:, c]) + r
        if hit.size == 0:
            continue
        if hit[0] != r:
            g[[r, hit[0]]] = g[[hit[0], r]]
        for rr in range(16):
            if rr != r and g[rr, c]:
                g[rr] ^= g[r]
        pivots.append(c)
        r += 1
    assert r == 16 and len(pivots) == 16

    # Shorten: drop the last two information rows and their pivot columns.
    drop_cols = sorted(pivots[14:])
    keep_cols = [c for c in range(32) if c not in drop_cols]
    gs = g[:14, keep_cols]                                      # (14, 30)
    assert gs.shape == (K_BITS, N_BITS)
    return gs.astype(np.uint8)


@functools.lru_cache(maxsize=1)
def codeword_table() -> np.ndarray:
    """All 2^14 codewords, (16384, 30) uint8; row index == message value
    with message bit 0 as the MSB (big-endian, matching bits_to_uint)."""
    g = generator_matrix()
    msgs = np.arange(1 << K_BITS, dtype=np.uint32)
    mbits = ((msgs[:, None] >> np.arange(K_BITS - 1, -1, -1)[None, :]) & 1)
    return (mbits.astype(np.uint8) @ g) & 1                     # mod-2


def encode(bits14: np.ndarray) -> np.ndarray:
    """Host encode: (..., 14) message bits -> (..., 30) codeword bits."""
    b = np.asarray(bits14).astype(np.uint8) & 1
    assert b.shape[-1] == K_BITS, b.shape
    return (b @ generator_matrix()) & 1


@functools.lru_cache(maxsize=1)
def _sign_table() -> np.ndarray:
    """(30, 16384) float32 of ±1 codeword signs (+1 where bit == 1)."""
    return np.ascontiguousarray(
        (codeword_table().astype(np.float32) * 2.0 - 1.0).T)


def decode_soft(llrs: jnp.ndarray):
    """ML decode soft bits (llr > 0 <=> bit 1).

    llrs: (..., 30) float32.
    Returns (bits14 (..., 14) uint8, margin (...,) float32) where margin is
    the winning correlation minus the runner-up (confidence; 0 on ties).

    One matmul over the codeword table + argmax/top-2 — exact maximum
    likelihood, one dense matmul.
    """
    assert llrs.shape[-1] == N_BITS, llrs.shape
    batch_shape = llrs.shape[:-1]
    x = llrs.reshape((-1, N_BITS)).astype(jnp.float32)
    scores = x @ jnp.asarray(_sign_table())                     # (B, 16384)
    top2, idx = jax.lax.top_k(scores, 2)
    best = idx[:, 0].astype(jnp.uint32)
    margin = top2[:, 0] - top2[:, 1]
    shifts = jnp.arange(K_BITS - 1, -1, -1, dtype=jnp.uint32)
    bits = ((best[:, None] >> shifts[None, :]) & 1).astype(jnp.uint8)
    return (bits.reshape(batch_shape + (K_BITS,)),
            margin.reshape(batch_shape))


def decode_hard(bits30: np.ndarray):
    """Hard-decision convenience wrapper (host in, host out).

    Returns (bits14, hamming_distance_to_nearest_codeword).
    """
    b = np.asarray(bits30).astype(np.float32) * 2.0 - 1.0
    bits, margin = decode_soft(jnp.asarray(b))
    bits = np.asarray(bits)
    # distance = (30 - correlation)/2 with the winning codeword
    cw = encode(bits)
    dist = int(np.sum(cw != (np.asarray(bits30).astype(np.uint8) & 1)))
    del margin
    return bits, dist
