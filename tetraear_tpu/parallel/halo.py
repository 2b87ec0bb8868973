"""Overlap-save halo exchange via collective permute.

The time axis shards one continuous sample stream; every convolutional
stage needs neighbour context (SURVEY.md §5.7).  ``exchange_halo`` moves
edge regions between ring neighbours with `jax.lax.ppermute` — XLA lowers
these to collective-permutes.  Stream edges (first shard's left halo,
last shard's right halo) are zero-filled, matching the zero-padded
unsharded filters.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def exchange_halo(x: jnp.ndarray, left: int, right: int, axis_name: str):
    """Return (left_halo, right_halo) for this shard's block.

    x: (..., T) local block.  left/right: halo sizes in samples.
    left_halo = last `left` samples of the left neighbour (zeros on the
    first shard); right_halo = first `right` samples of the right
    neighbour (zeros on the last shard).
    """
    n = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)

    left_halo = jnp.zeros(x.shape[:-1] + (left,), x.dtype)
    right_halo = jnp.zeros(x.shape[:-1] + (right,), x.dtype)
    if n == 1:
        return left_halo, right_halo

    if left > 0:
        # my tail -> right neighbour's left halo
        tail = x[..., -left:]
        recv = lax.ppermute(tail, axis_name,
                            perm=[(i, (i + 1) % n) for i in range(n)])
        left_halo = jnp.where(idx == 0, jnp.zeros_like(recv), recv)
    if right > 0:
        # my head -> left neighbour's right halo
        head = x[..., :right]
        recv = lax.ppermute(head, axis_name,
                            perm=[(i, (i - 1) % n) for i in range(n)])
        right_halo = jnp.where(idx == n - 1, jnp.zeros_like(recv), recv)
    return left_halo, right_halo


def extend_with_halo(x: jnp.ndarray, left: int, right: int, axis_name: str
                     ) -> jnp.ndarray:
    """Concatenate neighbour halos around the local block: (..., T+left+right)."""
    lh, rh = exchange_halo(x, left, right, axis_name)
    return jnp.concatenate([lh, x, rh], axis=-1)


def carry_last(x: jnp.ndarray, axis_name: str, fill=None) -> jnp.ndarray:
    """Send each shard's last element along the stream to the right
    neighbour (for differential-demod state: the previous symbol,
    processor.py:131).  Returns the element received from the left
    neighbour; first shard receives `fill` (default: zeros)."""
    n = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)
    last = x[..., -1]
    recv = lax.ppermute(last, axis_name,
                        perm=[(i, (i + 1) % n) for i in range(n)])
    if fill is None:
        fill_val = jnp.zeros_like(recv)
    else:
        fill_val = jnp.broadcast_to(fill, recv.shape).astype(recv.dtype)
    return jnp.where(idx == 0, fill_val, recv)
