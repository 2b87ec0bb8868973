"""Symbol-timing recovery.

`best_phase_pick` reproduces the reference's grid search
(processor.py:168-219): among sampling phases p in {0, step, 2*step, ...}
choose the one maximizing mean |x[p::sps]|^2 (first maximum wins), then sample
on that grid.  All phases are evaluated at once as a masked 2-D reduction —
no Python loop, fully batched.

Outputs are fixed-shape (jit-friendly): a padded symbol array of capacity
ceil(N/sps) plus a valid-count, since the number of symbols depends on the
winning phase.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class TimedSymbols(NamedTuple):
    symbols: jnp.ndarray   # (..., M) complex64, zero-padded past `count`
    count: jnp.ndarray     # (...,) int32 valid symbols
    best_phase: jnp.ndarray  # (...,) int32


def best_phase_pick(x: jnp.ndarray, sps: int, step: int | None = None
                    ) -> TimedSymbols:
    """x: (..., N) complex.  Returns symbols sampled at the best phase.

    Matches processor.py:186-215: phases range(0, sps, step) with
    step = max(1, sps // 8); per-phase mean power over (N - p)//sps samples;
    strict-> argmax (ties: lowest phase).
    """
    if sps <= 1:
        n = x.shape[-1]
        return TimedSymbols(
            x.astype(jnp.complex64),
            jnp.full(x.shape[:-1], n, jnp.int32),
            jnp.zeros(x.shape[:-1], jnp.int32))

    if step is None:
        step = max(1, sps // 8)
    n = x.shape[-1]
    m = -(-n // sps)                      # capacity: ceil(n / sps)
    phases = jnp.arange(0, sps, step, dtype=jnp.int32)   # (P,)

    # phase p's samples are column p of the (M, sps) reshape — a pad +
    # free reshape, never a gather or transpose.  Zero padding
    # makes per-phase validity masks redundant for the power SUMS (the
    # padded samples contribute 0), so the (P, M) mask/power arrays the
    # old formulation materialized disappear entirely.
    k = jnp.arange(m, dtype=jnp.int32)
    counts = (n - phases) // sps                          # (P,)
    xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, m * sps - n)])
    grid = xp.reshape(x.shape[:-1] + (m, sps))            # free reshape
    power_sums = (jnp.abs(grid) ** 2).sum(axis=-2)        # (..., sps)
    # reference quirk: phase p's count is (n-p)//sps, which can EXCLUDE
    # up to two real trailing samples (not just the zero padding) — the
    # floor-difference bounds the invalid region to the grid's last two
    # rows, so subtract just those where k >= count instead of carrying
    # a (P, M) mask
    r0 = max(m - 2, 0)
    tail_power = jnp.abs(grid[..., r0:, :]) ** 2          # (..., R, sps)
    k_tail = jnp.arange(r0, m)[:, None]                   # (R, 1)
    counts_full = (n - jnp.arange(sps)) // sps            # (sps,)
    invalid = k_tail >= counts_full[None, :]
    power_sums = power_sums - jnp.sum(
        jnp.where(invalid, tail_power, 0.0), axis=-2)
    mean_power = (power_sums[..., ::step]
                  / jnp.maximum(counts, 1).astype(jnp.float32))
    # phases with zero symbols are skipped by the reference (`continue`)
    mean_power = jnp.where(counts > 0, mean_power, -jnp.inf)

    best = jnp.argmax(mean_power, axis=-1)                # first max wins
    best_phase = phases[best]
    count = (n - best_phase) // sps

    sym = jnp.take_along_axis(
        grid, best_phase[..., None, None], axis=-1)[..., 0]
    sym = jnp.where(k < count[..., None], sym, 0.0 + 0.0j)
    return TimedSymbols(sym.astype(jnp.complex64),
                        count.astype(jnp.int32),
                        best_phase.astype(jnp.int32))
