"""Device selection, the host->device input boundary and the compile cache.

The entry points (CLI, bench.py, chip_smoke.py) run on JAX's default
backend unless the user asks for the CPU explicitly; nothing here probes
the device or retries a failed run somewhere else.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

CHECKOUT = Path(__file__).resolve().parents[2]


def apply_platform(platform: str) -> None:
    """Pin JAX to the CPU when asked ("cpu"); "default" keeps JAX's own
    choice.  Must run before the first backend use."""
    if platform == "cpu":
        import jax
        jax.config.update("jax_platforms", "cpu")
    elif platform != "default":
        raise ValueError(f"unknown platform {platform!r}")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is honoured as JAX reads it
    and nothing is set in code.  Otherwise the cache lives at the fixed
    ``<checkout>/.jax_cache`` on every backend (the path is part of the
    cache key, so it must not move between runs)."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    cache = CHECKOUT / ".jax_cache"
    cache.mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(cache))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return str(cache)


def ensure_complex_on_device(x):
    """Model-boundary input guard: device arrays (and tracers) pass
    through with a complex64 cast; host arrays are transferred as
    complex64."""
    import jax
    import jax.numpy as jnp

    if isinstance(x, (jax.core.Tracer, jax.Array)):
        return jnp.asarray(x, jnp.complex64)
    return jax.device_put(np.asarray(x, np.complex64))
