"""Multi-process distributed runtime glue (SURVEY.md §2.3 / §5.8).

TETRA carriers never communicate and time halos only touch ring
neighbours, so the multi-host recipe is:

  1. `initialize_distributed(coordinator, num_processes, process_id)` on
     every process (jax.distributed; nothing tells JAX of a cluster, so
     the caller names all three);
  2. build one global (carrier, time) mesh over jax.devices()
     (`make_global_mesh`: time within a host, carrier across hosts);
  3. each host device_puts its own IQ shard (per-host ingestion,
     `host_local_shard`) and runs the jitted sharded step
     (parallel/sharded.py); ragged decode results return host-side per
     shard and are stitched locally (ShardedReceiver.decode) — no global
     gather needed because frame ownership is shard-local.

A single process needs no initialization: everything below works on one
host and on the CPU test mesh as it is.
"""

from __future__ import annotations

import logging
from typing import Optional

logger = logging.getLogger(__name__)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> bool:
    """Initialize jax.distributed; returns True when multi-process.

    No coordinator address means a single-process run: nothing is
    initialized and False is returned.  With one, `num_processes` and
    `process_id` are required and any initialization error raises."""
    if coordinator_address is None:
        return False
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator address needs num_processes and "
                         "process_id")
    import jax

    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    logger.info("jax.distributed: process %d/%d, %d local / %d global "
                "devices", jax.process_index(), jax.process_count(),
                jax.local_device_count(), jax.device_count())
    return jax.process_count() > 1


def host_local_shard(total_samples: int) -> tuple[int, int]:
    """(start, length) of this host's slice of a time-sharded stream,
    aligned to the decimation*sps grid so shard contracts hold."""
    import jax

    grid = 130  # decim * sps at reference rates
    nproc = jax.process_count()
    pid = jax.process_index()
    per = (total_samples // nproc // grid) * grid
    return pid * per, per


def make_global_mesh(time_axis_per_host: int = 1):
    """(carrier, time) mesh over all global devices: the time axis spans
    the devices *within* each host, the carrier axis spans hosts (carriers
    never communicate, so only halos cross the host's own links)."""
    import jax

    from tetraear_tpu.parallel.mesh import make_mesh

    n_local = jax.local_device_count()
    n_total = jax.device_count()
    time_size = min(time_axis_per_host * max(n_local, 1), n_total)
    while n_total % time_size:
        time_size -= 1
    return make_mesh(carrier=n_total // time_size, time=time_size)
