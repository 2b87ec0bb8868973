"""Device-mesh construction for the (carrier, time) sharding layout.

The workload's parallel axes (SURVEY.md §2.3):
  carrier — independent RF channels (the DSP analogue of DP/EP)
  time    — one long sample stream split into blocks (the SP/CP analogue),
            stitched with overlap-save halos exchanged via ppermute.

The mesh follows the algorithm alone: the cards of one host are joined
all to all (NVLink), so any device order serves.  Carriers never
communicate; only the time axis exchanges halos.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
from jax.sharding import Mesh

CARRIER_AXIS = "carrier"
TIME_AXIS = "time"


def make_mesh(carrier: Optional[int] = None, time: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a (carrier, time) mesh over the given devices.

    With no sizes given, all devices go to the carrier axis (carriers are
    embarrassingly parallel — prefer that axis when the carrier count
    allows).
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if carrier is None and time is None:
        carrier, time = n, 1
    elif carrier is None:
        assert n % time == 0, (n, time)
        carrier = n // time
    elif time is None:
        assert n % carrier == 0, (n, carrier)
        time = n // carrier
    assert carrier * time <= n, (carrier, time, n)
    devices = devices[:carrier * time]
    import numpy as np
    dev_grid = np.asarray(devices).reshape(carrier, time)
    return Mesh(dev_grid, (CARRIER_AXIS, TIME_AXIS))


def factor_mesh(n: int) -> tuple[int, int]:
    """Default (carrier, time) factorization for n devices: prefer a 2-ish
    time axis so halo exchange paths are exercised."""
    if n == 1:
        return (1, 1)
    if n % 2 == 0:
        return (n // 2, 2)
    return (n, 1)
