"""Device-mesh construction for the sharded receiver.

The reference's concurrency axes (SURVEY.md section 2) map onto a 2-D
logical mesh:

* ``ant``  -- the antenna axis.  The reference puts one CUDA block-row per
  antenna and tree-reduces over them in shared memory (gpuLS.cu:52-53,
  198-203,247-252); here antenna shards live on different cards and the MRC
  reduction is a ``psum`` (NCCL over NVLink on one host).
* ``time`` -- the OFDM symbol axis.  The reference batches symbols into a
  3-D grid z-axis (gpuLS.cu:740-750); here time-blocks are embarrassingly
  parallel data shards (no collectives, so cheap across hosts).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

ANT_AXIS = "ant"
TIME_AXIS = "time"


def make_mesh(ant_shards: int = 1, time_shards: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build an (ant, time) mesh over the given (or all) devices.

    The ``ant`` axis is placed first because the MRC psum is the
    latency-critical collective; the ``time`` axis carries no collectives.
    """
    devs = list(devices) if devices is not None else jax.devices()
    need = ant_shards * time_shards
    if len(devs) < need:
        raise ValueError(f"need {need} devices, have {len(devs)}")
    grid = np.array(devs[:need]).reshape(ant_shards, time_shards)
    return Mesh(grid, (ANT_AXIS, TIME_AXIS))


def frame_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for a [S, A, F] data block: symbols over time, antennas over ant."""
    return NamedSharding(mesh, P(TIME_AXIS, ANT_AXIS, None))


def pilot_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for the [A, F] pilot symbol: antennas over ant, replicated over time."""
    return NamedSharding(mesh, P(ANT_AXIS, None))


def output_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for the [S, F] demod output: symbols over time, replicated over ant."""
    return NamedSharding(mesh, P(TIME_AXIS, None))
