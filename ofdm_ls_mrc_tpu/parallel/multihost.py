"""Multi-process scaling for long captures and split antenna arrays.

The reference's only inter-host transport is the radio link + UHD network
(SURVEY.md section 2 end); it never scales compute past one box.  Here the
symbol/time axis -- the reference's sequence axis (ShMemSymBuff.hpp:97-106) --
shards across processes via ``jax.distributed``, while the antenna axis
stays inside each host's cards (NVLink) so the MRC psum never crosses the
slower host network (the efficiency cliff flagged in SURVEY.md section 7).

Topology recipe for N hosts x D cards:
  mesh = make_mesh(ant_shards=D, time_shards=N)  # ant: NVLink, time: network
with each host's ingest process feeding its own time-block through its local
shm ring (global_from_host_blocks assembles the global array).  One process
per card on a host passes ``local_device_ids`` so that each opens only its
own card (a JAX process reserves most of every card it opens).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.cplx import CArray
from .mesh import ANT_AXIS, TIME_AXIS


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None) -> None:
    """Bring up jax.distributed for a multi-process run.

    Thin wrapper so apps have one entry point; with no args JAX reads the
    cluster env (a bare machine has none: pass the coordinator, count and
    id).  ``local_device_ids`` restricts this process to those local cards.
    Safe to call once per process.
    """
    # Pass through exactly what the caller pinned; jax.distributed accepts
    # any subset (e.g. num_processes/process_id with the coordinator taken
    # from the environment) -- dropping a given field would silently
    # auto-configure the wrong topology.
    kwargs = {k: v for k, v in (("coordinator_address", coordinator_address),
                                ("num_processes", num_processes),
                                ("process_id", process_id),
                                ("local_device_ids", local_device_ids))
              if v is not None}
    jax.distributed.initialize(**kwargs)


def make_multihost_mesh(ant_shards: Optional[int] = None,
                        time_shards: Optional[int] = None) -> Mesh:
    """(ant, time) mesh over all global devices.

    Defaults: antenna axis spans each process's local cards, time axis
    spans processes -- the layout where the MRC psum stays intra-host.
    Devices are taken in ``jax.devices()`` order (process-major), so with
    ``time_shards=1`` antenna shard i lands on the i-th global device.
    """
    n_local = jax.local_device_count()
    n_proc = jax.process_count()
    ant = ant_shards or n_local
    time = time_shards or n_proc
    have = len(jax.devices())
    if ant * time > have:
        raise ValueError(f"mesh {ant}x{time} needs {ant * time} devices, "
                         f"have {have}")
    devs = np.array(jax.devices()[: ant * time]).reshape(time, ant).T
    return Mesh(devs, (ANT_AXIS, TIME_AXIS))


def global_from_antenna_blocks(local_block: np.ndarray, mesh: Mesh,
                               ant_axis: int = 1) -> CArray:
    """Assemble a global ANTENNA-sharded frame from each host's local block.

    The BASELINE config-5 complement to time-block sharding: each host's SDR
    front-end ingests a SUBSET of the antennas for ALL symbols (64-antenna
    array split across N hosts), so every process contributes its own
    [S, A_local, F] complex64 block, and the global [S, A, ...] array lands
    antenna-sharded with no cross-host data movement.  On a time_shards==1
    mesh the fused MRC psum is then the only cross-process traffic, a fixed
    (2*S_data + 1) * F fp32 words per frame regardless of antenna count.
    ``ant_axis`` names the antenna dimension of the block (0 for a pilot
    [A_local, F] row, 1 for [S, A_local, ...] frames).
    """
    spec_axes = [None] * local_block.ndim
    spec_axes[ant_axis] = ANT_AXIS
    sharding = NamedSharding(mesh, P(*spec_axes))
    re = np.ascontiguousarray(local_block.real, dtype=np.float32)
    im = np.ascontiguousarray(local_block.imag, dtype=np.float32)
    gre = jax.make_array_from_process_local_data(sharding, re)
    gim = jax.make_array_from_process_local_data(sharding, im)
    return CArray(gre, gim)


def global_from_host_blocks(local_block: np.ndarray, mesh: Mesh) -> CArray:
    """Assemble a global time-sharded array from each host's local block.

    Each process contributes its own [S_local, A, F] complex64 block (read
    from its local ring); the result is a global [S_total, A, F] planar
    CArray sharded (time, ant, -) without any cross-host data movement.
    """
    spec = P(TIME_AXIS, ANT_AXIS, None)
    sharding = NamedSharding(mesh, spec)
    re = np.ascontiguousarray(local_block.real, dtype=np.float32)
    im = np.ascontiguousarray(local_block.imag, dtype=np.float32)
    gre = jax.make_array_from_process_local_data(sharding, re)
    gim = jax.make_array_from_process_local_data(sharding, im)
    return CArray(gre, gim)
