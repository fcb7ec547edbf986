"""Mesh construction + multi-host initialization helpers.

The reference is single-process (SURVEY.md §2c).  Multi-host runs here use
jax.distributed + a Mesh('time', 'ch') spanning all hosts: time segments ride
the outer axis (host-to-host over the interconnect), channel shards the
inner axis.  On a single host this degenerates gracefully.
"""

from __future__ import annotations

import os

import numpy as np
import jax
from jax.sharding import Mesh

__all__ = ["init_distributed", "build_mesh"]


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None):
    """Initialize jax.distributed from args or the standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID).  No-op if
    single-process and nothing is configured."""
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator is None:
        return False
    if num_processes is None:
        env = os.environ.get("JAX_NUM_PROCESSES")
        num_processes = int(env) if env is not None else None
    if process_id is None:
        # `or` would discard an explicit process_id=0 (rank 0!)
        env = os.environ.get("JAX_PROCESS_ID")
        process_id = int(env) if env is not None else None
    # leave unset values as None: jax.distributed auto-detects them from the
    # cluster environment (scheduler metadata, etc.) — hardcoding 1/0 would
    # make every rank claim world-size 1 rank 0 and wedge the join
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def build_mesh(time_shards: int | None = None, ch_shards: int = 1) -> Mesh:
    """Mesh over all (global) devices: ('time', 'ch').  Defaults to all
    devices on the time axis."""
    devs = jax.devices()
    n = len(devs)
    if time_shards is None:
        time_shards = n // ch_shards
    assert time_shards * ch_shards == n, (time_shards, ch_shards, n)
    return Mesh(np.asarray(devs).reshape(time_shards, ch_shards), ("time", "ch"))
