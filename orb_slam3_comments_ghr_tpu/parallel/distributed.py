"""Multi-host runtime (SURVEY §2.3 P7 / §5.8).

The reference is a single-process system — its entire "communication
backend" is std::list queues behind mutexes. The scale-out story here
replaces that with `jax.distributed` + a global device mesh: every host runs
the same program, the Atlas map-point blocks are sharded over the mesh's
'mp' axis (parallel.dba.shard_problem), residual/Hessian blocks are computed
where the data lives, and the Schur-reduced camera system is psum-reduced
by XLA's collectives (NCCL between GPUs, over NVLink within a host) — no
hand-written RPC anywhere.

On a single process (one host's GPUs, or the virtual 8-device CPU mesh of
the tests) everything below degrades gracefully: `initialize()` is a no-op
and the global mesh is just the local devices.

Env contract (standard jax.distributed):
    SLAM_COORDINATOR  host:port of process 0  (or JAX_COORDINATOR_ADDRESS)
    SLAM_NUM_PROCS    total process count     (or JAX_NUM_PROCESSES)
    SLAM_PROC_ID      this process's id       (or JAX_PROCESS_ID)
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> bool:
    """Bring up jax.distributed when a multi-process launch is configured;
    no-op (returns False) in single-process runs. Safe to call twice."""
    import jax

    coordinator = coordinator or os.environ.get(
        "SLAM_COORDINATOR", os.environ.get("JAX_COORDINATOR_ADDRESS"))
    n = num_processes if num_processes is not None else int(
        os.environ.get("SLAM_NUM_PROCS",
                       os.environ.get("JAX_NUM_PROCESSES", "1")))
    if not coordinator or n <= 1:
        return False
    pid = process_id if process_id is not None else int(
        os.environ.get("SLAM_PROC_ID", os.environ.get("JAX_PROCESS_ID", "0")))
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator, num_processes=n, process_id=pid
        )
    except RuntimeError as e:  # already initialized
        if "already" not in str(e).lower():
            raise
    return True


def global_mesh(axis: str = "mp"):
    """One-axis mesh over every device of every process — the landmark-shard
    axis for distributed BA. ICI/DCN placement is XLA's job: devices are
    ordered so the axis runs over ICI first (devices within a process are
    contiguous in jax.devices())."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()), (axis,))


def process_info() -> dict:
    import jax

    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }
