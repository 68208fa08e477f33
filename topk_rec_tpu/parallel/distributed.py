"""Multi-process (multi-host) execution support.

The reference is strictly single-process (SURVEY.md §2.4); this is the
greenfield multi-host path: each host runs one process, ``initialize``
joins them through JAX's coordination service, and every mesh built from
``jax.devices()`` afterwards is a GLOBAL mesh — NamedSharding placements
and jit-compiled collectives then span hosts with no further code
changes. The distributed trainers and
the fused distributed ALS sweep (parallel/train_step.py, parallel/als.py)
run unmodified on such meshes; only host-side reads need ``fetch`` (a
replicate-to-all collective) because shards on other hosts are not
addressable locally.

Tested without several hosts via two CPU processes with virtual devices
(tests/test_multiprocess.py — Gloo collectives over localhost), per the
SURVEY §4 multi-host test strategy.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids=None,
) -> None:
    """Join this process to a multi-process JAX run.

    Thin wrapper over ``jax.distributed.initialize`` with env-var
    fallbacks (``TKR_COORDINATOR`` / ``TKR_NUM_PROCESSES`` /
    ``TKR_PROCESS_ID``) so launchers can configure workers without code.
    Must run before the backend initializes (i.e. before any jax op).
    """
    coordinator_address = coordinator_address or os.environ.get(
        "TKR_COORDINATOR"
    )
    if num_processes is None and "TKR_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["TKR_NUM_PROCESSES"])
    if process_id is None and "TKR_PROCESS_ID" in os.environ:
        process_id = int(os.environ["TKR_PROCESS_ID"])
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )


def is_multiprocess() -> bool:
    return jax.process_count() > 1


def fetch(arr) -> np.ndarray:
    """Read a (possibly multi-host-sharded) array back to host memory.

    Single-process / fully-addressable arrays copy directly. A global
    array with shards on other hosts is first replicated across the mesh
    (one XLA all-gather), after which every process holds
    the full value and can read it locally.
    """
    if isinstance(arr, np.ndarray):
        return arr
    if getattr(arr, "is_fully_addressable", True):
        return np.asarray(arr)
    mesh = arr.sharding.mesh
    replicated = jax.jit(
        lambda x: x, out_shardings=NamedSharding(mesh, P())
    )(arr)
    return np.asarray(replicated)
