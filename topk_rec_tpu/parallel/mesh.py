"""Device meshes and sharding helpers.

The reference is strictly single-process / single-device (SURVEY.md §2.4);
multi-device execution is a greenfield component here: a
``jax.sharding.Mesh`` with a data axis (batch) and a model axis
(embedding-table rows), ``NamedSharding`` annotations on the tables, and
XLA-inserted collectives (NCCL on GPUs) — no hand-written
communication.

Mesh convention:
  * axis "dp": data parallel — triplet batches are split across it.
  * axis "mp": model parallel — user/item embedding tables are row-sharded
    across it; gathers/scatters on sharded tables become XLA collective
    gathers.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    n_devices: Optional[int] = None,
    dp: Optional[int] = None,
    mp: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a (dp, mp) mesh over the available devices.

    With only ``n_devices`` given, prefers the most model parallelism that
    divides the device count (mp = n, dp = 1 is wrong for throughput, so we
    split roughly square: dp x mp with dp >= mp).
    """
    if devices is None:
        devices = jax.devices()[: n_devices or len(jax.devices())]
    n = len(devices)
    if dp is None or mp is None:
        mp = mp or _largest_pow2_leq(int(np.sqrt(n)))
        while n % mp:
            mp //= 2
        dp = n // mp
    assert dp * mp == n, f"dp({dp}) * mp({mp}) != devices({n})"
    dev_array = np.asarray(devices).reshape(dp, mp)
    return Mesh(dev_array, axis_names=("dp", "mp"))


def _largest_pow2_leq(x: int) -> int:
    p = 1
    while p * 2 <= x:
        p *= 2
    return p


def shard_params(mesh: Mesh, params: Dict, specs: Dict) -> Dict:
    """Place a pytree of arrays with the given PartitionSpecs."""
    return {
        name: jax.device_put(arr, NamedSharding(mesh, specs[name]))
        for name, arr in params.items()
    }


def replicate(mesh: Mesh, tree):
    """Fully replicate a pytree across the mesh."""
    sharding = NamedSharding(mesh, P())
    return jax.tree.map(lambda a: jax.device_put(a, sharding), tree)


# Canonical shardings for the recommendation workload: embedding tables
# row-sharded over "mp" (the catalog/user axis is the long axis of this
# workload — SURVEY.md §5), feature matrices row-sharded likewise, scalars
# and small dense parameters replicated.
BPR_PARAM_SPECS = {
    "ue": P("mp", None),
    "ie": P("mp", None),
    "ib": P("mp"),
}

VBPR_PARAM_SPECS = {
    "ure": P("mp", None),
    "uce": P("mp", None),
    "ire": P("mp", None),
    "irb": P("mp"),
    "cem": P(None, None),
    "icb": P(None),
}
