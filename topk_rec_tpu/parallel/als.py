"""Mesh-distributed weighted-ALS sweeps.

The batched ALS block update (ops/als.py) is embarrassingly parallel over
entities: each block row solves an independent k×k system. Distribution
strategy: within each block, shard the entity axis across every mesh
device (S, the normal-equation products, and the batched solves all
partition row-wise; the fixed-side embeddings / VV / Gram are replicated —
at k=50 the replicated bytes are far smaller than the per-entity work).
XLA/GSPMD partitions the S·VV and S·V matmuls and the batched solve with
no collectives on the hot path; only the block's (rows, cols) index lists
are broadcast.

The whole half-sweep — every block — runs as ONE compiled ``lax.scan``
device program (the same fused sweep as the single-device path,
ops/als.py ``_sweep_impl``): there are no per-block host round trips.

This is the multi-device analog of the reference's single-process GSL
solver loop (old/cr/cr.cpp:146-216): same math, entity-parallel across
devices.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.als import ALSPlan, _sweep_impl


class DistributedALS:
    """Runs fused half-sweeps with block entities sharded over all mesh
    devices. Drop-in for ``ops.als.half_sweep`` (same signature/semantics),
    so models route through it transparently when given a mesh."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.axes = tuple(mesh.axis_names)  # shard entity rows over all axes
        self._fn_cache = {}

    def _build(
        self,
        block_size: int,
        n_this: int,
        use_prior: bool,
        keep_old_unrated: bool,
    ):
        key = (block_size, n_this, use_prior, keep_old_unrated)
        if key in self._fn_cache:
            return self._fn_cache[key]
        mesh = self.mesh
        row_shard = NamedSharding(mesh, P(self.axes, None))
        repl = NamedSharding(mesh, P())

        def constrain(x):
            # per-block row-major intermediate ([block, n_other] S or
            # [block, k] solution): pin entity rows across the mesh
            return jax.lax.with_sharding_constraint(x, row_shard)

        # out sharding for the [n_this, k] result is left to GSPMD:
        # n_this need not divide the device count (explicit row sharding
        # would reject e.g. 60 users on 8 devices); the per-block
        # constraints above still shard all the compute.
        fn = jax.jit(
            partial(
                _sweep_impl,
                block_size=block_size,
                n_this=n_this,
                use_prior=use_prior,
                keep_old_unrated=keep_old_unrated,
                constrain=constrain,
            ),
            out_shardings=(None, repl),
        )
        self._fn_cache[key] = fn
        return fn

    def half_sweep(
        self,
        plan: ALSPlan,
        this_emb,
        other_emb,
        rated_other,
        a: float,
        b: float,
        lam: float,
        prior: Optional[np.ndarray] = None,
        keep_old_unrated: bool = True,
        as_numpy: bool = True,
    ) -> Tuple[np.ndarray, float]:
        """Drop-in distributed equivalent of ops.als.half_sweep.

        ``as_numpy=False`` returns device arrays (embeddings stay sharded
        per GSPMD's choice, fit is a replicated scalar) so training loops
        avoid the per-sweep host round trip — same contract as
        ops.als.half_sweep.
        """
        other_emb = jnp.asarray(other_emb)
        k = other_emb.shape[1]
        n_other = other_emb.shape[0]
        rated_mask = (
            jnp.zeros(n_other, jnp.float32)
            .at[jnp.asarray(rated_other)]
            .set(1.0)
        )
        use_prior = prior is not None
        prior_dev = (
            jnp.asarray(prior)
            if use_prior
            else jnp.zeros((plan.n_this, k), jnp.float32)
        )
        fn = self._build(
            plan.block_size,
            plan.n_this,
            use_prior,
            keep_old_unrated and not use_prior,
        )
        new, fit = fn(
            plan.rows_stack,
            plan.cols_stack,
            plan.deg_stack,
            plan.perm,
            jnp.asarray(this_emb),
            other_emb,
            rated_mask,
            prior_dev,
            float(a),
            float(b),
            float(lam),
        )
        if not as_numpy:
            return new, fit
        # np.array (not asarray): callers mutate the result (cold-start
        # writeback) and jax buffers are read-only views. fetch() handles
        # multi-host shards (replicate-then-read).
        from .distributed import fetch

        return np.array(fetch(new)), float(fit)
