"""Serving surface: low-latency batched top-k recommendation queries.

The reference has no serving path (its "serving" is the offline
evaluate.py batch job); this is the production-facing API the framework
adds: device-resident embedding tables + seen bitmaps, jit-compiled query
scoring with two selection methods:

  * ``exact``  — lax.top_k over the masked score row (protocol-exact for
    the scores the query matmul produces);
  * ``approx`` — jax.lax.approx_max_k (recall target 0.95). On the GPU
    it has no approximate lowering: XLA compiles it, like ``lax.top_k``
    on a [256, 10380] row block, to a cub radix sort plus a slice, and
    it returns the exact top-k.

The query matmul runs at DEFAULT precision (TF32 on the GPU); the offline
evaluator (eval/device.py) pins HIGHEST instead. Query latency has not been
measured on H100.

Seen-item exclusion uses the packed training bitmap exactly like offline
eval, so served lists match evaluate-time semantics.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .data.dataset import Interactions
from .ops.mask import expand_seen_mask

METHODS = ("exact", "approx")


@partial(jax.jit, static_argnames=("k", "method", "n_items", "seen_format"))
def _query(
    user_emb: jax.Array,     # [B, dim] gathered user rows
    V: jax.Array,            # [n_items, dim]
    bias: Optional[jax.Array],
    seen_rows: jax.Array,    # bitmap: [B, n_words] uint32; lists: [B, D] i32
    k: int,
    method: str,
    n_items: int,
    seen_format: str = "bitmap",
):
    if seen_format == "lists":
        # sparse seen-sets: scatter each user's padded sorted item list
        # into a query-batch-sized dense mask (pad slot = n_items lands in
        # the throwaway column). The [B, n_items] mask is transient — only
        # the per-USER store changes representation.
        b = seen_rows.shape[0]
        mask = (
            jnp.zeros((b, n_items + 1), jnp.int8)
            .at[jnp.arange(b)[:, None], seen_rows]
            .set(1)[:, :n_items]
        )
    else:
        mask = expand_seen_mask(seen_rows, n_items)
    scores = jnp.dot(user_emb, V.T, preferred_element_type=jnp.float32)
    if bias is not None:
        scores = scores + bias[None, :]
    scores = jnp.where(mask != 0, -jnp.inf, scores)
    if method == "approx":
        return jax.lax.approx_max_k(scores, k)
    return jax.lax.top_k(scores, k)


class TopKServer:
    """Holds one model's tables on device and answers top-k queries."""

    def __init__(
        self,
        U: np.ndarray,
        V: np.ndarray,
        bias: Optional[np.ndarray] = None,
        interactions: Optional[Interactions] = None,
        exclude_seen: bool = True,
        mesh=None,
        seen_format: str = "bitmap",
        table_dtype=None,
    ):
        """``table_dtype=jnp.bfloat16`` stores the embedding tables at
        half the device memory (the headroom knob for huge user bases).
        Scores then come from the bf16-rounded embeddings (the bias stays
        fp32): they equal the oracle computed from bf16-rounded tables
        (tests/test_serving.py), and differ from fp32-table scores by the
        bf16 rounding of the inputs.

        ``seen_format`` picks the per-user seen-set store:

        * ``"bitmap"`` (default): dense uint32 bitmap,
          n_users x n_items/8 bytes — ~91 MB at MovieLens scale, the
          right choice while catalog x users fits HBM (envelope: 1M users
          x 100K items = 12.5 GB/chip undistributed; row-sharding over
          ``mesh`` divides it by the shard count).
        * ``"lists"``: padded sorted per-user item lists,
          n_users x max_degree x 4 bytes — wins when 32 x max_degree <
          n_items (e.g. 10M users x 1M items at max 512 seen: 20 GB vs
          the bitmap's 1.25 TB). Queries scatter each batch row's list
          into a transient [batch, n_items] mask; results are identical
          (tests/test_serving.py).
        """
        dt = jnp.float32 if table_dtype is None else table_dtype
        self.U = jnp.asarray(U, dtype=dt)
        self.V = jnp.asarray(V, dtype=dt)
        self.bias = (
            jnp.asarray(bias, dtype=jnp.float32).reshape(-1)
            if bias is not None
            else None
        )
        self.n_items = self.V.shape[0]
        assert seen_format in ("bitmap", "lists"), seen_format
        self.seen_format = seen_format
        n_words = (self.n_items + 31) // 32
        if exclude_seen and interactions is not None:
            if seen_format == "lists":
                indptr, flat = interactions.user_csr
                deg = np.diff(indptr)
                D = max(1, int(deg.max()))
                lists = np.full(
                    (self.U.shape[0], D), self.n_items, np.int32
                )
                # vectorized CSR->padded scatter: at the 10M-user scale
                # this format exists for, a per-user Python loop costs
                # minutes of interpreter time (ADVICE r4)
                rows = np.repeat(np.arange(len(deg)), deg)
                cols = np.arange(len(flat)) - np.repeat(indptr[:-1], deg)
                lists[rows, cols] = flat
                self.seen = jnp.asarray(lists)
            else:
                self.seen = jnp.asarray(interactions.seen_bitmap)
        elif seen_format == "lists":
            self.seen = jnp.full((self.U.shape[0], 1), self.n_items, jnp.int32)
        else:
            self.seen = jnp.zeros((self.U.shape[0], n_words), jnp.uint32)
        # distributed serving: the user table (the big one — 69878 rows at
        # MovieLens scale, millions in production) and its per-user seen
        # store (either format) live row-sharded across the mesh; per-query
        # user rows are fetched via the explicit deduplicated all-to-all
        # exchange (parallel/lookup.py) while the item table replicates
        # (it is small and every shard scores against all items).
        self.mesh = mesh
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            from .parallel.lookup import sharded_lookup  # noqa: F401

            self._mp = NamedSharding(mesh, P("mp", None))
            self.U = jax.device_put(self.U, self._mp)
            self.seen = jax.device_put(self.seen, self._mp)
            repl = NamedSharding(mesh, P())
            self.V = jax.device_put(self.V, repl)
            if self.bias is not None:
                self.bias = jax.device_put(self.bias, repl)

    @classmethod
    def from_model(cls, model, exclude_seen: bool = True) -> "TopKServer":
        return cls(
            model.fue, model.fie, model.fib, model.inter, exclude_seen
        )

    def recommend(
        self,
        user_ids: np.ndarray,
        k: int = 30,
        method: str = "exact",
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k unseen items for a batch of users.

        ``method`` is one of ``METHODS``. Returns (scores [B, k], item_ids [B, k]); slots with score -inf
        mean the user has fewer than k unseen items.
        """
        from .parallel.distributed import fetch

        n = len(np.asarray(user_ids))
        while True:
            vals, idx = self.recommend_async(user_ids, k, method)
            v = np.asarray(fetch(vals))[:n]
            if self.mesh is None or not np.isnan(v).any():
                return v, np.asarray(fetch(idx))[:n]
            # overflow poison (see recommend_async): grow the sticky
            # capacity and re-issue; capacity == b_local cannot overflow,
            # so the loop is bounded
            cap = self._lookup_capacity
            if cap >= self._cap_limit:  # NaN came from the data itself
                return v, np.asarray(fetch(idx))[:n]
            self._lookup_capacity = min(2 * cap, self._cap_limit)

    def recommend_async(
        self,
        user_ids: np.ndarray,
        k: int = 30,
        method: str = "exact",
    ):
        """Dispatch a query batch WITHOUT synchronizing; returns device
        arrays. A server loop that dispatches many batches and fetches
        results as they complete overlaps host work with device compute
        instead of waiting on every batch. Slice results to the request
        length (mesh-padded batches return padded rows)."""
        if method not in METHODS:
            raise ValueError(
                f"unknown method {method!r}; expected one of {METHODS}"
            )
        uid = np.asarray(user_ids, dtype=np.int32)
        if self.mesh is not None:
            from .parallel.lookup import sharded_lookup

            n_shards = self.U.sharding.mesh.shape["mp"]
            pad = (-len(uid)) % n_shards
            uid_p = np.pad(uid, (0, pad))
            b_local = len(uid_p) // n_shards
            # overflow handling (the documented retry/resize contract of
            # parallel/lookup.py) WITHOUT a per-query host sync: the
            # result values are NaN-poisoned on device when any lookup
            # overflowed, so the caller's own result fetch doubles as the
            # check — zero extra round trips on the common path.
            # ``recommend`` detects the poison, doubles the sticky
            # capacity (bounded by b_local, which cannot overflow) and
            # re-issues; async callers observe NaNs on their fetch and
            # re-issue the batch the same way, never consuming silently
            # short results.
            if not hasattr(self, "_lookup_capacity"):
                self._lookup_capacity = 2 * (-(-b_local // n_shards))
            self._cap_limit = b_local
            cap = min(self._lookup_capacity, b_local)
            u_rows, ovf_u = sharded_lookup(
                self.U, uid_p, self.mesh, capacity=cap
            )
            s_rows, ovf_s = sharded_lookup(
                self.seen, uid_p, self.mesh, capacity=cap
            )
            vals, idx = _query(
                u_rows, self.V, self.bias, s_rows, k, method, self.n_items,
                self.seen_format,
            )
            overflowed = (jnp.sum(ovf_u) + jnp.sum(ovf_s)) > 0
            vals = jnp.where(overflowed, jnp.nan, vals)
            return vals, idx
        # single-dispatch local path: the user-row and seen-row gathers
        # run INSIDE the jit (3 eager dispatches + 1 call per batch
        # otherwise — per-batch dispatch dominates small-batch serving)
        return _query_local(
            self.U,
            self.V,
            self.bias,
            self.seen,
            jnp.asarray(uid),
            k,
            method,
            self.n_items,
            self.seen_format,
        )


@partial(
    jax.jit, static_argnames=("k", "method", "n_items", "seen_format")
)
def _query_local(U, V, bias, seen, uid, k, method, n_items, seen_format):
    return _query(
        U[uid], V, bias, seen[uid], k, method, n_items, seen_format
    )
