"""Explicit all-to-all embedding lookup AND update over row-sharded tables.

The distributed trainers lean on GSPMD to turn `table[idx]` into
collective gathers. Across hosts the parameter-server pattern is an
EXPLICIT exchange instead — deduplicate the
indices each device needs, route each unique index to the shard that
owns the row (fixed per-destination capacity so shapes stay static),
gather locally, route the rows back — the parameter-server step rebuilt
on ``shard_map`` + ``lax.all_to_all`` (SURVEY §2.4 "lookup/update via
all-to-all" / §7 "hard parts": dedup + capacity + overflow accounting;
the reference has no distribution at all, its only gather is a host
``embedding_lookup``, reference single/bpr.py:81-86). Both directions
live here: :func:`sharded_lookup` (forward gather, serving path) and
:func:`sharded_update` (reverse scatter-add, training path), plus the
owner-side RMSProp variant the explicit-exchange trainer compiles
(parallel/train_step.py ``exchange="explicit"``).

Layout (all static shapes; S shards, per-device batch b):
  1. sort + dedup the local indices (pad slots carry a sentinel);
  2. owners are contiguous runs of the sorted uniques (row-block
     sharding), so the [S, C] send buffer fills by run offset; uniques
     beyond a destination's capacity C are DROPPED and counted;
  3. ``all_to_all`` indices → each shard serves its rows → ``all_to_all``
     rows back;
  4. expand unique rows to the original occurrence order through the
     dedup segment map. Dropped/overflow slots return zero rows.

Returns per-device overflow counts so callers can size ``capacity`` (a
power-law-degree batch needs capacity ≈ batch/S only when indices are
uniformly owned — skewed batches need headroom; callers retry or resize
on overflow — serving.TopKServer doubles its capacity and re-issues,
bounded by capacity == local batch which can never overflow — and they
never get silently-wrong results: dropped lookups return zero rows plus
a per-occurrence validity mask (``_exchange(with_valid=True)``) that the
explicit-exchange trainer uses to void the whole triplet — loss AND
gradients — and dropped updates vanish atomically, so an overflowed
example behaves exactly like one removed from the batch).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

# plain int (NOT a jnp constant: module-level jnp array creation
# would initialize the XLA backend at import time and break
# jax.distributed.initialize ordering in multi-process workers)
_SENTINEL = 2**31 - 1

# jitted-exchange memo: sharded_lookup/sharded_update are function-level
# APIs called per query/step (TopKServer.recommend_async calls lookup
# twice per batch), and a fresh ``jax.jit(shard_map(partial(...)))``
# object per call would RETRACE every time (measured ~2 s/call on the
# two-process CPU mesh vs ~50 ms once cached). Keyed on everything that
# shapes the program; Mesh is hashable. Bounded LRU (ADVICE r4): a
# long-lived process cycling many meshes/shapes must not retain every
# compiled executable (and its Mesh) forever.
_JIT_CACHE = {}
_JIT_CACHE_MAX = 64


def _cached_jit(kind, body_fn, mesh, in_specs, out_specs, **static):
    key = (kind, mesh, in_specs, out_specs, tuple(sorted(static.items())))
    fn = _JIT_CACHE.pop(key, None)
    if fn is None:
        fn = jax.jit(
            jax.shard_map(
                partial(body_fn, **static),
                mesh=mesh,
                in_specs=in_specs,
                out_specs=out_specs,
            )
        )
    _JIT_CACHE[key] = fn  # re-insert = move to MRU end (dicts are ordered)
    while len(_JIT_CACHE) > _JIT_CACHE_MAX:
        _JIT_CACHE.pop(next(iter(_JIT_CACHE)))
    return fn


def _dedup_sorted(idx: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Sorted uniques (sentinel-padded) + occurrence→slot segment map."""
    b = idx.shape[0]
    order = jnp.argsort(idx)
    sidx = idx[order]
    first = jnp.concatenate([jnp.ones((1,), bool), sidx[1:] != sidx[:-1]])
    slot_sorted = (jnp.cumsum(first) - 1).astype(jnp.int32)
    seg = jnp.zeros((b,), jnp.int32).at[order].set(slot_sorted)
    uniq = jnp.full((b,), _SENTINEL, jnp.int32).at[slot_sorted].set(sidx)
    return uniq, seg


def _build_send(uniq, n_shards, rows_per_shard, capacity):
    """Route sorted uniques into the [S, C] send buffer (shared by the
    forward lookup and the reverse update).

    uniq ascending => owner nondecreasing: destination runs are
    contiguous; position within run = rank - first rank of that owner.
    Returns (send_idx, dst_row, dst_col, ok, overflow).
    """
    owner = jnp.where(
        uniq == _SENTINEL, n_shards, uniq // rows_per_shard
    ).astype(jnp.int32)
    start = jnp.searchsorted(
        owner, jnp.arange(n_shards, dtype=jnp.int32), side="left"
    )
    pos_in_run = jnp.arange(uniq.shape[0], dtype=jnp.int32) - start[
        jnp.minimum(owner, n_shards - 1)
    ]
    ok = (uniq != _SENTINEL) & (pos_in_run < capacity)
    overflow = jnp.sum((uniq != _SENTINEL) & ~ok)
    # not-ok entries scatter out of bounds so mode="drop" discards them
    # (clamping them instead would overwrite valid slots with sentinels)
    dst_row = jnp.where(ok, owner, n_shards)
    dst_col = jnp.where(ok, pos_in_run, capacity)
    send = (
        jnp.full((n_shards, capacity), _SENTINEL, jnp.int32)
        .at[dst_row, dst_col]
        .set(uniq, mode="drop")
    )
    return send, dst_row, dst_col, ok, overflow


def _exchange(table_local, idx_local, axis, n_shards, rows_per_shard,
              capacity, with_valid: bool = False):
    """Per-device body (runs under shard_map).

    ``with_valid=True`` additionally returns a per-occurrence bool mask
    (shape of ``idx_local``): False where the occurrence's unique index
    was dropped by capacity overflow and the returned row is a zero
    stand-in — the explicit-exchange trainer uses it to void those
    examples entirely rather than train on zero rows."""
    table_local = table_local  # [rows_per_shard, k]
    idx = idx_local.reshape(-1)  # [b]
    uniq, seg = _dedup_sorted(idx)
    send, dst_row, dst_col, ok, overflow = _build_send(
        uniq, n_shards, rows_per_shard, capacity
    )
    # route requests to owners; serve; route rows back
    recv = jax.lax.all_to_all(send, axis, split_axis=0, concat_axis=0)
    my_shard = jax.lax.axis_index(axis)
    local = recv - my_shard * rows_per_shard
    zero = jnp.zeros((), table_local.dtype)
    served = jnp.where(
        (recv != _SENTINEL)[..., None],
        table_local.at[jnp.clip(local, 0, rows_per_shard - 1)].get(),
        zero,
    )
    rows_back = jax.lax.all_to_all(served, axis, split_axis=0, concat_axis=0)
    # reconstruct per-unique rows, then expand to occurrences (ok entries
    # have dst_row = owner shard, dst_col = slot within its run)
    uniq_rows = jnp.where(
        ok[:, None],
        rows_back[
            jnp.minimum(dst_row, n_shards - 1),
            jnp.minimum(dst_col, capacity - 1),
        ],
        zero,
    )
    out = uniq_rows[seg]
    out = out.reshape(idx_local.shape + (table_local.shape[1],))
    ovf = overflow.reshape(1).astype(jnp.int32)
    if with_valid:
        return out, ok[seg].reshape(idx_local.shape), ovf
    return out, ovf


def sharded_lookup(
    table,
    idx,
    mesh: Mesh,
    axis: str = "mp",
    capacity: int = 0,
):
    """Gather ``table[idx]`` via explicit deduplicated all-to-all exchange.

    Args:
      table: [n_rows, k] (any dtype), row-sharded (or shardable) over
        ``axis``; n_rows must divide the axis size.
      idx: int32 [B] lookup indices, split over ``axis`` (B must divide).
      capacity: per-destination request slots per device; 0 picks
        ``2 * ceil(B_local / n_shards)`` (2x headroom over a uniform
        spread).

    Returns (rows [B, k], overflow int32[n_shards] — uniques dropped per
    requesting device; zero means the gather is exact).
    """
    n_shards = int(np.prod([
        s for s, n in zip(mesh.devices.shape, mesh.axis_names) if n == axis
    ]))
    n_rows, kdim = table.shape
    assert n_rows % n_shards == 0, (n_rows, n_shards)
    b_total = idx.shape[0]
    assert b_total % n_shards == 0, (b_total, n_shards)
    if capacity <= 0:
        capacity = 2 * (-(-(b_total // n_shards) // n_shards))
    rows_per_shard = n_rows // n_shards
    # other mesh axes are unused: keep table/idx replicated across them
    fn = _cached_jit(
        "lookup", _exchange, mesh,
        (P(axis, None), P(axis)), (P(axis, None), P(axis)),
        axis=axis, n_shards=n_shards, rows_per_shard=rows_per_shard,
        capacity=capacity,
    )
    table_d = jax.device_put(table, NamedSharding(mesh, P(axis, None)))
    idx_d = jax.device_put(
        jnp.asarray(idx, jnp.int32), NamedSharding(mesh, P(axis))
    )
    rows, overflow = fn(table_d, idx_d)
    return rows, overflow


# ---------------------------------------------------------------------------
# reverse exchange: scatter-add updates back to owning shards
# ---------------------------------------------------------------------------


def _route_contributions(idx_local, rows_local, k, axis, n_shards,
                         rows_per_shard, capacity):
    """Shared reverse-routing preamble (the mirror image of ``_exchange``):
    local dedup first (occurrences of the same row are segment-summed
    before they travel), then the same run-offset [S, C] send buffer for
    the indices and a [S, C, k] buffer for the summed rows, one
    ``all_to_all`` each, and translation to owner-local row indices
    (sentinel-preserving, so a ``mode="drop"`` scatter discards dead
    slots). Returns (local_idx [S·C], recv_rows [S·C, k], overflow).
    Used by both the plain scatter-add and the owner-side RMSProp apply —
    any routing-semantics change lands in exactly one place."""
    idx = idx_local.reshape(-1)
    b = idx.shape[0]
    uniq, seg = _dedup_sorted(idx)
    gsum = (
        jnp.zeros((b, k), rows_local.dtype)
        .at[seg]
        .add(rows_local.reshape(b, k))
    )
    send_idx, dst_row, dst_col, ok, overflow = _build_send(
        uniq, n_shards, rows_per_shard, capacity
    )
    send_rows = (
        jnp.zeros((n_shards, capacity, k), rows_local.dtype)
        .at[dst_row, dst_col]
        .set(gsum, mode="drop")
    )
    recv_idx = jax.lax.all_to_all(send_idx, axis, split_axis=0, concat_axis=0)
    recv_rows = jax.lax.all_to_all(
        send_rows, axis, split_axis=0, concat_axis=0
    )
    my_shard = jax.lax.axis_index(axis)
    local = jnp.where(
        recv_idx == _SENTINEL, _SENTINEL, recv_idx - my_shard * rows_per_shard
    ).reshape(-1)
    return local, recv_rows.reshape(-1, k), overflow


def _exchange_scatter(table_local, idx_local, rows_local, axis, n_shards,
                      rows_per_shard, capacity):
    """Per-device reverse-exchange body (runs under shard_map).

    Routes per-occurrence ``rows_local`` contributions for ``idx_local``
    back to the shard that owns each row and scatter-ADDS them there
    (contributions for one row arriving from several source devices
    accumulate). Dropped/overflow uniques lose their contribution —
    exactly like dropping those examples from the batch — and are
    counted in the returned overflow.
    """
    k = table_local.shape[1]
    local, recv_rows, overflow = _route_contributions(
        idx_local, rows_local, k, axis, n_shards, rows_per_shard, capacity
    )
    table_local = table_local.at[local].add(recv_rows, mode="drop")
    return table_local, overflow.reshape(1).astype(jnp.int32)


def _exchange_rmsprop(table_local, acc_local, idx_local, grads_local, axis,
                      n_shards, rows_per_shard, capacity, lr, decay, eps):
    """Reverse exchange with owner-side sparse RMSProp (one accumulator
    update per globally-touched row on the globally-summed gradient —
    TF IndexedSlices semantics, identical to the GSPMD chunk's planned
    update in ops/sparse_update.py, so explicit-exchange training matches
    the GSPMD path's numerics).

    Note: rows whose summed gradient is all-zero (e.g. every touching
    triplet was capacity-voided upstream) still receive the apply — a
    0.9x accumulator decay with a zero param step. Exact
    dropped-example parity would need a per-row nonzero check on the
    scan's hot path; the divergence is accumulator-only and occurs only
    on overflow batches (see train_step.py explicit-step comment)."""
    from ..ops.sparse_update import apply_planned_rmsprop, planned_rows

    k = table_local.shape[1]
    flat_idx, recv_rows, overflow = _route_contributions(
        idx_local, grads_local, k, axis, n_shards, rows_per_shard, capacity
    )
    # second dedup across SOURCE devices: a row requested by several
    # devices must see ONE RMSProp step on the sum of their gradients
    uniq2, seg2 = _dedup_sorted(flat_idx)
    g2 = (
        jnp.zeros((flat_idx.shape[0], k), grads_local.dtype)
        .at[seg2]
        .add(recv_rows)
    )
    tab_rows, acc_rows = planned_rows(table_local, acc_local, uniq2)
    table_local, acc_local = apply_planned_rmsprop(
        table_local, acc_local, uniq2, tab_rows, acc_rows, g2, lr,
        decay, eps,
    )
    return table_local, acc_local, overflow.reshape(1).astype(jnp.int32)


def sharded_update(
    table,
    idx,
    rows,
    mesh: Mesh,
    axis: str = "mp",
    capacity: int = 0,
):
    """Scatter-add ``rows`` into ``table`` at ``idx`` via explicit
    deduplicated all-to-all exchange — the training-update mirror of
    :func:`sharded_lookup` (SURVEY §2.4 "lookup/update via all-to-all").

    Args:
      table: [n_rows, k] row-sharded (or shardable) over ``axis``.
      idx: int32 [B] target rows (duplicates allowed — contributions sum).
      rows: [B, k] contributions, split over ``axis`` with ``idx``.
      capacity: per-destination slots per device; 0 picks the same
        ``2 * ceil(B_local / n_shards)`` default as the lookup.

    Returns (updated table [n_rows, k], overflow int32[n_shards] —
    uniques whose contribution was dropped, per source device; zero means
    the update is exact).
    """
    n_shards = int(np.prod([
        s for s, n in zip(mesh.devices.shape, mesh.axis_names) if n == axis
    ]))
    n_rows, _ = table.shape
    assert n_rows % n_shards == 0, (n_rows, n_shards)
    b_total = idx.shape[0]
    assert b_total % n_shards == 0, (b_total, n_shards)
    if capacity <= 0:
        capacity = 2 * (-(-(b_total // n_shards) // n_shards))
    rows_per_shard = n_rows // n_shards
    fn = _cached_jit(
        "update", _exchange_scatter, mesh,
        (P(axis, None), P(axis), P(axis, None)), (P(axis, None), P(axis)),
        axis=axis, n_shards=n_shards, rows_per_shard=rows_per_shard,
        capacity=capacity,
    )
    table_d = jax.device_put(table, NamedSharding(mesh, P(axis, None)))
    idx_d = jax.device_put(
        jnp.asarray(idx, jnp.int32), NamedSharding(mesh, P(axis))
    )
    rows_d = jax.device_put(
        jnp.asarray(rows), NamedSharding(mesh, P(axis, None))
    )
    new_table, overflow = fn(table_d, idx_d, rows_d)
    return new_table, overflow
