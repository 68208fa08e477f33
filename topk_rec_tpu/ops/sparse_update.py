"""Sparse row-wise RMSProp: aggregate duplicate rows, update only touched rows.

The straightforward XLA formulation of an embedding-table update
(scatter-add into a dense zero gradient table, then a masked elementwise
update) moves O(n_rows·k) bytes per step even when the batch touches only
a few hundred rows. This helper keeps everything in O(batch·k):

  1. sort the row indices (tiny batch-sized sort),
  2. segment-sum gradients over duplicate runs and broadcast the aggregate
     back to every duplicate position,
  3. compute the RMSProp update from the *original* accumulator row — all
     duplicates of a row produce the identical new value,
  4. scatter with ``.set`` (duplicate writes carry equal values, so the
     result is deterministic regardless of write order).

Matches TF1's IndexedSlices RMSProp semantics (aggregate grads, one
accumulator update per touched row — decay 0.9, eps 1e-10 in the sqrt),
which is what the reference's ``embedding_lookup`` training used
(reference single/bpr.py:81-100).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def plan_sparse_updates(idx_all: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Precompute duplicate-aggregation structure for a chunk of steps.

    The sort/unique work of a sparse update depends only on the row
    *indices*, which for a whole chunk of SGD steps are known the moment
    the chunk's batches are sampled. Doing it per step inside a
    ``lax.scan`` serializes S tiny sorts; doing it here vmaps them into
    one batched pass so the scan body is left with only segment-sums,
    gathers and scatters.

    Args:
      idx_all: int32 ``[S, M]`` row indices per step (duplicates allowed).

    Returns:
      ``(uniq, seg)`` where ``uniq`` is int32 ``[S, M]`` — the distinct
      rows touched at each step, padded with an out-of-bounds sentinel
      (``max(idx)+M`` is NOT used; padding is ``2**31 - 1``, which JAX
      gathers clamp and scatters in ``mode='drop'`` discard) — and
      ``seg`` is int32 ``[S, M]`` mapping each batch position to its row's
      slot in ``uniq``.
    """
    oob = jnp.int32(2**31 - 1)

    def per_step(idx):
        m = idx.shape[0]
        order = jnp.argsort(idx)
        sidx = idx[order]
        first = jnp.concatenate(
            [jnp.ones((1,), bool), sidx[1:] != sidx[:-1]]
        )
        seg_sorted = (jnp.cumsum(first) - 1).astype(jnp.int32)
        # segment slot for each original batch position
        seg = jnp.zeros((m,), jnp.int32).at[order].set(seg_sorted)
        # representative row per slot (duplicate writes carry equal values)
        uniq = jnp.full((m,), oob, jnp.int32).at[seg_sorted].set(sidx)
        return uniq, seg

    return jax.vmap(per_step)(idx_all)


def planned_rows(
    table: jax.Array,   # [n_rows, k]
    acc: jax.Array,     # same shape — second-moment accumulator
    uniq: jax.Array,    # int32 [M] distinct rows, OOB-padded (one plan step)
) -> Tuple[jax.Array, jax.Array]:
    """Gather the planned unique rows of (table, accumulator) — once.

    The forward pass needs per-occurrence parameter rows and the update
    needs per-unique-row parameter/accumulator rows. Gathering occurrences
    and uniques separately reads the HBM table twice per step; instead,
    gather only the unique rows here and expand to occurrences locally
    (``rows[seg]`` — a gather from a batch-sized array, not from the
    full table in device memory).
    """
    return (
        table.at[uniq].get(mode="fill", fill_value=0.0),
        acc.at[uniq].get(mode="fill", fill_value=0.0),
    )


def apply_planned_rmsprop(
    table: jax.Array,     # [n_rows, k]
    acc: jax.Array,       # same shape
    uniq: jax.Array,      # int32 [M] distinct rows, OOB-padded
    tab_rows: jax.Array,  # [M, k] rows gathered by planned_rows
    acc_rows: jax.Array,  # [M, k]
    agg: jax.Array,       # [M, k] aggregated (segment-summed) gradients
    lr: float,
    decay: float = 0.9,
    eps: float = 1e-10,
) -> Tuple[jax.Array, jax.Array]:
    """RMSProp update of the planned rows from pre-gathered values.

    Together with :func:`planned_rows` this is :func:`planned_rmsprop`
    split so the unique-row gather is shared with the forward pass.
    """
    acc_new = decay * acc_rows + (1.0 - decay) * agg * agg
    upd = tab_rows - lr * agg / jnp.sqrt(acc_new + eps)
    table = table.at[uniq].set(upd, mode="drop")
    acc = acc.at[uniq].set(acc_new, mode="drop")
    return table, acc


def planned_rmsprop(
    table: jax.Array,   # [n_rows, k] (or [n_rows] for biases)
    acc: jax.Array,     # same shape — second-moment accumulator
    uniq: jax.Array,    # int32 [M] distinct rows, OOB-padded (one plan step)
    seg: jax.Array,     # int32 [M] batch position -> slot in uniq
    grads: jax.Array,   # [M, k] (or [M]) per-occurrence gradients
    lr: float,
    decay: float = 0.9,
    eps: float = 1e-10,
) -> Tuple[jax.Array, jax.Array]:
    """One sparse RMSProp step using a precomputed plan (see above).

    Semantics are identical to :func:`sparse_rmsprop` — aggregate
    duplicate rows' gradients, advance each touched row's accumulator
    once — but with no sort in the step itself.
    """
    squeeze = table.ndim == 1
    if squeeze:
        table = table[:, None]
        acc = acc[:, None]
        grads = grads[:, None]
    m = uniq.shape[0]
    agg = jax.ops.segment_sum(grads, seg, num_segments=m)
    acc_rows = acc.at[uniq].get(mode="fill", fill_value=0.0)
    tab_rows = table.at[uniq].get(mode="fill", fill_value=0.0)
    acc_new = decay * acc_rows + (1.0 - decay) * agg * agg
    upd = tab_rows - lr * agg / jnp.sqrt(acc_new + eps)
    table = table.at[uniq].set(upd, mode="drop")
    acc = acc.at[uniq].set(acc_new, mode="drop")
    if squeeze:
        table = table[:, 0]
        acc = acc[:, 0]
    return table, acc


def sparse_rmsprop(
    table: jax.Array,   # [n_rows, k] (or [n_rows] for biases)
    acc: jax.Array,     # same shape — second-moment accumulator
    idx: jax.Array,     # int32 [M] touched rows (duplicates allowed)
    grads: jax.Array,   # [M, k] (or [M]) per-occurrence gradients
    lr: float,
    decay: float = 0.9,
    eps: float = 1e-10,
) -> Tuple[jax.Array, jax.Array]:
    """One sparse RMSProp step; returns (new_table, new_acc)."""
    squeeze = table.ndim == 1
    if squeeze:
        table = table[:, None]
        acc = acc[:, None]
        grads = grads[:, None]
    m = idx.shape[0]
    order = jnp.argsort(idx)
    sidx = idx[order]
    sgrads = grads[order]
    first = jnp.concatenate(
        [jnp.ones((1,), bool), sidx[1:] != sidx[:-1]]
    )
    seg = jnp.cumsum(first) - 1                     # [M] segment id
    agg = jax.ops.segment_sum(sgrads, seg, num_segments=m)
    g = agg[seg]                                    # aggregate per duplicate
    acc_rows = acc[sidx]
    acc_new = decay * acc_rows + (1.0 - decay) * g * g
    upd = table[sidx] - lr * g / jnp.sqrt(acc_new + eps)
    table = table.at[sidx].set(upd)
    acc = acc.at[sidx].set(acc_new)
    if squeeze:
        table = table[:, 0]
        acc = acc[:, 0]
    return table, acc
