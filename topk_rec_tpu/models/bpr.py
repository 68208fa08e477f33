"""BPR: pairwise-ranking matrix factorization on the accelerator.

Same model family as the reference's BPR (reference single/bpr.py: score
x_ui = <u_e, i_e> + b_i, pairwise softplus loss with l2/l1 regularization,
RMSProp) but restructured for XLA:

* sampling runs on device (ops/sampling.py) instead of a per-element Python
  rejection loop (reference bpr.py:155-165);
* many SGD steps execute per device launch via ``lax.scan`` instead of one
  ``sess.run`` + feed_dict host->device copy per batch (reference
  bpr.py:141);
* updates are sparse-semantics RMSProp: gradients are scatter-added over
  the batch's rows and only touched rows' accumulators/params move,
  matching TF1's IndexedSlices behavior for embedding lookups
  (decay 0.9, eps 1e-10 inside the sqrt — TF RMSPropOptimizer defaults).

Hyperparameter defaults mirror reference bpr.py:20.
"""

from __future__ import annotations

import time
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.sampling import TripletSampler
from ..utils import tprint
from .base import Recommender


def _pairwise_loss(pu, pit, pjt, lu, li, lj, lb, mode, k, weight=None):
    """BPR batch loss over gathered rows (ref bpr.py:87-99): softplus
    pairwise term + l2/l1 regularization; ``pit``/``pjt`` carry the item
    bias as column ``k``. Shared by the single-chip/GSPMD chunk body and
    the explicit-exchange distributed step (parallel/train_step.py).

    ``weight`` is an optional per-example 0/1 float mask: a zero weight
    removes the example's ENTIRE contribution (pairwise term, regs, and
    hence all its gradients) — the explicit-exchange step uses it to
    void triplets whose forward lookup overflowed, so a dropped row can
    never leak a garbage gradient (computed against zero rows) into the
    surviving real rows."""
    pi, bi = pit[:, :k], pit[:, k]
    pj, bj = pjt[:, :k], pjt[:, k]
    x = bi - bj + jnp.sum(pu * (pi - pj), axis=1)
    per = jnp.logaddexp(0.0, -x)  # = log(1 + exp(-x))
    if mode == "l2":
        reg = 0.5 * (
            jnp.sum(pu**2, axis=1) * lu
            + jnp.sum(pi**2, axis=1) * li
            + jnp.sum(pj**2, axis=1) * lj
        ) + 0.5 * lb * (bi**2 + bj**2)
    else:
        reg = (
            jnp.sum(jnp.abs(pu), axis=1) * lu
            + jnp.sum(jnp.abs(pi), axis=1) * li
            + jnp.sum(jnp.abs(pj), axis=1) * lj
            + lb * (jnp.abs(bi) + jnp.abs(bj))
        )
    tot = per + reg
    if weight is not None:
        tot = tot * weight
    return jnp.sum(tot)


def _chunk_impl(
    params: dict,
    ms: dict,
    key: jax.Array,
    user_rows: jax.Array,
    flat_pos: jax.Array,
    pos_bitmap: jax.Array,
    hyper: dict,
    batch_size: int,
    n_items: int,
    k_candidates: int,
    n_steps: int,
    mode: str,
    constrain_batch=None,
    constrain_table=None,
    fused_tables: bool = False,
    membership: str = "bitmap",
    n_probe_iters: int = 0,
):
    """Run ``n_steps`` sampled BPR/RMSProp steps in one traced program.

    Layout/scheduling choices (none yet measured on H100):

    * the whole chunk's triplets are sampled in one fused call (iid across
      steps, identical in distribution to per-step sampling), keeping the
      rejection-fixup ``while_loop`` out of the scan body;
    * duplicate-row aggregation structure (sort/unique/segment maps) is
      planned for ALL steps in one vmapped pass up front — the scan body
      carries no sorts (ops/sparse_update.plan_sparse_updates);
    * the item bias lives as an extra column of the item table inside the
      chunk, so each step updates two tables, not three. The user and
      item tables stay SEPARATE by default: their update chains are
      independent subgraphs XLA can overlap, while one fused
      [n_users+n_items, k+1] table halves the gather/segment-sum/scatter
      count per step. ``fused_tables=True`` selects that layout — user
      rows first with a zero, gradient-free bias column — and
      ``BPR.train`` auto-picks it for large batches (see
      ``_FUSED_LAYOUT_MIN_BATCH``). Both layouts
      compute identical math (disjoint row ranges, same per-row
      aggregation), asserted by tests/test_models.py.

    ``constrain_batch`` / ``constrain_table`` are optional sharding hooks:
    a mesh caller (parallel/train_step.py) pins the per-step batch arrays
    to the data axis and the embedding tables to the model axis, and the
    SAME body compiles into the sharded step — the distributed path is the
    optimized path by construction, not a parallel re-implementation.
    """
    if constrain_batch is None:
        constrain_batch = lambda x: x
    if constrain_table is None:
        constrain_table = lambda x: x
    lu, li, lj, lb, lr = (
        hyper["lu"],
        hyper["li"],
        hyper["lj"],
        hyper["lb"],
        hyper["lr"],
    )
    k = params["ue"].shape[1]

    from ..ops.sampling import _sample_triplets, _sample_triplets_sorted
    from ..ops.sparse_update import (
        apply_planned_rmsprop,
        plan_sparse_updates,
        planned_rows,
    )

    def loss_fn(pu, pit, pjt):
        return _pairwise_loss(pu, pit, pjt, lu, li, lj, lb, mode, k)

    # pos_bitmap doubles as the membership store: the packed uint32
    # bitmap, or (membership='sorted') the per-user ascending flat
    # positive lists for huge catalogs (ops/sampling.py)
    if membership == "sorted":
        u_all, i_all, j_all = _sample_triplets_sorted(
            key,
            user_rows,
            flat_pos,
            pos_bitmap,
            n_steps * batch_size,
            n_items,
            k_candidates,
            n_probe_iters,
        )
    else:
        u_all, i_all, j_all = _sample_triplets(
            key,
            user_rows,
            flat_pos,
            pos_bitmap,
            n_steps * batch_size,
            n_items,
            k_candidates,
        )
    u_steps = constrain_batch(u_all.reshape(n_steps, batch_size))
    i_steps = constrain_batch(i_all.reshape(n_steps, batch_size))
    j_steps = constrain_batch(j_all.reshape(n_steps, batch_size))

    if fused_tables:
        n_users = params["ue"].shape[0]
        # one [n_users+n_items, k+1] table: user rows first. The user
        # rows' bias column is never read by the forward pass, so its
        # gradient is identically zero and RMSProp keeps it at exactly 0
        # (0.9*acc + 0.1*0 = 0 for a zero-initialized accumulator, and a
        # zero step) — numerics match the separate-table layout.
        all_steps = jnp.concatenate(
            [u_steps, i_steps + n_users, j_steps + n_users], axis=1
        )
        uniq_a, seg_a = plan_sparse_updates(all_steps)
        tbl = jnp.concatenate(
            [
                jnp.concatenate(
                    [params["ue"],
                     jnp.zeros((n_users, 1), params["ue"].dtype)], axis=1
                ),
                jnp.concatenate(
                    [params["ie"], params["ib"][:, None]], axis=1
                ),
            ],
            axis=0,
        )
        mtbl = jnp.concatenate(
            [
                jnp.concatenate(
                    [ms["ue"], jnp.zeros((n_users, 1), ms["ue"].dtype)],
                    axis=1,
                ),
                jnp.concatenate([ms["ie"], ms["ib"][:, None]], axis=1),
            ],
            axis=0,
        )

        def fused_step(carry, xs):
            tbl, mtbl = carry
            uq, sg = xs
            rows, acc = planned_rows(tbl, mtbl, uq)
            b = batch_size
            pu = rows[sg[:b]][:, :k]
            pit = rows[sg[b : 2 * b]]
            pjt = rows[sg[2 * b :]]
            loss, grads = jax.value_and_grad(loss_fn, argnums=(0, 1, 2))(
                pu, pit, pjt
            )
            gu = jnp.concatenate(
                [grads[0], jnp.zeros((b, 1), grads[0].dtype)], axis=1
            )
            g_all = jnp.concatenate([gu, grads[1], grads[2]], axis=0)
            agg = jax.ops.segment_sum(g_all, sg, num_segments=uq.shape[0])
            tbl, mtbl = apply_planned_rmsprop(
                tbl, mtbl, uq, rows, acc, agg, lr
            )
            return (constrain_table(tbl), mtbl), loss

        (tbl, mtbl), losses = jax.lax.scan(
            fused_step, (tbl, mtbl), (uniq_a, seg_a)
        )
        params = {
            "ue": tbl[:n_users, :k],
            "ie": tbl[n_users:, :k],
            "ib": tbl[n_users:, k],
        }
        ms = {
            "ue": mtbl[:n_users, :k],
            "ie": mtbl[n_users:, :k],
            "ib": mtbl[n_users:, k],
        }
        return params, ms, jnp.sum(losses)

    uniq_u, seg_u = plan_sparse_updates(u_steps)
    uniq_ij, seg_ij = plan_sparse_updates(
        jnp.concatenate([i_steps, j_steps], axis=1)
    )
    xs = (u_steps, i_steps, j_steps, uniq_u, seg_u, uniq_ij, seg_ij)

    # bias as column k of the item table: one fused gather/update per side.
    # Tables and their accumulators stay separate arrays.
    iet = jnp.concatenate([params["ie"], params["ib"][:, None]], axis=1)
    mst = jnp.concatenate([ms["ie"], ms["ib"][:, None]], axis=1)

    def step(carry, xs):
        ue, iet, ms_u, ms_it = carry
        u, i, j, uq_u, sg_u, uq_ij, sg_ij = xs
        # one HBM gather per table (unique rows + accumulator rows); the
        # per-occurrence forward rows come from expanding those gathered
        # rows through the segment map — a local batch-sized gather, not a
        # second read of the HBM table.
        rows_u, acc_u = planned_rows(ue, ms_u, uq_u)
        rows_ij, acc_ij = planned_rows(iet, ms_it, uq_ij)
        b = u.shape[0]
        pu = rows_u[sg_u]
        pit = rows_ij[sg_ij[:b]]
        pjt = rows_ij[sg_ij[b:]]
        loss, grads = jax.value_and_grad(loss_fn, argnums=(0, 1, 2))(
            pu, pit, pjt
        )
        g_ij = jnp.concatenate([grads[1], grads[2]], axis=0)
        agg_u = jax.ops.segment_sum(grads[0], sg_u, num_segments=uq_u.shape[0])
        agg_ij = jax.ops.segment_sum(g_ij, sg_ij, num_segments=uq_ij.shape[0])
        ue, ms_u = apply_planned_rmsprop(
            ue, ms_u, uq_u, rows_u, acc_u, agg_u, lr
        )
        iet, ms_it = apply_planned_rmsprop(
            iet, ms_it, uq_ij, rows_ij, acc_ij, agg_ij, lr
        )
        return (constrain_table(ue), constrain_table(iet), ms_u, ms_it), loss

    (ue, iet, ms_u, ms_it), losses = jax.lax.scan(
        step, (params["ue"], iet, ms["ue"], mst), xs
    )
    params = {"ue": ue, "ie": iet[:, :k], "ib": iet[:, k]}
    ms = {"ue": ms_u, "ie": ms_it[:, :k], "ib": ms_it[:, k]}
    return params, ms, jnp.sum(losses)


@partial(
    jax.jit,
    static_argnames=(
        "batch_size",
        "n_items",
        "k_candidates",
        "n_steps",
        "mode",
        "fused_tables",
        "membership",
        "n_probe_iters",
    ),
    donate_argnums=(0, 1),
)
def _train_chunk(
    params: dict,
    ms: dict,
    key: jax.Array,
    user_rows: jax.Array,
    flat_pos: jax.Array,
    pos_bitmap: jax.Array,
    hyper: dict,
    batch_size: int,
    n_items: int,
    k_candidates: int,
    n_steps: int,
    mode: str,
    fused_tables: bool = False,
    membership: str = "bitmap",
    n_probe_iters: int = 0,
):
    """Single-device compiled chunk (see ``_chunk_impl``)."""
    return _chunk_impl(
        params, ms, key, user_rows, flat_pos, pos_bitmap, hyper,
        batch_size, n_items, k_candidates, n_steps, mode,
        fused_tables=fused_tables, membership=membership,
        n_probe_iters=n_probe_iters,
    )


# Batch size at or above which BPR.train's "auto" layout switches to the
# fused [n_users+n_items, k+1] table: small batches are latency-bound
# (the two independent update chains overlap), large ones move fewer
# bytes with half the gather/scatter count. Not yet measured on H100
# (ROADMAP D4).
_FUSED_LAYOUT_MIN_BATCH = 2048

# ... but only while the fused table stays small: _chunk_impl rebuilds
# the [n_users+n_items, k+1] concat every chunk call, and at 1M users
# that is a ~450 MB copy per chunk. Not yet measured on H100.
_FUSED_LAYOUT_MAX_ROWS = 262_144


class BPR(Recommender):
    """Bayesian Personalized Ranking with device-side sampling.

    Defaults mirror reference single/bpr.py:20: k, lambda_u=2.5e-3,
    lambda_i=2.5e-3, lambda_j=2.5e-4, lambda_b=0, lr=1e-4, mode in
    {'l2','l1'}.
    """

    def __init__(
        self,
        k: int,
        lambda_u: float = 2.5e-3,
        lambda_i: float = 2.5e-3,
        lambda_j: float = 2.5e-4,
        lambda_b: float = 0.0,
        lr: float = 1.0e-4,
        mode: str = "l2",
        seed: int = 0,
        k_candidates: int = 2,
        table_layout: str = "auto",
        membership: str = "auto",
    ):
        super().__init__(k)
        self.lu = lambda_u
        self.li = lambda_i
        self.lj = lambda_j
        self.lb = lambda_b
        self.lr = lr
        self.mode = mode
        self.seed = seed
        self.k_candidates = k_candidates
        if table_layout not in ("auto", "separate", "fused"):
            raise ValueError(
                f"table_layout must be auto|separate|fused, got {table_layout!r}"
            )
        # 'auto' picks by batch size and table rows (see
        # _FUSED_LAYOUT_MIN_BATCH); 'separate'/'fused' pin it.
        self.table_layout = table_layout
        # membership: 'auto'|'bitmap'|'sorted' negative-probe store
        # (ops/sampling.py TripletSampler — sorted-CSR keeps huge
        # catalogs off the dense bitmap footprint)
        self.membership = membership
        self.sampler: Optional[TripletSampler] = None
        self._params = None
        self._ms = None

    def _on_data_loaded(self) -> None:
        self.sampler = TripletSampler(
            self.inter, self.k_candidates, membership=self.membership
        )

    # ---- parameter init / sync ----

    def _init_params(self, key: jax.Array) -> None:
        """N(0, 0.01) embedding init, zero biases (ref bpr.py:77-79),
        honoring any warm-start embeddings already loaded (ref
        bpr.py:120-135)."""
        k1, k2 = jax.random.split(key)
        ue = (
            jnp.asarray(self.fue)
            if self.fue is not None
            else 0.01 * jax.random.normal(k1, (self.n_users, self.k))
        )
        ie = (
            jnp.asarray(self.fie)
            if self.fie is not None
            else 0.01 * jax.random.normal(k2, (self.n_items, self.k))
        )
        ib = (
            jnp.asarray(self.fib).reshape(-1)
            if self.fib is not None
            else jnp.zeros(self.n_items)
        )
        self._params = {
            "ue": ue.astype(jnp.float32),
            "ie": ie.astype(jnp.float32),
            "ib": ib.astype(jnp.float32),
        }
        self._ms = jax.tree.map(jnp.zeros_like, self._params)

    def _sync_host(self) -> None:
        self.fue = np.asarray(self._params["ue"])
        self.fie = np.asarray(self._params["ie"])
        self.fib = np.asarray(self._params["ib"]).reshape(-1, 1)

    # ---- training ----

    def train(
        self,
        epochs: int = 5,
        batch_size: int = 256,
        epoch_sample_limit: Optional[int] = None,
        model_path: Optional[str] = None,
        scan_steps: int = 128,
        verbose: bool = True,
        ckpt_dir: Optional[str] = None,
        ckpt_every: int = 1,
    ) -> None:
        """Reference-parity training loop (reference bpr.py:103-153).

        ``epoch_sample_limit`` defaults to the number of positive pairs;
        each epoch runs ``epoch_sample_limit // batch_size + 1`` batches
        (ref bpr.py:113). ``scan_steps`` batches execute per device launch.

        ``ckpt_dir`` enables epoch-level fault tolerance via
        CheckpointManager (save-lag GC'd native checkpoints of params +
        optimizer state, saved every ``ckpt_every`` epochs): a restarted
        train() resumes from the latest checkpointed epoch with the
        identical sampling stream (per-epoch keys are fold_in-derived,
        not chained), so crash-resume reproduces the uninterrupted run.
        The analog of the reference solver's save-lag + resume
        (old/cr/cr.cpp:118-122,284-295).
        """
        assert self.inter is not None, "no training data loaded"
        if epoch_sample_limit is None:
            epoch_sample_limit = self.inter.nnz
        batch_limit = int(epoch_sample_limit) // batch_size + 1
        if model_path is not None:
            tprint("Initialize weights with the previous trained model")
            self.import_embeddings(model_path)
        base_key = jax.random.PRNGKey(self.seed)
        self._init_params(jax.random.fold_in(base_key, 2**31 - 1))
        start_epoch = 0
        mgr = None
        if ckpt_dir is not None:
            from ..checkpoint import CheckpointManager

            mgr = CheckpointManager(ckpt_dir, save_every=ckpt_every)
            latest = mgr.latest_step()
            if latest is not None:
                state = mgr.restore(
                    latest, like={"params": self._params, "ms": self._ms}
                )
                self._params = state["params"]
                self._ms = state["ms"]
                start_epoch = latest
                if verbose:
                    tprint(f"Resuming from checkpointed epoch {latest}")
        if verbose:
            tprint(
                "Training parameters: lu=%.6f, li=%.6f, lj=%.6f, lb=%.6f"
                % (self.lu, self.li, self.lj, self.lb)
            )
            tprint(
                "Learning rate is %.6f, regularization mode is %s"
                % (self.lr, self.mode)
            )
            tprint(
                "Training for %d epochs of %d batches (batch %d, %d per launch)"
                % (epochs, batch_limit, batch_size, scan_steps)
            )
        hyper = {
            "lu": self.lu,
            "li": self.li,
            "lj": self.lj,
            "lb": self.lb,
            "lr": self.lr,
        }
        s = self.sampler
        # Always launch whole scan_steps-sized chunks: every distinct
        # n_steps is a separate compiled program, and a remainder chunk
        # costs a full (slow) recompile for a few batches of work. The
        # epoch therefore runs ceil(batch_limit/scan_steps)*scan_steps
        # batches (the reference's batch_limit already has a +1 fudge,
        # bpr.py:113).
        n_chunks = max(1, -(-batch_limit // scan_steps))
        fused_tables = self.table_layout == "fused" or (
            self.table_layout == "auto"
            and batch_size >= _FUSED_LAYOUT_MIN_BATCH
            and self.n_users + self.n_items <= _FUSED_LAYOUT_MAX_ROWS
        )
        for eid in range(start_epoch, epochs):
            t0 = time.time()
            chunk_losses = []
            # per-epoch key derivation (not a chained split): a resumed
            # run samples the same stream as the uninterrupted one
            key = jax.random.fold_in(base_key, eid)
            for _ in range(n_chunks):
                n_steps = scan_steps
                key, sub = jax.random.split(key)
                self._params, self._ms, loss = _train_chunk(
                    self._params,
                    self._ms,
                    sub,
                    s.user_rows,
                    s.flat_pos,
                    s.pos_bitmap
                    if s.membership == "bitmap"
                    else s.flat_sorted,
                    hyper,
                    batch_size,
                    self.n_items,
                    self.k_candidates,
                    n_steps,
                    self.mode,
                    fused_tables,
                    membership=s.membership,
                    n_probe_iters=getattr(s, "n_probe_iters", 0),
                )
                # keep the loss on device: a host sync per chunk would
                # stall the dispatch of the next chunk
                chunk_losses.append(loss)
            total_loss = float(jnp.sum(jnp.stack(chunk_losses)))
            if verbose:
                tprint(
                    "Epoch %3d, loss %.4f, time %.3fs"
                    % (eid + 1, total_loss, time.time() - t0)
                )
            if mgr is not None:
                mgr.save(eid + 1, {"params": self._params, "ms": self._ms})
        self._sync_host()

    # ---- native checkpoint ----

    def _native_state(self):
        if self._ms is None:
            return {}
        return {
            "ms_ue": np.asarray(self._ms["ue"]),
            "ms_ie": np.asarray(self._ms["ie"]),
            "ms_ib": np.asarray(self._ms["ib"]),
        }

    def _load_native_state(self, state) -> None:
        if "ms_ue" in state:
            self._ms = {
                "ue": jnp.asarray(state["ms_ue"]),
                "ie": jnp.asarray(state["ms_ie"]),
                "ib": jnp.asarray(state["ms_ib"]),
            }
