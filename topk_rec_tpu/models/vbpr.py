"""VBPR: content-aware pairwise ranking (visual/meta BPR).

Same model as the reference's VBPR (reference single/vbpr.py): the latent
dimension splits into k/2 rating factors + k/2 content factors; items
contribute a learned projection of their content features
(iceb = F[i]·cem) and a content bias (F[i]·icb); the pairwise objective and
l2/l1 regularization mirror vbpr.py:59-75.

The device structure matches our BPR (device sampling, lax.scan over many
steps per launch, sparse-masked RMSProp for the embedding tables) with two
dense parameters (cem ∈ R^{d×k/2}, icb ∈ R^d) updated with dense RMSProp —
the reference feeds raw [batch, d] feature rows through feed_dict each step
(vbpr.py:114, a host->device copy); here the full feature matrix is device
resident and rows are gathered in-kernel.

Export composes full-catalog embeddings so cold-start (out-of-matrix)
evaluation works through the generic .dat contract (ref vbpr.py:124-126):
  final-U = [ure ‖ uce], final-V = [ire ‖ F·cem], final-B = irb + F·icb.
"""

from __future__ import annotations

import time
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.sampling import (
    TripletSampler,
    _sample_triplets,
    _sample_triplets_sorted,
)
from ..utils import tprint
from .base import Recommender


def _chunk_impl(
    params: dict,
    ms: dict,
    key: jax.Array,
    feat: jax.Array,  # [n_items, d]
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
    membership: str = "bitmap",
    n_probe_iters: int = 0,
):
    """VBPR chunk body; sharding hooks as in models/bpr.py ``_chunk_impl``
    (the distributed trainer compiles this same body over a mesh)."""
    if constrain_batch is None:
        constrain_batch = lambda x: x
    if constrain_table is None:
        constrain_table = lambda x: x
    lu, li, lj, lb, le, lr = (
        hyper["lu"],
        hyper["li"],
        hyper["lj"],
        hyper["lb"],
        hyper["le"],
        hyper["lr"],
    )

    def loss_fn(g, cem, icb, ic, jc):
        ureb, uceb, ireb, jreb, irbb, jrbb = g
        iceb = jnp.dot(ic, cem, preferred_element_type=jnp.float32)
        jceb = jnp.dot(jc, cem, preferred_element_type=jnp.float32)
        x = (
            irbb
            - jrbb
            + jnp.sum(ureb * (ireb - jreb), axis=1)
            + jnp.sum(uceb * (iceb - jceb), axis=1)
            + jnp.dot(ic - jc, icb, preferred_element_type=jnp.float32)
        )
        nll = jnp.sum(jnp.logaddexp(0.0, -x))
        if mode == "l2":
            reg = (
                0.5 * jnp.sum(cem**2) * le
                + 0.5
                * jnp.sum((ureb**2 + uceb**2) * lu + ireb**2 * li + jreb**2 * lj)
                + 0.5 * (jnp.sum(irbb**2 + jrbb**2) + jnp.sum(icb**2)) * lb
            )
        else:
            reg = (
                jnp.sum(jnp.abs(cem)) * le
                + jnp.sum(
                    (jnp.abs(ureb) + jnp.abs(uceb)) * lu
                    + jnp.abs(ireb) * li
                    + jnp.abs(jreb) * lj
                )
                + (jnp.sum(jnp.abs(irbb) + jnp.abs(jrbb)) + jnp.sum(jnp.abs(icb)))
                * lb
            )
        return nll + reg

    from ..ops.sparse_update import (
        apply_planned_rmsprop,
        plan_sparse_updates,
        planned_rows,
    )

    def rms_dense(p, m, g):
        m_new = 0.9 * m + 0.1 * g * g
        return p - lr * g / jnp.sqrt(m_new + 1e-10), m_new

    # whole-chunk sampling + chunk-planned sparse updates (see models/bpr.py)
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
    uniq_u, seg_u = plan_sparse_updates(u_steps)
    uniq_ij, seg_ij = plan_sparse_updates(
        jnp.concatenate([i_steps, j_steps], axis=1)
    )
    xs = (u_steps, i_steps, j_steps, uniq_u, seg_u, uniq_ij, seg_ij)

    # fused row layouts: user table [ure | uce] (both k/2), item table
    # [ire | irb] — one gather + one planned update per side per step
    kh = params["ure"].shape[1]
    ut = jnp.concatenate([params["ure"], params["uce"]], axis=1)
    ut_m = jnp.concatenate([ms["ure"], ms["uce"]], axis=1)
    it = jnp.concatenate([params["ire"], params["irb"][:, None]], axis=1)
    it_m = jnp.concatenate([ms["ire"], ms["irb"][:, None]], axis=1)

    def step(carry, xs):
        ut, it, cem, icb, ut_m, it_m, m_cem, m_icb = carry
        u, i, j, uq_u, sg_u, uq_ij, sg_ij = xs
        ic = feat[i]
        jc = feat[j]
        # single HBM gather per table at unique rows; forward rows are the
        # local expansion through the segment map (see models/bpr.py)
        rows_u, acc_u = planned_rows(ut, ut_m, uq_u)
        rows_ij, acc_ij = planned_rows(it, it_m, uq_ij)
        b = u.shape[0]
        put = rows_u[sg_u]
        pit = rows_ij[sg_ij[:b]]
        pjt = rows_ij[sg_ij[b:]]
        gathered = (
            put[:, :kh],
            put[:, kh:],
            pit[:, :kh],
            pjt[:, :kh],
            pit[:, kh],
            pjt[:, kh],
        )
        loss, grads = jax.value_and_grad(loss_fn, argnums=(0, 1, 2))(
            gathered, cem, icb, ic, jc
        )
        g_emb, g_cem, g_icb = grads
        g_u = jnp.concatenate([g_emb[0], g_emb[1]], axis=1)
        g_it = jnp.concatenate(
            [
                jnp.concatenate([g_emb[2], g_emb[4][:, None]], axis=1),
                jnp.concatenate([g_emb[3], g_emb[5][:, None]], axis=1),
            ],
            axis=0,
        )
        agg_u = jax.ops.segment_sum(g_u, sg_u, num_segments=uq_u.shape[0])
        agg_ij = jax.ops.segment_sum(g_it, sg_ij, num_segments=uq_ij.shape[0])
        ut, ut_m = apply_planned_rmsprop(
            ut, ut_m, uq_u, rows_u, acc_u, agg_u, lr
        )
        it, it_m = apply_planned_rmsprop(
            it, it_m, uq_ij, rows_ij, acc_ij, agg_ij, lr
        )
        cem, m_cem = rms_dense(cem, m_cem, g_cem)
        icb, m_icb = rms_dense(icb, m_icb, g_icb)
        return (
            constrain_table(ut), constrain_table(it), cem, icb,
            ut_m, it_m, m_cem, m_icb,
        ), loss

    carry = (
        ut, it, params["cem"], params["icb"], ut_m, it_m,
        ms["cem"], ms["icb"],
    )
    (ut, it, cem, icb, ut_m, it_m, m_cem, m_icb), losses = jax.lax.scan(
        step, carry, xs
    )
    params = {
        "ure": ut[:, :kh],
        "uce": ut[:, kh:],
        "ire": it[:, :kh],
        "irb": it[:, kh],
        "cem": cem,
        "icb": icb,
    }
    ms = {
        "ure": ut_m[:, :kh],
        "uce": ut_m[:, kh:],
        "ire": it_m[:, :kh],
        "irb": it_m[:, kh],
        "cem": m_cem,
        "icb": m_icb,
    }
    return params, ms, jnp.sum(losses)


@partial(
    jax.jit,
    static_argnames=(
        "batch_size", "n_items", "k_candidates", "n_steps", "mode",
        "membership", "n_probe_iters",
    ),
    donate_argnums=(0, 1),
)
def _train_chunk(
    params: dict,
    ms: dict,
    key: jax.Array,
    feat: jax.Array,
    user_rows: jax.Array,
    flat_pos: jax.Array,
    pos_bitmap: jax.Array,
    hyper: dict,
    batch_size: int,
    n_items: int,
    k_candidates: int,
    n_steps: int,
    mode: str,
    membership: str = "bitmap",
    n_probe_iters: int = 0,
):
    """Single-device compiled chunk (see ``_chunk_impl``)."""
    return _chunk_impl(
        params, ms, key, feat, user_rows, flat_pos, pos_bitmap, hyper,
        batch_size, n_items, k_candidates, n_steps, mode,
        membership=membership, n_probe_iters=n_probe_iters,
    )


class VBPR(Recommender):
    """Content-aware BPR with split rating/content factors.

    Defaults mirror reference vbpr.py:18 (lambda_e=0 included).
    """

    def __init__(
        self,
        k: int,
        d: int,
        lambda_u: float = 2.5e-3,
        lambda_i: float = 2.5e-3,
        lambda_j: float = 2.5e-4,
        lambda_b: float = 0.0,
        lambda_e: float = 0.0,
        lr: float = 1.0e-4,
        mode: str = "l2",
        seed: int = 0,
        k_candidates: int = 2,
        full_k: bool = False,
        membership: str = "auto",
    ):
        super().__init__(k)
        self.d = d
        # full_k=True reproduces the legacy Theano VBPR's factor layout
        # (reference old/methods/vbpr.py:37-43: k-wide rating factors W/H
        # plus a separate k-wide user-content factor P and E[k x d]), vs
        # the current generation's split k/2 + k/2 (reference
        # single/vbpr.py:37-48). The objective is identical; only the
        # factor widths differ, so one parameter covers both generations.
        self.full_k = full_k
        self.lu = lambda_u
        self.li = lambda_i
        self.lj = lambda_j
        self.lb = lambda_b
        self.le = lambda_e
        self.lr = lr
        self.mode = mode
        self.seed = seed
        self.k_candidates = k_candidates
        self.membership = membership
        self.sampler: Optional[TripletSampler] = None
        self._params = None
        self._ms = None

    def _on_data_loaded(self) -> None:
        self.sampler = TripletSampler(
            self.inter, self.k_candidates, membership=self.membership
        )

    def set_features(self, feat) -> None:
        super().set_features(feat)
        self._feat_dev = None  # invalidate device cache

    def _feat_device(self):
        if getattr(self, "_feat_dev", None) is None:
            self._feat_dev = jnp.asarray(self.feat)
        return self._feat_dev

    def _init_params(self, key: jax.Array) -> None:
        """N(0,0.01) embeddings, zero biases, cem const 2/(d·k)
        (ref vbpr.py:37-48), honoring warm-start splits
        (ref vbpr.py:99-108: fue halves -> ure/uce, fie[:, :k/2] -> ire,
        fib -> irb)."""
        kh = self.k if self.full_k else self.k // 2
        ks = jax.random.split(key, 3)
        if self.fue is not None:
            ure = jnp.asarray(self.fue[:, :kh])
            uce = jnp.asarray(self.fue[:, kh : 2 * kh])
        else:
            ure = 0.01 * jax.random.normal(ks[0], (self.n_users, kh))
            uce = 0.01 * jax.random.normal(ks[1], (self.n_users, kh))
        if self.fie is not None:
            ire = jnp.asarray(self.fie[:, :kh])
        else:
            ire = 0.01 * jax.random.normal(ks[2], (self.n_items, kh))
        if self.fib is not None:
            irb = jnp.asarray(self.fib).reshape(-1)
        else:
            irb = jnp.zeros(self.n_items)
        base = {
            "ure": ure.astype(jnp.float32),
            "uce": uce.astype(jnp.float32),
            "ire": ire.astype(jnp.float32),
            "irb": irb.astype(jnp.float32),
            "cem": jnp.full((self.d, kh), 2.0 / (self.d * self.k), jnp.float32),
            "icb": jnp.zeros(self.d, jnp.float32),
        }
        if self._pending_state is not None:
            # exact resume of dense params/accumulators from checkpoint.npz
            # (the .dat-only path re-imports final-B as irb, which is lossy —
            # the reference shares that asymmetry, vbpr.py:108; the native
            # checkpoint's raw irb restores exactly)
            st = self._pending_state
            for name in ("cem", "icb", "irb"):
                if name in st:
                    base[name] = jnp.asarray(st[name])
            self._params = base
            self._ms = {
                name: jnp.asarray(st[f"ms_{name}"])
                if f"ms_{name}" in st
                else jnp.zeros_like(val)
                for name, val in base.items()
            }
            self._pending_state = None
        else:
            self._params = base
            self._ms = jax.tree.map(jnp.zeros_like, base)

    _pending_state = None

    def train(
        self,
        epochs: int = 5,
        batch_size: int = 256,
        epoch_sample_limit: Optional[int] = None,
        model_path: Optional[str] = None,
        scan_steps: int = 64,
        verbose: bool = True,
        ckpt_dir: Optional[str] = None,
        ckpt_every: int = 1,
    ) -> None:
        """``ckpt_dir``/``ckpt_every``: epoch-level crash-resume through
        CheckpointManager with fold_in-derived per-epoch keys — identical
        semantics to models/bpr.py BPR.train."""
        assert self.inter is not None and self.feat is not None
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
        feat_dev = self._feat_device()
        hyper = {
            "lu": self.lu,
            "li": self.li,
            "lj": self.lj,
            "lb": self.lb,
            "le": self.le,
            "lr": self.lr,
        }
        if verbose:
            tprint(
                "Training parameters: lu=%.6f, li=%.6f, lj=%.6f, lb=%.6f, le=%.6f"
                % (self.lu, self.li, self.lj, self.lb, self.le)
            )
            tprint(
                "Training for %d epochs of %d batches (batch %d)"
                % (epochs, batch_limit, batch_size)
            )
        s = self.sampler
        # whole chunks only — remainder shapes would recompile (see bpr.py)
        n_chunks = max(1, -(-batch_limit // scan_steps))
        for eid in range(start_epoch, epochs):
            t0 = time.time()
            chunk_losses = []
            key = jax.random.fold_in(base_key, eid)
            for _ in range(n_chunks):
                n_steps = scan_steps
                key, sub = jax.random.split(key)
                self._params, self._ms, loss = _train_chunk(
                    self._params,
                    self._ms,
                    sub,
                    feat_dev,
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
                    membership=s.membership,
                    n_probe_iters=getattr(s, "n_probe_iters", 0),
                )
                chunk_losses.append(loss)  # defer sync (see models/bpr.py)
            total_loss = float(jnp.sum(jnp.stack(chunk_losses)))
            if verbose:
                tprint(
                    "Epoch %3d, loss %.4f, time %.3fs"
                    % (eid + 1, total_loss, time.time() - t0)
                )
            if mgr is not None:
                mgr.save(eid + 1, {"params": self._params, "ms": self._ms})
        self._sync_host()

    def _sync_host(self) -> None:
        """Compose full-catalog export embeddings (ref vbpr.py:124-126)."""
        p = {k: np.asarray(v) for k, v in self._params.items()}
        content_emb = self.feat @ p["cem"]
        content_bias = self.feat @ p["icb"]
        self.fue = np.concatenate([p["ure"], p["uce"]], axis=1)
        self.fie = np.concatenate([p["ire"], content_emb], axis=1)
        self.fib = (p["irb"] + content_bias).reshape(-1, 1)

    # ---- native checkpoint: dense params + accumulators ----

    def _native_state(self):
        if self._params is None:
            return {}
        state = {
            "cem": np.asarray(self._params["cem"]),
            "icb": np.asarray(self._params["icb"]),
            "irb": np.asarray(self._params["irb"]),
        }
        for name, val in self._ms.items():
            state[f"ms_{name}"] = np.asarray(val)
        return state

    def _load_native_state(self, state) -> None:
        self._pending_state = state
