"""WMF: weighted implicit-feedback matrix factorization via batched ALS.

Same objective as the reference's WMF (reference single/wmf.py:61-101):
confidence-weighted squared loss with positive weight ``a`` and background
weight ``b``, L2 priors lu/lv, solved by alternating least squares. The
reference's per-entity host solves become blocked matmuls + batched
k×k solves (ops/als.py).

Note: the reference's plain ``WMF.train`` crashes as written (it calls
``.keys()/.values()`` on list-valued dicts, wmf.py:75-76 — see SURVEY.md
§2.1 C4); this implements the *intended* semantics, which its subclasses
CER/DPM actually run (all ratings are 1 after the like==1 filter).
Defaults mirror reference wmf.py:11: lu=0.01, lv=0.01, a=1, b=0.01.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import jax.numpy as jnp
import numpy as np

from ..ops.als import ALSPlan, half_sweep
from ..utils import tprint
from .base import Recommender


class WMF(Recommender):
    def __init__(
        self,
        k: int,
        lu: float = 0.01,
        lv: float = 0.01,
        a: float = 1.0,
        b: float = 0.01,
        seed: int = 0,
        block_size: int = 2048,
        mesh=None,
    ):
        super().__init__(k)
        self.lu = lu
        self.lv = lv
        self.a = a
        self.b = b
        self.seed = seed
        self.block_size = block_size
        self._user_plan: Optional[ALSPlan] = None
        self._item_plan: Optional[ALSPlan] = None
        self._half_sweep = half_sweep
        self.mesh = None
        if mesh is not None:
            self.set_mesh(mesh)

    def set_mesh(self, mesh) -> None:
        """Route every ALS half-sweep through the mesh-sharded fused sweep
        (parallel/als.py) — entity rows split across all mesh devices. The
        whole model family (WMF/CER/DPM) inherits this dispatch."""
        from ..parallel.als import DistributedALS

        self.mesh = mesh
        self._half_sweep = DistributedALS(mesh).half_sweep

    def _on_data_loaded(self) -> None:
        inter = self.inter
        u_indptr, u_flat = inter.user_csr
        i_indptr, i_flat = inter.item_csr
        self._user_plan = ALSPlan(
            u_indptr, u_flat, inter.n_users, self.block_size
        )
        self._item_plan = ALSPlan(
            i_indptr, i_flat, inter.n_items, self.block_size
        )
        # uniform [0,1) init (ref wmf.py:55-56)
        rng = np.random.default_rng(self.seed)
        self.fue = rng.random((inter.n_users, self.k), dtype=np.float32)
        self.fie = rng.random((inter.n_items, self.k), dtype=np.float32)
        self._rated_dev_cache = None  # new fold: re-upload rated lists

    def _rated_dev(self):
        """Cached device copies of the rated-entity index lists (uploaded
        once per fold instead of once per iteration)."""
        if getattr(self, "_rated_dev_cache", None) is None:
            inter = self.inter
            self._rated_dev_cache = (
                jnp.asarray(inter.rated_items),
                jnp.asarray(inter.rated_users),
            )
        return self._rated_dev_cache

    def _sweeps(self, prior: Optional[np.ndarray], as_numpy: bool = True):
        """One full ALS iteration (users then items); returns item fit loss.

        ``as_numpy=False`` leaves ``self.fue``/``self.fie`` as device
        arrays and returns the fit as a device scalar — the train loop
        uses this to keep the whole ALS alternation device-resident
        (per-sweep host round trips of the user table cost more than the
        sweep's device work; see ops/als.half_sweep)."""
        rated_items, rated_users = self._rated_dev()
        self.fue, _ = self._half_sweep(
            self._user_plan,
            self.fue,
            self.fie,
            rated_items,
            self.a,
            self.b,
            self.lu,
            as_numpy=as_numpy,
        )
        self.fie, fit = self._half_sweep(
            self._item_plan,
            self.fie,
            self.fue,
            rated_users,
            self.a,
            self.b,
            self.lv,
            prior=prior,
            as_numpy=as_numpy,
        )
        return fit

    def _save_lag_dump(self, save_dir: str, it: int) -> None:
        """Numbered intermediate checkpoints, reference cr format
        (``%04d-U.dat`` / ``%04d-V.dat``, old/cr/cr.cpp:284-295)."""
        from ..data.io import write_dat

        os.makedirs(save_dir, exist_ok=True)
        write_dat(os.path.join(save_dir, "%04d-U.dat" % it), self.fue)
        write_dat(os.path.join(save_dir, "%04d-V.dat" % it), self.fie)

    def _loss_reg(self, theta: Optional[np.ndarray] = None) -> float:
        """0.5·lu·‖U‖² + 0.5·lv·‖V‖² (ref wmf.py:81,97).

        With a content prior the item term becomes the cr solver's
        prior-distance 0.5·lv·‖V−θ‖² (old/cr/cr.cpp item-likelihood
        block; same assembly as CER's loss at cer.py) — keeping the
        state.log loss and the relative-change stopping criterion on
        the same objective the solves minimize."""
        item_term = self.fie if theta is None else self.fie - theta
        # jnp: works for both host and device-resident embeddings (the
        # train loop keeps them on device; the float() is the per-iteration
        # scalar sync point)
        return 0.5 * self.lu * float(jnp.sum(self.fue**2)) + 0.5 * self.lv * float(
            jnp.sum(item_term**2)
        )

    def train(
        self,
        max_iter: int = 200,
        tol: float = 1e-4,
        model_path: Optional[str] = None,
        verbose: bool = True,
        log_dir: Optional[str] = None,
        save_lag: Optional[int] = None,
        save_dir: Optional[str] = None,
        theta: Optional[np.ndarray] = None,
    ) -> None:
        """ALS loop with relative-loss convergence (ref wmf.py:61-101).

        ``log_dir`` writes state.log / settings.txt (reference cr solver
        observability, cr.cpp:91-93). ``save_lag`` dumps numbered
        ``%04d-U/V.dat`` checkpoints into ``save_dir`` every that many
        iterations (reference cr --save_lag, old/cr/main.cpp:28,
        cr.cpp:284-295).

        ``theta`` [n_items, k] is the reference cr solver's
        ``--theta_init`` topic-proportion matrix (old/cr/main.cpp:33,
        read at cr.cpp:24-40): it initializes the item factors
        (V = theta, cr.cpp:57) and enters every item solve as the
        lv-weighted content prior in the RHS (cr.cpp:210), with unrated
        items solved from the prior alone (cr.cpp:241-264). A warm
        start from ``model_path`` overrides the V init, matching the
        cr binary's resume-from-final-V.dat precedence (cr.cpp:118-122).
        """
        from ..utils.statelog import StateLog

        assert self.inter is not None
        if theta is not None:
            theta = np.asarray(theta, dtype=np.float32)
            if theta.shape != (self.inter.n_items, self.k):
                raise ValueError(
                    "theta shape %s != (n_items=%d, k=%d)"
                    % (theta.shape, self.inter.n_items, self.k)
                )
            self.fie = theta.copy()
        if model_path is not None and os.path.isdir(model_path):
            self.import_embeddings(model_path)
        slog = StateLog(
            log_dir,
            {
                "model": type(self).__name__.lower(),
                "k": self.k,
                "lu": self.lu,
                "lv": self.lv,
                "a": self.a,
                "b": self.b,
                "max_iter": max_iter,
                "tol": tol,
            },
        )
        loss = np.exp(50)
        prior = None if theta is None else jnp.asarray(theta)
        for it in range(max_iter):
            t1 = time.time()
            # device-resident iteration: embeddings never round-trip to
            # host; float(fit) + _loss_reg's float() are the only syncs
            fit = float(self._sweeps(prior=prior, as_numpy=False))
            # pass the device theta copy: avoids re-uploading it per
            # iteration inside the reg term
            loss_old, loss = loss, fit + self._loss_reg(prior)
            cond = abs(loss_old - loss) / loss_old
            slog.append(it, loss, cond)
            if save_lag and save_dir and it % save_lag == 0:
                self._save_lag_dump(save_dir, it)
            if verbose:
                tprint(
                    "Iter %3d, loss %.6f, converge %.6f, time %.2fs"
                    % (it, loss, cond, time.time() - t1)
                )
            if cond < tol:
                break
        # restore the external contract: fue/fie are mutable host arrays
        # (export, cold-start writeback in subclasses, tests)
        self.fue = np.array(self.fue)
        self.fie = np.array(self.fie)
