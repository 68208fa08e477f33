"""Distributed training/scoring steps over a (dp, mp) mesh.

Multi-device scaling for the pairwise-SGD family (greenfield vs the
single-device reference — SURVEY.md §2.4): embedding tables row-sharded
over the "mp" axis (NamedSharding P('mp', None)), triplet batches sharded
over "dp", jit-compiled with explicit in/out shardings so XLA GSPMD
inserts the collectives (gathers across table shards, psum of
replicated-parameter gradients). This is the scaling-book
recipe: pick a mesh, annotate shardings, let XLA place collectives.

The distributed trainers compile THE SAME chunk bodies as the single-chip
models (models/bpr.py / models/vbpr.py ``_chunk_impl``) with sharding
hooks — whole-chunk device sampling, vmapped duplicate planning, single
unique-row HBM gathers, planned RMSProp — so every single-chip
optimization is inherited by construction and dist == local numerics hold
(tests/test_parallel.py).

The scoring grid (full-catalog U·Vᵀ for serving/eval) shards users over
"dp" and items over "mp": each device computes a [users/dp, items/mp]
tile; per-user top-k then reduces across "mp" tiles.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.bpr import BPR
from ..models.vbpr import VBPR
from .mesh import BPR_PARAM_SPECS, VBPR_PARAM_SPECS, replicate, shard_params


class _DistributedPairwiseTrainer:
    """Shared machinery: shard params/sampler state, run chunks, sync back."""

    PARAM_SPECS: dict = {}

    def __init__(
        self,
        model,
        mesh: Mesh,
        batch_size: int = 4096,
        scan_steps: int = 8,
    ):
        assert model.inter is not None, "load data before distributing"
        mp = int(np.prod([
            s for s, n in zip(mesh.devices.shape, mesh.axis_names)
            if n == "mp"
        ]))
        assert model.inter.n_users % mp == 0 and model.inter.n_items % mp == 0, (
            f"user/item counts ({model.inter.n_users}/{model.inter.n_items}) "
            f"must divide the model axis ({mp}) — pad the tables or pick a "
            "different mesh (jit out-shardings require even row shards)"
        )
        self.model = model
        self.mesh = mesh
        self.batch_size = batch_size
        self.scan_steps = scan_steps
        if model._params is None:
            model._init_params(jax.random.PRNGKey(model.seed))
        self.params = shard_params(mesh, model._params, self.PARAM_SPECS)
        self.ms = shard_params(mesh, model._ms, self.PARAM_SPECS)
        s = model.sampler
        # Sampler state: per-user CSR/bitmap rows sharded like the user
        # table; the flat positive list is replicated (indices into it are
        # data-dependent). The distributed trainer ALWAYS uses the bitmap
        # membership store, built straight from the HOST array into the
        # row-sharding (row-sharding over "mp" divides its footprint by
        # the shard count: 12.5 GB at 1M users x 100K items ->
        # 1.6 GB/device on 8 devices, re-fitting scales where a single
        # device needs the sorted-CSR store; a sharded sorted store would add
        # an all-to-all to every probe for no footprint win). Building
        # from model.inter.pos_bitmap (host) rather than the sampler's
        # device copy (a) works for sorted/auto models that never built
        # a device bitmap and (b) never materializes the full bitmap on
        # one device before sharding.
        self.sampler_state = {
            "user_rows": replicate(mesh, s.user_rows),
            "flat_pos": replicate(mesh, s.flat_pos),
            "pos_bitmap": jax.device_put(
                model.inter.pos_bitmap, NamedSharding(mesh, P("mp", None))
            ),
        }
        self._step = self._build_step()

    def _shard_hooks(self):
        """(constrain_batch, constrain_table) hooks for the chunk body."""
        dp = NamedSharding(self.mesh, P(None, "dp"))
        mp = NamedSharding(self.mesh, P("mp", None))
        return (
            lambda x: jax.lax.with_sharding_constraint(x, dp),
            lambda x: jax.lax.with_sharding_constraint(x, mp),
        )

    def _param_shardings(self):
        return {
            name: NamedSharding(self.mesh, spec)
            for name, spec in self.PARAM_SPECS.items()
        }

    def _build_step(self):
        raise NotImplementedError

    def train_chunk(self, key: jax.Array) -> float:
        self.params, self.ms, loss = self._step(
            self.params, self.ms, key, self.sampler_state
        )
        return float(loss)

    def sync_to_model(self) -> None:
        """Pull sharded tables back into the host-side model state
        (multi-host shards are replicated first — see distributed.fetch)."""
        from .distributed import fetch

        self.model._params = {
            name: jnp.asarray(fetch(v)) for name, v in self.params.items()
        }
        self.model._ms = {
            name: jnp.asarray(fetch(v)) for name, v in self.ms.items()
        }
        self.model._sync_host()


class DistributedBPRTrainer(_DistributedPairwiseTrainer):
    """BPR SGD with tables row-sharded over "mp".

    Two communication modes (SURVEY §2.4 "lookup/update via all-to-all"):

    * ``exchange="gspmd"`` (default): batch over "dp", the chunk body's
      table gathers/scatters become GSPMD-inserted collectives.
    * ``exchange="explicit"``: batch split over "mp"; every step's row
      gathers run through the deduplicated all-to-all lookup and every
      update routes summed gradients back to the owning shard where ONE
      RMSProp step applies per touched row (parallel/lookup.py
      ``_exchange`` / ``_exchange_rmsprop``) — the parameter-server
      pattern, which ships only deduplicated owner traffic. Numerically
      equivalent to the GSPMD mode
      (same sampled triplets, same per-row summed gradients, same
      planned-RMSProp semantics; tests/test_parallel.py asserts it).
      Per-chunk overflow counts (uniques dropped by the fixed
      ``capacity``) are accumulated in ``last_overflow``.
    * ``exchange="auto"``: explicit when the mesh spans multiple
      PROCESSES and is pure-mp (GSPMD ships full-batch replicated-gather
      capacities to every device, several times the explicit path's
      deduplicated owner traffic, and the link between hosts is the
      slow one), GSPMD otherwise (it also supports dp×mp meshes). The
      choice is not yet measured on H100 (ROADMAP D4).
    """

    PARAM_SPECS = BPR_PARAM_SPECS

    def __init__(
        self,
        model,
        mesh: Mesh,
        batch_size: int = 4096,
        scan_steps: int = 8,
        exchange: str = "gspmd",
        capacity: int = 0,
    ):
        assert exchange in ("gspmd", "explicit", "auto"), exchange
        if exchange == "auto":
            axes = dict(zip(mesh.axis_names, mesh.devices.shape))
            pure_mp = int(axes.get("dp", 1)) == 1
            exchange = (
                "explicit"
                if jax.process_count() > 1 and pure_mp
                else "gspmd"
            )
        self.exchange = exchange
        self.capacity = capacity
        self.last_overflow = 0
        super().__init__(model, mesh, batch_size, scan_steps)

    def _build_step(self):
        if self.exchange == "explicit":
            return self._build_explicit_step()
        return self._build_gspmd_step()

    def train_chunk(self, key: jax.Array) -> float:
        if self.exchange != "explicit":
            return super().train_chunk(key)
        self.params, self.ms, loss, ovf = self._step(
            self.params, self.ms, key, self.sampler_state
        )
        from .distributed import fetch  # multi-host shards need a gather

        self.last_overflow = int(np.sum(np.asarray(fetch(ovf))))
        return float(loss)

    def _build_explicit_step(self):
        from ..models.bpr import _pairwise_loss
        from ..ops.sampling import _sample_triplets
        from .lookup import _exchange, _exchange_rmsprop

        model = self.model
        mesh = self.mesh
        axes = dict(zip(mesh.axis_names, mesh.devices.shape))
        S = int(axes.get("mp", 1))
        assert int(axes.get("dp", 1)) == 1, (
            "explicit exchange shards the batch over 'mp'; use a pure-mp "
            "mesh (dp=1)"
        )
        assert self.batch_size % S == 0, (self.batch_size, S)
        bl = self.batch_size // S
        rows_u = model.n_users // S
        rows_i = model.n_items // S
        n_steps = self.scan_steps
        k = model.k
        lu, li, lj, lb, lr = model.lu, model.li, model.lj, model.lb, model.lr
        mode = model.mode
        cap_u = self.capacity or max(8, 2 * (-(-bl // S)))
        cap_ij = 2 * cap_u  # i and j travel together: twice the indices
        n_items, k_candidates = model.n_items, model.k_candidates
        batch = self.batch_size

        def body(ue, iet, ms_u, ms_it, u_s, i_s, j_s):
            def step(carry, xs):
                ue, iet, ms_u, ms_it, ovf = carry
                u, i, j = xs
                pu, vu, o1 = _exchange(
                    ue, u, "mp", S, rows_u, cap_u, with_valid=True
                )
                pit, vi, o2 = _exchange(
                    iet, i, "mp", S, rows_i, cap_u, with_valid=True
                )
                pjt, vj, o3 = _exchange(
                    iet, j, "mp", S, rows_i, cap_u, with_valid=True
                )
                # a triplet whose u, i, OR j lookup overflowed carries a
                # zero stand-in row; weight 0 voids its entire loss and
                # gradient so the overflow behaves like dropping the
                # example (a dropped-i triplet must not push a garbage
                # bias gradient into its real j row). One nuance vs a
                # truly removed example (ADVICE r3): the voided indices
                # still route through _exchange_rmsprop, so a row touched
                # ONLY by voided triplets sees an RMSProp apply with g=0
                # — its second-moment accumulator decays by 0.9 and its
                # params move 0. Param trajectories are identical; only
                # the accumulator differs, and only on overflow batches
                # (normally none — overflow retries resize capacity).
                w = (vu & vi & vj).astype(jnp.float32)
                loss, grads = jax.value_and_grad(
                    _pairwise_loss, argnums=(0, 1, 2)
                )(pu, pit, pjt, lu, li, lj, lb, mode, k, w)
                loss = jax.lax.psum(loss, "mp")
                ue, ms_u, o4 = _exchange_rmsprop(
                    ue, ms_u, u, grads[0], "mp", S, rows_u, cap_u,
                    lr, 0.9, 1e-10,
                )
                ij = jnp.concatenate([i, j])
                gij = jnp.concatenate([grads[1], grads[2]], axis=0)
                iet, ms_it, o5 = _exchange_rmsprop(
                    iet, ms_it, ij, gij, "mp", S, rows_i, cap_ij,
                    lr, 0.9, 1e-10,
                )
                ovf = ovf + o1 + o2 + o3 + o4 + o5
                return (ue, iet, ms_u, ms_it, ovf), loss

            # overflow counts are per-device (mp-varying) outputs; the
            # zero init must carry the same varying type for the scan
            ovf0 = jax.lax.pcast(
                jnp.zeros((1,), jnp.int32), ("mp",), to="varying"
            )
            init = (ue, iet, ms_u, ms_it, ovf0)
            (ue, iet, ms_u, ms_it, ovf), losses = jax.lax.scan(
                step, init, (u_s, i_s, j_s)
            )
            return ue, iet, ms_u, ms_it, jnp.sum(losses), ovf

        shard_body = jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(
                P("mp", None), P("mp", None), P("mp", None), P("mp", None),
                P(None, "mp"), P(None, "mp"), P(None, "mp"),
            ),
            out_specs=(
                P("mp", None), P("mp", None), P("mp", None), P("mp", None),
                P(), P("mp"),
            ),
        )

        def step(params, ms, key, state):
            u_all, i_all, j_all = _sample_triplets(
                key, state["user_rows"], state["flat_pos"],
                state["pos_bitmap"], n_steps * batch, n_items,
                k_candidates,
            )
            iet = jnp.concatenate(
                [params["ie"], params["ib"][:, None]], axis=1
            )
            mst = jnp.concatenate([ms["ie"], ms["ib"][:, None]], axis=1)
            ue, iet, ms_u, ms_it, loss, ovf = shard_body(
                params["ue"], iet, ms["ue"], mst,
                u_all.reshape(n_steps, batch),
                i_all.reshape(n_steps, batch),
                j_all.reshape(n_steps, batch),
            )
            new_params = {"ue": ue, "ie": iet[:, :k], "ib": iet[:, k]}
            new_ms = {"ue": ms_u, "ie": ms_it[:, :k], "ib": ms_it[:, k]}
            return new_params, new_ms, loss, ovf

        param_shardings = self._param_shardings()
        repl = NamedSharding(self.mesh, P())
        return jax.jit(
            step,
            out_shardings=(
                param_shardings, param_shardings, repl,
                NamedSharding(self.mesh, P("mp")),
            ),
            donate_argnums=(0, 1),
        )

    def _build_gspmd_step(self):
        from ..models.bpr import _chunk_impl

        model = self.model
        hyper = {
            "lu": model.lu,
            "li": model.li,
            "lj": model.lj,
            "lb": model.lb,
            "lr": model.lr,
        }
        cb, ct = self._shard_hooks()
        param_shardings = self._param_shardings()
        repl = NamedSharding(self.mesh, P())
        chunk = partial(
            _chunk_impl,
            hyper=hyper,
            batch_size=self.batch_size,
            n_items=model.n_items,
            k_candidates=model.k_candidates,
            n_steps=self.scan_steps,
            mode=model.mode,
            constrain_batch=cb,
            constrain_table=ct,
        )

        def step(params, ms, key, state):
            return chunk(
                params, ms, key,
                state["user_rows"], state["flat_pos"], state["pos_bitmap"],
            )

        return jax.jit(
            step,
            out_shardings=(param_shardings, param_shardings, repl),
            donate_argnums=(0, 1),
        )


class DistributedVBPRTrainer(_DistributedPairwiseTrainer):
    """VBPR SGD: embedding tables + item features row-sharded over "mp",
    the dense content projection (cem) and content bias (icb) replicated
    (their gradients psum across "dp" via GSPMD), batch over "dp"."""

    PARAM_SPECS = VBPR_PARAM_SPECS

    def __init__(
        self,
        model: VBPR,
        mesh: Mesh,
        batch_size: int = 4096,
        scan_steps: int = 8,
    ):
        assert model.feat is not None, "set features before distributing"
        self.feat = jax.device_put(
            jnp.asarray(model.feat), NamedSharding(mesh, P("mp", None))
        )
        super().__init__(model, mesh, batch_size, scan_steps)

    def _build_step(self):
        from ..models.vbpr import _chunk_impl

        model = self.model
        hyper = {
            "lu": model.lu,
            "li": model.li,
            "lj": model.lj,
            "lb": model.lb,
            "le": model.le,
            "lr": model.lr,
        }
        cb, ct = self._shard_hooks()
        param_shardings = self._param_shardings()
        repl = NamedSharding(self.mesh, P())
        feat = self.feat
        chunk = partial(
            _chunk_impl,
            hyper=hyper,
            batch_size=self.batch_size,
            n_items=model.n_items,
            k_candidates=model.k_candidates,
            n_steps=self.scan_steps,
            mode=model.mode,
            constrain_batch=cb,
            constrain_table=ct,
        )

        def step(params, ms, key, state):
            return chunk(
                params, ms, key, feat,
                state["user_rows"], state["flat_pos"], state["pos_bitmap"],
            )

        return jax.jit(
            step,
            out_shardings=(param_shardings, param_shardings, repl),
            donate_argnums=(0, 1),
        )


def distributed_scores_topk(
    mesh: Mesh,
    U: np.ndarray,
    V: np.ndarray,
    bias: Optional[np.ndarray],
    k: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Full-catalog scoring + top-k with a 2D-sharded score grid.

    U rows sharded over "dp", V rows over "mp": each device holds a
    [n_users/dp, n_items/mp] tile of U·Vᵀ; ``lax.top_k`` runs on the full
    row after XLA all-gathers tiles along "mp" (a per-tile partial top-k
    merged across "mp" would move fewer bytes; not implemented).
    """
    u_shard = NamedSharding(mesh, P("dp", None))
    v_shard = NamedSharding(mesh, P("mp", None))
    U_d = jax.device_put(jnp.asarray(U), u_shard)
    V_d = jax.device_put(jnp.asarray(V), v_shard)
    b_d = (
        jax.device_put(jnp.asarray(bias).reshape(-1), NamedSharding(mesh, P("mp")))
        if bias is not None
        else None
    )

    @partial(
        jax.jit,
        static_argnames=("kk",),
        out_shardings=(NamedSharding(mesh, P("dp", None)),) * 2,
    )
    def run(U_d, V_d, b_d, kk):
        scores = jnp.dot(U_d, V_d.T, preferred_element_type=jnp.float32)
        if b_d is not None:
            scores = scores + b_d[None, :]
        vals, idx = jax.lax.top_k(scores, kk)
        return vals, idx

    vals, idx = run(U_d, V_d, b_d, k)
    return np.asarray(vals), np.asarray(idx)
