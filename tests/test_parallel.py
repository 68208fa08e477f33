"""Distributed-step tests on the virtual 8-device CPU mesh."""

import jax
import numpy as np
import pytest

from topk_rec_tpu.models import BPR
from topk_rec_tpu.parallel import DistributedBPRTrainer, make_mesh
from topk_rec_tpu.parallel.train_step import distributed_scores_topk


def test_make_mesh_shapes():
    mesh = make_mesh(8)
    assert mesh.devices.size == 8
    assert mesh.axis_names == ("dp", "mp")
    mesh = make_mesh(dp=2, mp=4)
    assert mesh.devices.shape == (2, 4)


def test_distributed_bpr_matches_single_device(small_inter):
    """Same seed/key -> sharded step == single-device step numerically."""
    model_a = BPR(k=8, lr=0.05, seed=1)
    model_a.set_interactions(small_inter)
    model_a._init_params(jax.random.PRNGKey(42))
    params0 = {k: np.asarray(v) for k, v in model_a._params.items()}

    mesh = make_mesh(dp=2, mp=4)
    trainer = DistributedBPRTrainer(model_a, mesh, batch_size=64, scan_steps=4)
    key = jax.random.PRNGKey(7)
    trainer.train_chunk(key)
    trainer.sync_to_model()
    dist_params = {k: np.asarray(v) for k, v in model_a._params.items()}

    # replay on one device via the single-chip chunk
    from topk_rec_tpu.models.bpr import _train_chunk
    import jax.numpy as jnp

    model_b = BPR(k=8, lr=0.05, seed=1)
    model_b.set_interactions(small_inter)
    model_b._params = {k: jnp.asarray(v) for k, v in params0.items()}
    model_b._ms = jax.tree.map(jnp.zeros_like, model_b._params)
    s = model_b.sampler
    hyper = {"lu": model_b.lu, "li": model_b.li, "lj": model_b.lj,
             "lb": model_b.lb, "lr": model_b.lr}
    params, ms, _ = _train_chunk(
        model_b._params, model_b._ms, key,
        s.user_rows, s.flat_pos, s.pos_bitmap,
        hyper, 64, small_inter.n_items, model_b.k_candidates, 4, "l2",
    )
    for name in ("ue", "ie", "ib"):
        # tolerance covers scatter-add association-order differences
        # between the sharded and single-device lowerings
        np.testing.assert_allclose(
            dist_params[name], np.asarray(params[name]), rtol=2e-4, atol=1e-5,
        )


def test_distributed_topk_matches_local():
    rng = np.random.default_rng(0)
    U = rng.normal(size=(64, 16)).astype(np.float32)
    V = rng.normal(size=(48, 16)).astype(np.float32)
    b = rng.normal(size=48).astype(np.float32)
    mesh = make_mesh(dp=4, mp=2)
    vals, idx = distributed_scores_topk(mesh, U, V, b, k=10)
    scores = U @ V.T + b[None, :]
    import jax.numpy as jnp

    want_vals, want_idx = jax.lax.top_k(jnp.asarray(scores), 10)
    np.testing.assert_allclose(vals, np.asarray(want_vals), rtol=1e-5)
    np.testing.assert_array_equal(idx, np.asarray(want_idx))


def test_distributed_training_learns(small_inter):
    model = BPR(k=8, lr=0.05, seed=3)
    model.set_interactions(small_inter)
    mesh = make_mesh(dp=4, mp=2)
    trainer = DistributedBPRTrainer(model, mesh, batch_size=256, scan_steps=16)
    key = jax.random.PRNGKey(0)
    losses = []
    for i in range(6):
        key, sub = jax.random.split(key)
        losses.append(trainer.train_chunk(sub))
    assert losses[-1] < losses[0]
    trainer.sync_to_model()
    assert model.fue is not None and model.fue.shape == (
        small_inter.n_users, 8)


def test_distributed_als_matches_local(small_inter):
    import jax.numpy as jnp

    from topk_rec_tpu.ops.als import ALSPlan, half_sweep
    from topk_rec_tpu.parallel.als import DistributedALS

    rng = np.random.default_rng(4)
    k = 6
    U = rng.normal(size=(small_inter.n_users, k)).astype(np.float32)
    V = rng.normal(size=(small_inter.n_items, k)).astype(np.float32)
    indptr, flat = small_inter.user_csr
    plan = ALSPlan(indptr, flat, small_inter.n_users, block_size=40)
    mesh = make_mesh(dp=4, mp=2)
    dist = DistributedALS(mesh)
    got, got_fit = dist.half_sweep(
        plan, U, V, jnp.asarray(small_inter.rated_items), 1.0, 0.01, 0.05
    )
    want, want_fit = half_sweep(
        plan, U, V, jnp.asarray(small_inter.rated_items), 1.0, 0.01, 0.05
    )
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got_fit, want_fit, rtol=1e-3)


def test_distributed_als_with_prior(small_inter):
    import jax.numpy as jnp

    from topk_rec_tpu.ops.als import ALSPlan, half_sweep
    from topk_rec_tpu.parallel.als import DistributedALS

    rng = np.random.default_rng(5)
    k = 5
    U = rng.normal(size=(small_inter.n_users, k)).astype(np.float32)
    V = rng.normal(size=(small_inter.n_items, k)).astype(np.float32)
    prior = rng.normal(size=(small_inter.n_items, k)).astype(np.float32)
    indptr, flat = small_inter.item_csr
    plan = ALSPlan(indptr, flat, small_inter.n_items, block_size=16)
    mesh = make_mesh(dp=2, mp=4)
    dist = DistributedALS(mesh)
    got, _ = dist.half_sweep(
        plan, V, U, jnp.asarray(small_inter.rated_users), 1.0, 0.01, 10.0,
        prior=prior,
    )
    want, _ = half_sweep(
        plan, V, U, jnp.asarray(small_inter.rated_users), 1.0, 0.01, 10.0,
        prior=prior,
    )
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_distributed_vbpr_matches_single_device(small_inter):
    """Same seed/key -> sharded VBPR step == single-device step numerically."""
    import jax.numpy as jnp

    from topk_rec_tpu.models import VBPR
    from topk_rec_tpu.models.vbpr import _train_chunk
    from topk_rec_tpu.parallel import DistributedVBPRTrainer

    rng = np.random.default_rng(11)
    d = 12
    feat = rng.normal(size=(small_inter.n_items, d)).astype(np.float32)

    model_a = VBPR(k=8, d=d, lr=0.05, seed=1)
    model_a.set_interactions(small_inter)
    model_a.set_features(feat)
    model_a._init_params(jax.random.PRNGKey(42))
    params0 = {k: np.asarray(v) for k, v in model_a._params.items()}

    mesh = make_mesh(dp=2, mp=4)
    trainer = DistributedVBPRTrainer(model_a, mesh, batch_size=64, scan_steps=4)
    key = jax.random.PRNGKey(7)
    trainer.train_chunk(key)
    trainer.sync_to_model()
    dist_params = {k: np.asarray(v) for k, v in model_a._params.items()}

    model_b = VBPR(k=8, d=d, lr=0.05, seed=1)
    model_b.set_interactions(small_inter)
    model_b.set_features(feat)
    model_b._params = {k: jnp.asarray(v) for k, v in params0.items()}
    model_b._ms = jax.tree.map(jnp.zeros_like, model_b._params)
    s = model_b.sampler
    hyper = {"lu": model_b.lu, "li": model_b.li, "lj": model_b.lj,
             "lb": model_b.lb, "le": model_b.le, "lr": model_b.lr}
    params, _, _ = _train_chunk(
        model_b._params, model_b._ms, key, jnp.asarray(feat),
        s.user_rows, s.flat_pos, s.pos_bitmap,
        hyper, 64, small_inter.n_items, model_b.k_candidates, 4, "l2",
    )
    for name in ("ure", "uce", "ire", "irb", "cem", "icb"):
        np.testing.assert_allclose(
            dist_params[name], np.asarray(params[name]),
            rtol=2e-4, atol=1e-5, err_msg=name,
        )


def test_wmf_mesh_matches_local(small_inter):
    """WMF(mesh=...) routes ALS through the mesh and matches local training."""
    from topk_rec_tpu.models import WMF

    m_local = WMF(k=6, seed=3)
    m_local.set_interactions(small_inter)
    m_local.train(max_iter=3, verbose=False)

    m_dist = WMF(k=6, seed=3, mesh=make_mesh(dp=2, mp=4))
    m_dist.set_interactions(small_inter)
    m_dist.train(max_iter=3, verbose=False)

    np.testing.assert_allclose(m_dist.fue, m_local.fue, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(m_dist.fie, m_local.fie, rtol=2e-3, atol=2e-4)


def test_cer_mesh_matches_local(small_inter):
    """CER(mesh=...) — prior-coupled sweeps through the mesh match local."""
    from topk_rec_tpu.models import CER

    rng = np.random.default_rng(9)
    d = 10
    feat = rng.normal(size=(small_inter.n_items, d)).astype(np.float32)

    m_local = CER(k=6, d=d, seed=3)
    m_local.set_interactions(small_inter)
    m_local.set_features(feat)
    m_local.train(max_iter=2, verbose=False)

    m_dist = CER(k=6, d=d, seed=3, mesh=make_mesh(dp=4, mp=2))
    m_dist.set_interactions(small_inter)
    m_dist.set_features(feat)
    m_dist.train(max_iter=2, verbose=False)

    np.testing.assert_allclose(m_dist.fue, m_local.fue, rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(m_dist.fie, m_local.fie, rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(m_dist.E, m_local.E, rtol=5e-3, atol=5e-4)


def test_explicit_exchange_matches_gspmd(small_inter):
    """The explicit all-to-all lookup/update training mode must reproduce
    the GSPMD chunk's numerics: same key => same triplets, same per-row
    summed gradients, same planned-RMSProp step (VERDICT r2 item 3)."""
    import jax.numpy as jnp

    key = jax.random.PRNGKey(11)

    model_g = BPR(k=8, lr=0.05, seed=2)
    model_g.set_interactions(small_inter)
    model_g._init_params(jax.random.PRNGKey(43))
    params0 = {k: np.asarray(v) for k, v in model_g._params.items()}
    mesh_g = make_mesh(dp=2, mp=4)
    tr_g = DistributedBPRTrainer(model_g, mesh_g, batch_size=64,
                                 scan_steps=4)
    tr_g.train_chunk(key)
    tr_g.sync_to_model()
    params_g = {k: np.asarray(v) for k, v in model_g._params.items()}

    model_e = BPR(k=8, lr=0.05, seed=2)
    model_e.set_interactions(small_inter)
    model_e._params = {k: jnp.asarray(v) for k, v in params0.items()}
    model_e._ms = jax.tree.map(jnp.zeros_like, model_e._params)
    mesh_e = make_mesh(dp=1, mp=8)
    tr_e = DistributedBPRTrainer(
        model_e, mesh_e, batch_size=64, scan_steps=4,
        exchange="explicit", capacity=64,
    )
    tr_e.train_chunk(key)
    assert tr_e.last_overflow == 0
    tr_e.sync_to_model()
    params_e = {k: np.asarray(v) for k, v in model_e._params.items()}

    for name in ("ue", "ie", "ib"):
        np.testing.assert_allclose(
            params_e[name], params_g[name], rtol=2e-4, atol=1e-5,
        )


def test_bpr_trainer_exchange_auto_single_process(small_inter):
    """exchange='auto' resolves to gspmd in a single process and to a
    valid mode object either way."""
    import numpy as np

    from topk_rec_tpu.models import BPR
    from topk_rec_tpu.parallel import DistributedBPRTrainer, make_mesh

    model = BPR(k=8, seed=0)
    model.set_interactions(small_inter)
    tr = DistributedBPRTrainer(
        model, make_mesh(dp=1, mp=8), batch_size=64, scan_steps=1,
        exchange="auto",
    )
    assert tr.exchange == "gspmd"  # one process here
    import jax

    loss = tr.train_chunk(jax.random.PRNGKey(0))
    assert np.isfinite(loss)


def test_distributed_accepts_sorted_membership(small_inter):
    """Mesh training builds its sharded bitmap from the HOST interactions
    regardless of the model's single-chip membership store — a
    sorted-store model trains identically to a bitmap-store one (same
    seed => same stream)."""
    from topk_rec_tpu.models import BPR

    mesh = make_mesh(dp=4, mp=2)
    outs = {}
    for membership in ("bitmap", "sorted"):
        m = BPR(k=8, seed=3, membership=membership)
        m.set_interactions(small_inter)
        tr = DistributedBPRTrainer(m, mesh, batch_size=32, scan_steps=4)
        import jax

        for c in range(3):
            tr.train_chunk(jax.random.PRNGKey(c))
        tr.sync_to_model()
        outs[membership] = (m.fue.copy(), m.fie.copy())
    for a, b in zip(outs["bitmap"], outs["sorted"]):
        np.testing.assert_array_equal(a, b)
