"""Benchmark entry point.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
   "device": {"platform", "kind", "count"}, "scoring": {...}}

Headline: BPR training throughput at the reference-parity configuration
(k=50, batch 256, MovieLens-scale synthetic fold: 69878 users x 10380
items, ~4M positives). The baseline divisor is the reference's loop
re-implemented on CPU (per-element Python rejection sampling + RMSProp,
benchmarks/reference_baseline.py): 18,778 samples/sec on that script's
host CPU. The reference's real TF1 path would be slower (feed_dict round
trips), so vs_baseline is conservative.

The JSON line also carries a "scoring" sub-object: full-catalog
scoring+top-k throughput (scored user-item pairs/sec) of the plain XLA
path (matmul + seen mask + ``lax.top_k``) at the MovieLens serving shape
(69878x10380, d=50, k=30, DEFAULT matmul precision). Extra diagnostics go
to stderr. Any failed phase fails the run.
"""

import json
import sys
import time

import numpy as np

REFERENCE_CPU_SAMPLES_PER_SEC = 18778.0  # benchmarks/reference_baseline.py


def bench_scoring(n_users=69878, n_items=10380, d=50, k=30, iters=16):
    """Exact scoring+top-k throughput of the plain XLA path at the
    MovieLens serving shape. Returns scored pairs per second."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    U = jnp.asarray(rng.normal(size=(n_users, d)).astype(np.float32))
    V = jnp.asarray(rng.normal(size=(n_items, d)).astype(np.float32))
    b = jnp.asarray(rng.normal(size=n_items).astype(np.float32))
    # realistic seen-mask density (~2% of catalog browsed per user),
    # generated on device instead of shipping a [U, I] host mask
    mask = jax.jit(
        lambda key: (
            jax.random.uniform(key, (n_users, n_items)) < 0.02
        ).astype(jnp.int8)
    )(jax.random.PRNGKey(0))

    @jax.jit
    def run_xla(U, V, b, mask):
        scores = jnp.dot(
            U, V.T, preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.DEFAULT,
        ) + b[None, :]
        scores = jnp.where(mask != 0, -jnp.inf, scores)
        vals, idx = jax.lax.top_k(scores, k)
        return jnp.sum(vals) + jnp.sum(idx)

    jax.block_until_ready(run_xla(U, V, b, mask))  # compile + warm
    t0 = time.perf_counter()
    for _ in range(iters):
        out = jax.block_until_ready(run_xla(U, V, b, mask))
    dt = (time.perf_counter() - t0) / iters
    assert np.isfinite(float(out))
    return n_users * n_items / dt


def main() -> None:
    import jax

    from topk_rec_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    dev = jax.devices()[0]
    device = {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
    }

    from topk_rec_tpu.data.dataset import Interactions
    from topk_rec_tpu.models import BPR
    from topk_rec_tpu.models.bpr import _train_chunk

    rng = np.random.default_rng(0)
    n_users, n_items, nnz = 69878, 10380, 4_000_000
    # MovieLens-like degree skew: zipf item popularity, deduplicated
    # (u, i) pairs. The structured generator (synthetic_interactions)
    # computes full-catalog affinity matmuls per sampled batch and is
    # unaffordable on host at 4M; the zipf skew captures the property
    # that matters for the measured costs — duplicate-row aggregation in
    # the sparse updates follows the item-degree distribution.
    draw = int(nnz * 1.3)
    uu = rng.integers(0, n_users, size=draw).astype(np.int64)
    ii = ((rng.zipf(1.1, size=draw) - 1) % n_items).astype(np.int64)
    key = np.unique(uu * n_items + ii)
    rng.shuffle(key)
    key = key[:nnz]
    inter = Interactions(
        n_users,
        n_items,
        (key // n_items).astype(np.int32),
        (key % n_items).astype(np.int32),
    )
    model = BPR(k=50, seed=0)
    model.set_interactions(inter)
    model._init_params(jax.random.PRNGKey(0))
    s = model.sampler
    hyper = {
        "lu": model.lu,
        "li": model.li,
        "lj": model.lj,
        "lb": model.lb,
        "lr": model.lr,
    }

    def run_chunks(n_chunks, batch_size, scan_steps, seed, fused=False):
        key = jax.random.PRNGKey(seed)
        out = 0.0
        for _ in range(n_chunks):
            key, sub = jax.random.split(key)
            model._params, model._ms, loss = _train_chunk(
                model._params, model._ms, sub,
                s.user_rows, s.flat_pos, s.pos_bitmap,
                hyper, batch_size, n_items, model.k_candidates,
                scan_steps, "l2", fused,
            )
            out = loss
        return float(out)  # forces completion

    batch_size, scan_steps = 256, 128
    run_chunks(1, batch_size, scan_steps, 1)  # compile + warm
    n_chunks = 16
    t0 = time.time()
    run_chunks(n_chunks, batch_size, scan_steps, 2)
    dt = time.time() - t0
    sps = n_chunks * scan_steps * batch_size / dt

    # full-catalog scoring+top-k (serving path)
    pps = bench_scoring()
    print(
        f"extra: scoring xla top_k {pps:,.0f} pairs/s", file=sys.stderr
    )
    line = {
        "metric": "bpr_train_samples_per_sec",
        "value": round(sps, 1),
        "unit": "samples/sec (k=50, batch=256 reference parity)",
        "vs_baseline": round(sps / REFERENCE_CPU_SAMPLES_PER_SEC, 2),
        "device": device,
        "scoring": {
            "pairs_per_sec": round(pps, 1),
            "path": "xla matmul+mask+top_k (DEFAULT precision, k=30)",
            "shape": "69878x10380xd50",
        },
    }
    print(json.dumps(line))

    # --- extra diagnostics to stderr ---
    # large batches auto-select the fused [n_users+n_items, k+1] table
    # (BPR.train table_layout='auto'); bench the same layout
    run_chunks(1, 8192, 64, 3, fused=True)  # compile + warm
    t0 = time.time()
    run_chunks(8, 8192, 64, 4, fused=True)
    dt = time.time() - t0
    print(
        f"extra: large-batch(8192,fused-layout) {8 * 64 * 8192 / dt:,.0f} samples/s",
        file=sys.stderr,
    )

    # ALS (WMF) iteration at the same MovieLens-scale fold
    import jax.numpy as jnp

    from topk_rec_tpu.models import CER, DPM, WMF, MLPEncoder

    wmf = WMF(k=50, seed=0)
    wmf.set_interactions(inter)
    # the device-resident iteration the train loop actually runs
    # (as_numpy=False keeps embeddings on device; float() is the
    # per-iteration sync)
    float(wmf._sweeps(prior=None, as_numpy=False))  # compile + warm
    t0 = time.time()
    float(wmf._sweeps(prior=None, as_numpy=False))
    float(wmf._sweeps(prior=None, as_numpy=False))
    dt = (time.time() - t0) / 2
    print(
        f"extra: wmf als {dt:.2f} s/iteration (69878x10380 nnz=4M k=50)",
        file=sys.stderr,
    )
    # CER iteration at the reference's d=20000 (the Woodbury-CG E-solve)
    rng2 = np.random.default_rng(7)
    cer = CER(k=50, d=20000, seed=0)
    cer._user_plan = wmf._user_plan  # same fold: reuse the plans
    cer._item_plan = wmf._item_plan
    cer.inter = inter
    cer.set_features(
        rng2.standard_normal((n_items, 20000)).astype(np.float32)
    )
    cer.fue = wmf.fue.copy()
    cer.fie = wmf.fie.copy()
    cer._E_dev = jnp.asarray(
        rng2.standard_normal((20000, 50)).astype(np.float32)
    )
    rated_items = jnp.asarray(inter.rated_items)
    rated_users = jnp.asarray(inter.rated_users)

    def cer_iter():
        # device-resident CER iteration, mirroring CER.train
        Fe = jnp.dot(
            cer._feat_device(), cer._E_dev,
            preferred_element_type=jnp.float32,
        )
        cer.fue, _ = cer._half_sweep(
            cer._user_plan, cer.fue, cer.fie,
            rated_items, cer.a, cer.b, cer.lu, as_numpy=False,
        )
        cer.fie, fit = cer._half_sweep(
            cer._item_plan, cer.fie, cer.fue,
            rated_users, cer.a, cer.b, cer.lv,
            prior=Fe, as_numpy=False,
        )
        cer._E_dev = cer._solve_E(cer.fie)
        float(fit)  # per-iteration sync point (as in CER.train's loss)

    cer_iter()  # compile + warm
    t0 = time.time()
    for _ in range(3):
        cer_iter()
    dt_cer = (time.time() - t0) / 3
    print(
        f"extra: cer als {dt_cer:.2f} s/iteration (d=20000 Woodbury-CG "
        "E-solve)",
        file=sys.stderr,
    )

    # DPM iteration (encoder predict + ALS sweeps + encoder fit sweep)
    # at the reference d=20000
    rng3 = np.random.default_rng(2)
    dpm = DPM(k=50, d=20000, seed=0)
    dpm.set_interactions(inter)
    dpm.set_features(
        rng3.standard_normal((n_items, 20000)).astype(np.float32)
    )
    enc = MLPEncoder(50, 20000, seed=0)
    dpm.encoder = enc
    rated_items, rated_users = dpm._rated_dev()

    def dpm_iter():
        Fe = enc.predict(dpm.feat)
        dpm.fie = np.array(Fe, dtype=np.float32, copy=True)
        dpm.fue, _ = dpm._half_sweep(
            dpm._user_plan, dpm.fue, dpm.fie, rated_items,
            dpm.a, dpm.b, dpm.lu, as_numpy=False,
        )
        fie_dev, fit = dpm._half_sweep(
            dpm._item_plan, dpm.fie, dpm.fue, rated_users,
            dpm.a, dpm.b, dpm.lv, prior=jnp.asarray(Fe),
            as_numpy=False,
        )
        dpm.fie = np.array(fie_dev)
        float(fit)
        enc.fit(dpm.feat, dpm.fie)

    for batch in (64, 1024):  # reference-parity fit batch, then fast mode
        enc.batch_size = batch
        dpm_iter()  # compile + warm
        t0 = time.time()
        dpm_iter()
        dpm_iter()
        print(
            f"extra: dpm iter (fit_batch={batch}) "
            f"{(time.time() - t0) / 2:.2f} s/iteration (d=20000 encoder "
            "predict + ALS + fit)",
            file=sys.stderr,
        )

    # Fusion: streamed fused eval over 8 modalities x 8,305 candidates
    # (average strategy — the O(U*C*F) shape every strategy shares).
    from topk_rec_tpu.fusion import (
        ModalityScores, average_weights, evaluate_fused,
    )
    from topk_rec_tpu.ops.mask import pack_candidate_bitmap

    rngf = np.random.default_rng(11)
    F, n_cand = 8, 8305
    embeds = [
        (
            rngf.normal(size=(n_users, 50)).astype(np.float32),
            rngf.normal(size=(n_items, 50)).astype(np.float32),
        )
        for _ in range(F)
    ]
    modalities = ModalityScores(embeds)
    cand_ids = np.sort(
        rngf.choice(n_items, size=n_cand, replace=False)
    ).astype(np.int64)
    likes = {
        int(u): [int(c) for c in rngf.integers(0, n_cand, size=3)]
        for u in rngf.choice(n_users, size=10_000, replace=False)
    }
    packed = pack_candidate_bitmap(inter.seen_bitmap, cand_ids)
    w = average_weights(F)

    def fuse_once():
        return evaluate_fused(
            modalities, w, inter.seen_bitmap, cand_ids, likes,
            user_chunk=8192, packed_seen=packed,
        )

    fuse_once()  # compile + warm
    t0 = time.time()
    fuse_once()
    dt_fuse = time.time() - t0
    entries = n_users * n_cand * F
    print(
        f"extra: fuse eval {dt_fuse:.2f} s "
        f"({entries / dt_fuse / 1e9:.2f}G fused entries/s, 8 mod x "
        f"69878x8305 streamed)",
        file=sys.stderr,
    )


if __name__ == "__main__":
    main()
