"""Scale-generalization receipts (VERDICT r4 next #1): prove the
framework's training + scoring paths hold up beyond the one MovieLens
shape everything else is tuned at.

Three measurements on the accelerator:

1. BPR training at ~1M users x ~100K items (sorted-CSR membership — the
   dense bitmap would be 12.5 GB), batch 256 and the fused large-batch
   layout at 8192.
2. Sorted-vs-bitmap membership A-B at the MovieLens shape (the probe
   overhead when both fit).
3. The plain XLA scoring+top-k path (matmul + seen mask + lax.top_k)
   at a 131,072-item catalog, per 8192-user eval chunk.

Timing: warm-up call, then each timed call ends in block_until_ready.

Usage: python benchmarks/scale_generalization.py [--skip-train]
"""

import argparse
import json
import sys
import time

import numpy as np


def _gen_inter(n_users, n_items, nnz, seed=0):
    """Zipf-skewed deduplicated (u, i) pairs (bench.py recipe)."""
    from topk_rec_tpu.data.dataset import Interactions

    rng = np.random.default_rng(seed)
    draw = int(nnz * 1.3)
    uu = rng.integers(0, n_users, size=draw).astype(np.int64)
    ii = ((rng.zipf(1.1, size=draw) - 1) % n_items).astype(np.int64)
    key = np.unique(uu * n_items + ii)
    rng.shuffle(key)
    key = key[:nnz]
    return Interactions(
        n_users,
        n_items,
        (key // n_items).astype(np.int32),
        (key % n_items).astype(np.int32),
    )


def bench_bpr(inter, membership, batch_size, scan_steps, n_chunks=8,
              table_layout="auto", label=""):
    import jax

    from topk_rec_tpu.models import BPR
    from topk_rec_tpu.models.bpr import (
        _train_chunk,
        _FUSED_LAYOUT_MAX_ROWS,
        _FUSED_LAYOUT_MIN_BATCH,
    )

    model = BPR(k=50, seed=0, membership=membership)
    model.set_interactions(inter)
    model._init_params(jax.random.PRNGKey(0))
    s = model.sampler
    assert s.membership == membership, (s.membership, membership)
    hyper = {"lu": model.lu, "li": model.li, "lj": model.lj,
             "lb": model.lb, "lr": model.lr}
    # mirror BPR.train's auto predicate exactly (incl. the row cap) so
    # the bench measures the layout production actually picks;
    # table_layout='fused'/'separate' pin it for A-Bs
    fused = (table_layout == "fused") or (
        table_layout == "auto"
        and batch_size >= _FUSED_LAYOUT_MIN_BATCH
        and inter.n_users + inter.n_items <= _FUSED_LAYOUT_MAX_ROWS
    )
    store = s.pos_bitmap if membership == "bitmap" else s.flat_sorted

    def run(n, seed):
        key = jax.random.PRNGKey(seed)
        loss = 0.0
        for _ in range(n):
            key, sub = jax.random.split(key)
            model._params, model._ms, loss = _train_chunk(
                model._params, model._ms, sub,
                s.user_rows, s.flat_pos, store,
                hyper, batch_size, inter.n_items, model.k_candidates,
                scan_steps, "l2", fused,
                membership=membership,
                n_probe_iters=getattr(s, "n_probe_iters", 0),
            )
        return float(loss)

    run(1, 1)              # compile + warm
    t0 = time.time()
    run(n_chunks, 2)
    dt = time.time() - t0
    sps = n_chunks * scan_steps * batch_size / dt
    print(
        f"bpr[{label}] membership={membership} batch={batch_size} "
        f"fused={fused}: {sps:,.0f} samples/s "
        f"({dt / n_chunks * 1e3:.1f} ms/chunk of {scan_steps} steps)",
        file=sys.stderr,
    )
    return sps


def bench_scoring_large(n_users=8192, n_items=131072, d=50, k=30, iters=8):
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    U = jnp.asarray(rng.normal(size=(n_users, d)).astype(np.float32))
    V = jnp.asarray(rng.normal(size=(n_items, d)).astype(np.float32))
    b = jnp.asarray(rng.normal(size=n_items).astype(np.float32))
    mask = jax.jit(
        lambda key: (
            jax.random.uniform(key, (n_users, n_items)) < 0.002
        ).astype(jnp.int8)
    )(jax.random.PRNGKey(0))

    def scored(U, V, b, mask):
        s = jnp.dot(U, V.T, preferred_element_type=jnp.float32) + b[None, :]
        return jnp.where(mask != 0, -jnp.inf, s)

    @jax.jit
    def run_xla(U, V, b, mask):
        vals, idx = jax.lax.top_k(scored(U, V, b, mask), k)
        return jnp.sum(vals) + jnp.sum(idx)

    def timeit(fn):
        jax.block_until_ready(fn(U, V, b, mask))
        t0 = time.time()
        for _ in range(iters):
            out = jax.block_until_ready(fn(U, V, b, mask))
        assert np.isfinite(float(out))
        return (time.time() - t0) / iters

    dt_x = timeit(run_xla)
    pairs = n_users * n_items
    print(
        f"scoring@{n_users}x{n_items}: xla {dt_x*1e3:.2f} ms "
        f"({pairs/dt_x/1e9:.2f}G pairs/s)",
        file=sys.stderr,
    )
    return {"xla_ms": dt_x * 1e3, "xla_pairs_per_sec": pairs / dt_x,
            "shape": f"{n_users}x{n_items}xd{d}"}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-train", action="store_true")
    ap.add_argument("--skip-score", action="store_true")
    ap.add_argument("--n-users", type=int, default=1_000_000)
    ap.add_argument("--n-items", type=int, default=100_000)
    ap.add_argument("--nnz", type=int, default=20_000_000)
    args = ap.parse_args()

    out = {}
    if not args.skip_score:
        out["scoring_131k"] = bench_scoring_large()

    if not args.skip_train:
        print(
            f"generating {args.nnz/1e6:.0f}M interactions at "
            f"{args.n_users}x{args.n_items} ...", file=sys.stderr,
        )
        t0 = time.time()
        big = _gen_inter(args.n_users, args.n_items, args.nnz)
        print(f"gen: {time.time()-t0:.1f}s, nnz={big.nnz}", file=sys.stderr)
        out["bpr_1m_sorted_b256"] = bench_bpr(
            big, "sorted", 256, 128, label="1Mx100K")
        out["bpr_1m_sorted_b8192"] = bench_bpr(
            big, "sorted", 8192, 16, label="1Mx100K")

        # membership A-B at MovieLens shape (both stores fit)
        ml = _gen_inter(69878, 10380, 4_000_000, seed=0)
        out["bpr_ml_bitmap_b256"] = bench_bpr(
            ml, "bitmap", 256, 128, label="ML")
        out["bpr_ml_sorted_b256"] = bench_bpr(
            ml, "sorted", 256, 128, label="ML")

    print(json.dumps(out))


if __name__ == "__main__":
    main()
