"""Mint the reference's missing ALS timing baselines (CPU, MovieLens scale).

The reference publishes no ALS timings. This times the reference's actual computation — 69,878 sequential
per-user k x k host solves + 10,380 per-item solves per sweep
(reference single/wmf.py:70-97), and for CER additionally the d x d
ridge E-solve at the reference's d=20000 (reference single/cer.py:27,64)
— via the reference-exact NumPy trainers (benchmarks/reference_models.py).

Usage:
  python benchmarks/reference_als_baseline.py [--iters 2] [--d 20000]
        [--models wmf,cer]

Prints per-iteration wall times on the host CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def movielens_scale_interactions(seed=0, n_users=69878, n_items=10380,
                                 nnz=4_000_000):
    rng = np.random.default_rng(seed)
    draw = int(nnz * 1.3)
    uu = rng.integers(0, n_users, size=draw).astype(np.int64)
    ii = ((rng.zipf(1.1, size=draw) - 1) % n_items).astype(np.int64)
    key = np.unique(uu * n_items + ii)
    rng.shuffle(key)
    key = key[:nnz]
    return (
        (key // n_items).astype(np.int32),
        (key % n_items).astype(np.int32),
        n_users,
        n_items,
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--d", type=int, default=20000,
                    help="CER content dim (reference train.py d=20000)")
    ap.add_argument("--k", type=int, default=50)
    ap.add_argument("--models", default="wmf,cer")
    args = ap.parse_args()

    import reference_models as rm

    pos_u, pos_i, n_users, n_items = movielens_scale_interactions()
    print(
        f"fold: {n_users}x{n_items}, nnz={len(pos_u):,}, k={args.k}",
        flush=True,
    )
    if "wmf" in args.models:
        times: list = []
        rm.train_wmf_reference(
            n_users, n_items, pos_u, pos_i, k=args.k,
            max_iter=args.iters, tol=0.0, seed=0, verbose=True,
            iter_times=times,
        )
        print(
            f"reference WMF: {np.mean(times):.1f} s/iteration "
            f"(per-iter: {['%.1f' % t for t in times]})",
            flush=True,
        )
    if "cer" in args.models:
        rng = np.random.default_rng(1)
        # content features at the reference's d=20000 (train.py:29);
        # random dense stand-in — the timing is dominated by the solves'
        # shapes, not the feature values
        t0 = time.time()
        feat = rng.standard_normal((n_items, args.d)).astype(np.float32)
        times = []
        rm.train_cer_reference(
            n_users, n_items, pos_u, pos_i, feat, k=args.k,
            max_iter=args.iters, tol=0.0, seed=0, verbose=True,
            iter_times=times,
        )
        total = time.time() - t0
        print(
            f"reference CER (d={args.d}): {np.mean(times):.1f} s/iteration "
            f"(per-iter: {['%.1f' % t for t in times]}; "
            f"incl. one-time FF gram, total {total:.1f} s)",
            flush=True,
        )
    if "dpm" in args.models:
        rng = np.random.default_rng(2)
        feat = rng.standard_normal((n_items, args.d)).astype(np.float32)
        times = []
        rm.train_dpm_reference(
            n_users, n_items, pos_u, pos_i, feat, k=args.k,
            max_iter=args.iters, seed=0, verbose=True, iter_times=times,
        )
        print(
            f"reference DPM (d={args.d}): {np.mean(times):.1f} s/iteration "
            f"(ALS + MLP out/fit sweeps; per-iter: "
            f"{['%.1f' % t for t in times]})",
            flush=True,
        )


if __name__ == "__main__":
    main()
