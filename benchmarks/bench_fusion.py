"""Fusion engine at MovieLens scale: streamed device fusion vs the
reference's materializing host path.

The design claim under test (fusion/fusion.py module docstring): the
reference materializes an [n_users x n_cand x n_feats] score tensor in
host RAM — ~18 GB at 69,878 x 8,305 x 8 in float64, still 9.3 GB in
float32 (reference old/methods/efusion.py:141-155 getScore loops) — and
then full-argsorts every fused row (efusion.py doEvaluate). This repo
streams per-user-chunk score stacks on the device into a masked top-k and
never materializes the tensor anywhere.

Sides:
  * ``--side device``  (on the accelerator): time the streamed fused eval for
    each of the five strategies (weights precomputed — the eval is the
    O(U·C·F) part) + the weight-learning passes.
  * ``--side ref``     (CPU): a chunked NumPy re-creation of the
    reference path's per-chunk work — 8 modality matmuls into a stacked
    [CU, n_cand, 8] float32 tensor (chunked at ~256 MB so the divisor is
    NOT penalized for the reference's actual 9-18 GB allocation),
    weighted fuse, full per-row argsort (evaluate.py:81 analog), hit
    count. This is favorable to the reference: its real scripts also pay
    python-loop walks and float64.

Timing: synced warm-up, then timed calls.

Usage:
  python benchmarks/bench_fusion.py --side ref      # CPU divisor
  python benchmarks/bench_fusion.py --side device   # accelerator (default)
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_USERS, N_ITEMS, N_CAND, F, K = 69_878, 10_380, 8_305, 8, 50


def make_modalities(rng):
    embeds = []
    for f in range(F):
        U = rng.normal(size=(N_USERS, K)).astype(np.float32) * (0.8 + 0.05 * f)
        V = rng.normal(size=(N_ITEMS, K)).astype(np.float32)
        embeds.append((U, V))
    return embeds


def make_interactions():
    """Zipf-skewed fold at MovieLens scale (bench.py recipe): the fusion
    benches only need a realistic seen bitmap / degree distribution, and
    the planted-structure generator costs ~30 min of host time at 4M
    positives while this takes ~13 s."""
    from topk_rec_tpu.data.dataset import Interactions

    rng = np.random.default_rng(1)
    draw = int(4_000_000 * 1.3)
    uu = rng.integers(0, N_USERS, size=draw).astype(np.int64)
    ii = ((rng.zipf(1.1, size=draw) - 1) % N_ITEMS).astype(np.int64)
    key = np.unique(uu * N_ITEMS + ii)
    rng.shuffle(key)
    key = key[:4_000_000]
    return Interactions(
        N_USERS, N_ITEMS,
        (key // N_ITEMS).astype(np.int32), (key % N_ITEMS).astype(np.int32),
    )


def make_likes(rng, n_liked_users=20_000):
    users = rng.choice(N_USERS, size=n_liked_users, replace=False)
    return {
        int(u): [int(c) for c in rng.integers(0, N_CAND, size=3)]
        for u in users
    }


def run_device(args):
    import jax
    import jax.numpy as jnp

    from topk_rec_tpu.fusion import (
        ModalityScores,
        average_weights,
        bpr_fusion_weights,
        error_weights,
        evaluate_fused,
        rank_geometric_weights,
        svm_fusion_weights,
    )
    from topk_rec_tpu.ops.mask import pack_candidate_bitmap

    rng = np.random.default_rng(0)
    embeds = make_modalities(rng)
    inter = make_interactions()
    likes = make_likes(rng)
    cand_ids = np.sort(
        rng.choice(N_ITEMS, size=N_CAND, replace=False)
    ).astype(np.int64)
    modalities = ModalityScores(embeds)
    packed = pack_candidate_bitmap(inter.seen_bitmap, cand_ids)

    entries = N_USERS * N_CAND * F

    def timed_eval(name, weights, iters=3):
        def once():
            return evaluate_fused(
                modalities, weights, inter.seen_bitmap, cand_ids, likes,
                user_chunk=8192, packed_seen=packed,
            )
        once()  # compile + warm
        once()  # burn first timed-size block
        t0 = time.time()
        for _ in range(iters):
            res = once()
        dt = (time.time() - t0) / iters
        print(
            f"device fused-eval {name:12s} {dt:6.2f} s "
            f"({entries / dt / 1e9:.2f}G fused entries/s) "
            f"acc@30={res.accuracy[-1]:.4f}",
            flush=True,
        )
        return dt

    w_avg = average_weights(F)
    t_avg = timed_eval("average", w_avg)
    timed_eval("rank(p=0.5)", rank_geometric_weights(F, 0.5))

    def timed_fit(name, fn, detail):
        # first call carries the XLA compile; the warm second call is
        # the steady-state number (a production grid fits weights per
        # fold x scenario with one compiled program)
        t0 = time.time()
        w = fn()
        cold = time.time() - t0
        t0 = time.time()
        w = fn()
        warm = time.time() - t0
        print(f"device {name}-weight learn: {warm:.2f} s warm / "
              f"{cold:.2f} s incl. compile ({detail})", flush=True)
        return w

    w_err = timed_fit(
        "error", lambda: error_weights(modalities, inter, cand_ids),
        "per-user weights",
    )
    timed_eval("error", w_err)

    w_svm = timed_fit(
        "svm", lambda: svm_fusion_weights(modalities, inter, seed=2),
        "100k pairs",
    )
    timed_eval("svm", w_svm)

    w_bpr = timed_fit(
        "bpr", lambda: bpr_fusion_weights(modalities, inter, seed=3),
        "10M samples — reference ranking_fusion.py:44 budget",
    )
    timed_eval("bpr", w_bpr)
    return t_avg


def run_ref(args):
    rng = np.random.default_rng(0)
    embeds = make_modalities(rng)
    likes = make_likes(rng)
    cand_ids = np.sort(
        rng.choice(N_ITEMS, size=N_CAND, replace=False)
    ).astype(np.int64)
    Vc = [V[cand_ids] for _, V in embeds]
    w = np.full(F, 1.0 / F, dtype=np.float32)

    chunk = max(1, (1 << 28) // (N_CAND * F * 4))  # ~256MB stacked tensor
    t0 = time.time()
    hits = 0
    for start in range(0, N_USERS, chunk):
        stop = min(start + chunk, N_USERS)
        stack = np.empty((stop - start, N_CAND, F), dtype=np.float32)
        for f, (U, _) in enumerate(embeds):
            stack[:, :, f] = U[start:stop] @ Vc[f].T
        fused = stack @ w
        order = np.argsort(-fused, axis=1)  # full sort, evaluate.py:81
        top = order[:, :30]
        for row, u in enumerate(range(start, stop)):
            lk = likes.get(u)
            if lk:
                hits += len(set(top[row].tolist()) & set(lk))
    dt = time.time() - t0
    entries = N_USERS * N_CAND * F
    print(
        f"reference-style materializing path (chunked {chunk} users, "
        f"float32, CPU): {dt:.1f} s ({entries / dt / 1e9:.3f}G fused "
        f"entries/s; hits={hits})",
        flush=True,
    )
    return dt


def run_ref_bprw(args):
    """Reference-style bpr-fusion WEIGHT LEARNING divisor: the 10M-sample
    pairwise SGD of reference old/methods/ranking_fusion.py:19-44
    re-created as vectorized NumPy minibatch SGD (batch 10k, same loss
    -sum log sigmoid(W.(s_i - s_j)) + lw/2 |W|^2, lr 1e-4). Favorable to
    the reference: its real script runs Theano graphs sample-batch by
    sample-batch over a pre-materialized score tensor; here the
    per-batch score vectors are fresh vectorized einsums and the Python
    loop only ticks once per 10k samples."""
    rng = np.random.default_rng(0)
    embeds = make_modalities(rng)
    inter = make_interactions()
    indptr, flat = inter.user_csr
    rated = inter.rated_users
    bitmap = inter.pos_bitmap  # vectorized membership (favorable divisor)
    n_samples, batch = 10_000_000, 10_000
    lr, lw = 1.0e-4, 0.0025
    w = np.zeros(F, dtype=np.float32)
    t0 = time.time()
    done = 0
    while done < n_samples:
        users = rated[rng.integers(0, len(rated), size=batch)]
        r = rng.integers(0, np.diff(indptr)[users])
        pos = flat[indptr[users] + r]
        neg = rng.integers(0, N_ITEMS, size=batch)
        # vectorized rejection fixup (reference sampling semantics)
        while True:
            hit = (bitmap[users, neg >> 5] >> (neg & 31)) & 1
            bad = np.nonzero(hit)[0]
            if not len(bad):
                break
            neg[bad] = rng.integers(0, N_ITEMS, size=len(bad))
        d = np.empty((batch, F), np.float32)
        for f, (U, V) in enumerate(embeds):
            d[:, f] = np.einsum(
                "bk,bk->b", U[users], V[pos] - V[neg]
            )
        x = d @ w
        sig = 1.0 / (1.0 + np.exp(x))           # sigmoid(-x)
        g = -(d * sig[:, None]).sum(axis=0) + lw * w
        w -= lr * g
        done += batch
        if done % 1_000_000 == 0:
            print(f"  ref bprw {done/1e6:.0f}M samples "
                  f"({time.time()-t0:.0f}s)", flush=True)
    dt = time.time() - t0
    print(f"reference-style bpr-weight learn (10M samples, NumPy "
          f"vectorized minibatch SGD, CPU): {dt:.1f} s", flush=True)
    return dt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--side", choices=("device", "ref", "ref-bprw"), default="device"
    )
    args = ap.parse_args()
    if args.side == "ref":
        import jax

        jax.config.update("jax_platforms", "cpu")
        run_ref(args)
    elif args.side == "ref-bprw":
        import jax

        jax.config.update("jax_platforms", "cpu")
        run_ref_bprw(args)
    else:
        run_device(args)


if __name__ == "__main__":
    main()
