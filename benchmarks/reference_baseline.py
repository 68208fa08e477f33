"""Mint the reference's missing performance baseline on CPU.

The reference repo publishes no benchmark numbers; its BPR
trains with a per-element Python rejection sampler feeding a TF1 session
one 256-sample batch at a time (reference single/bpr.py:103-165). TF1 is
not installable here, so this re-implements the exact same computation in
NumPy with the same loop structure:

  * generator yielding (u, i, j) batches — uniform user from the rated
    list, uniform positive via np.random.choice, per-element rejection
    resampling of negatives (bpr.py:155-165);
  * per-batch gathered-row BPR gradient + TF-semantics RMSProp
    (decay 0.9, eps 1e-10) on the touched rows.

The NumPy update path is, if anything, faster than TF1 feed_dict
sess.run round trips, so the minted number is a *favorable* baseline.

Usage: python benchmarks/reference_baseline.py [--samples 100000]
Prints samples/sec; bench.py's ``vs_baseline`` divides by the figure
this script printed on its host CPU (REFERENCE_CPU_SAMPLES_PER_SEC).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def make_synthetic(n_users=69878, n_items=10380, nnz=4_000_000, seed=0):
    rng = np.random.default_rng(seed)
    pos_u = rng.integers(0, n_users, size=nnz).astype(np.int32)
    pos_i = rng.integers(0, n_items, size=nnz).astype(np.int32)
    tr = {}
    for u, i in zip(pos_u, pos_i):
        tr.setdefault(int(u), []).append(int(i))
    return n_users, n_items, tr


def uniform_user_sampling(tr_data, tr_users, n_items, batch_size):
    """Reference sampler, verbatim structure (bpr.py:155-165)."""
    ib = np.zeros(batch_size, dtype=np.int32)
    jb = np.zeros(batch_size, dtype=np.int32)
    while True:
        ub = np.random.choice(tr_users, batch_size)
        for idx in range(batch_size):
            ib[idx] = np.random.choice(tr_data[ub[idx]])
            jb[idx] = np.random.choice(n_items)
            while jb[idx] in tr_data[ub[idx]]:
                jb[idx] = np.random.choice(n_items)
        yield ub, ib, jb


def run(n_samples: int, batch_size: int = 256, k: int = 50, seed: int = 0):
    np.random.seed(seed)
    n_users, n_items, tr_data = make_synthetic()
    tr_users = np.array(list(tr_data.keys()))
    lu, li, lj, lr = 2.5e-3, 2.5e-3, 2.5e-4, 1e-4
    ue = np.random.normal(0, 0.01, (n_users, k)).astype(np.float32)
    ie = np.random.normal(0, 0.01, (n_items, k)).astype(np.float32)
    ib_ = np.zeros(n_items, dtype=np.float32)
    ms = {
        "ue": np.zeros_like(ue),
        "ie": np.zeros_like(ie),
        "ib": np.zeros_like(ib_),
    }
    sampler = uniform_user_sampling(tr_data, tr_users, n_items, batch_size)
    n_batches = n_samples // batch_size
    t0 = time.time()
    for bno, (ub, ibx, jbx) in enumerate(sampler):
        pu, pi, pj = ue[ub], ie[ibx], ie[jbx]
        bi, bj = ib_[ibx], ib_[jbx]
        x = bi - bj + np.sum(pu * (pi - pj), axis=1)
        sig = 1.0 / (1.0 + np.exp(x))  # d/dx log(1+exp(-x)) = -sigmoid(-x)
        gu = -sig[:, None] * (pi - pj) + lu * pu
        gi = -sig[:, None] * pu + li * pi
        gj = sig[:, None] * pu + lj * pj
        gbi = -sig
        gbj = sig
        for name, rows, grad in (
            ("ue", ub, gu), ("ie", ibx, gi), ("ie", jbx, gj),
        ):
            table, acc = (ue, ms["ue"]) if name == "ue" else (ie, ms["ie"])
            np.add.at(acc, rows, 0.0)  # touch
            g_dense = np.zeros_like(table)
            np.add.at(g_dense, rows, grad)
            touched = np.zeros(table.shape[0], bool)
            touched[rows] = True
            acc[touched] = 0.9 * acc[touched] + 0.1 * g_dense[touched] ** 2
            table[touched] -= lr * g_dense[touched] / np.sqrt(
                acc[touched] + 1e-10
            )
        gb_dense = np.zeros_like(ib_)
        np.add.at(gb_dense, ibx, gbi)
        np.add.at(gb_dense, jbx, gbj)
        touched = np.zeros(n_items, bool)
        touched[ibx] = True
        touched[jbx] = True
        ms["ib"][touched] = 0.9 * ms["ib"][touched] + 0.1 * gb_dense[touched] ** 2
        ib_[touched] -= lr * gb_dense[touched] / np.sqrt(
            ms["ib"][touched] + 1e-10
        )
        if bno + 1 >= n_batches:
            break
    dt = time.time() - t0
    sps = n_batches * batch_size / dt
    return sps, dt


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=100_000)
    ap.add_argument("--batch-size", type=int, default=256)
    args = ap.parse_args()
    sps, dt = run(args.samples, args.batch_size)
    print(
        f"reference-style CPU BPR: {sps:,.0f} samples/sec "
        f"({args.samples} samples in {dt:.1f}s; epoch of 1e6 samples "
        f"would take {1e6 / sps:.0f}s)",
        file=sys.stderr,
    )
    print(f"{sps:.1f}")
