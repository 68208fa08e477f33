"""Reference-exact NumPy trainers for the accuracy-parity harness.

The north-star's first target is "match reference accuracy@10/30 within
run variance" — which requires actually TRAINING the reference's math and
comparing the resulting metrics, not just proving eval byte-identity.
TF1 is not installable here, but the reference's ALS models are pure
NumPy and its BPR loop is a small sampler + RMSProp update, so each
trainer below re-implements the reference computation exactly (same
update equations, same iteration structure, same hyperparameter
defaults), cited line-by-line:

  * BPR — reference single/bpr.py:87-165 (uniform-user sampler with
    per-element rejection resampling of negatives, softplus pairwise
    loss, l2 reg, TF-semantics RMSProp on the touched rows only);
  * WMF — reference single/wmf.py:61-101, with the *intended* weighted
    semantics (the reference's own train() crashes on its list-valued
    dicts at wmf.py:75-76; all ratings are 1 after the like=='1' filter
    so the RHS rating weights reduce to a·Σv — exactly what its working
    subclass CER runs);
  * CER — reference single/cer.py:24-73 (ALS with the F·E content prior
    in the item RHS, unrated items solved from the prior alone, the
    closed-form d×d ridge E-solve, and the cold-start writeback).

These run on CPU at whatever scale the harness picks; they are the
"reference side" of benchmarks/accuracy_parity.py and of
benchmarks/reference_als_baseline.py.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# BPR (reference single/bpr.py)
# ---------------------------------------------------------------------------


def train_bpr_reference(
    n_users: int,
    n_items: int,
    user_items: Dict[int, List[int]],
    epochs: int = 5,
    batch_size: int = 256,
    epoch_sample_limit: int = 1_000_000,
    k: int = 50,
    lambda_u: float = 2.5e-3,
    lambda_i: float = 2.5e-3,
    lambda_j: float = 2.5e-4,
    lr: float = 1.0e-4,
    seed: int = 0,
    verbose: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Reference BPR training loop in NumPy (ref single/bpr.py:103-165).

    Returns (user_embed [n_users,k], item_embed [n_items,k], item_bias
    [n_items]). The RMSProp update mirrors TF1's
    ``RMSPropOptimizer(lr)`` semantics on sparse grads: decay 0.9,
    eps 1e-10, accumulator touched only on gathered rows.
    """
    rng = np.random.RandomState(seed)
    tr_users = np.array(sorted(u for u, it in user_items.items() if it))
    pos_sets = {u: set(its) for u, its in user_items.items()}
    # N(0, 0.01) embeddings, zero bias (ref bpr.py:77-79)
    ue = rng.normal(0, 0.01, (n_users, k)).astype(np.float32)
    ie = rng.normal(0, 0.01, (n_items, k)).astype(np.float32)
    bi = np.zeros(n_items, dtype=np.float32)
    ms_ue = np.zeros_like(ue)
    ms_ie = np.zeros_like(ie)
    ms_bi = np.zeros_like(bi)
    batch_limit = int(epoch_sample_limit) // batch_size + 1  # ref bpr.py:113

    def rmsprop_rows(table, acc, rows, grad):
        # accumulate duplicate-row grads first (TF IndexedSlices semantics)
        uniq, inv = np.unique(rows, return_inverse=True)
        g = np.zeros((len(uniq),) + grad.shape[1:], dtype=np.float32)
        np.add.at(g, inv, grad)
        acc[uniq] = 0.9 * acc[uniq] + 0.1 * g * g
        table[uniq] -= lr * g / np.sqrt(acc[uniq] + 1e-10)

    for epoch in range(epochs):
        t0 = time.time()
        total = 0.0
        for _ in range(batch_limit):
            # --- sampler (ref bpr.py:155-165): uniform user, uniform
            # positive, rejection-resampled uniform negative ---
            ub = tr_users[rng.randint(0, len(tr_users), batch_size)]
            ib = np.empty(batch_size, dtype=np.int64)
            jb = np.empty(batch_size, dtype=np.int64)
            for idx in range(batch_size):
                items = user_items[ub[idx]]
                ib[idx] = items[rng.randint(len(items))]
                j = rng.randint(n_items)
                while j in pos_sets[ub[idx]]:
                    j = rng.randint(n_items)
                jb[idx] = j
            # --- gathered-row forward/backward (ref bpr.py:87-99) ---
            pu, pi, pj = ue[ub], ie[ib], ie[jb]
            x = bi[ib] - bi[jb] + np.sum(pu * (pi - pj), axis=1)
            total += float(np.sum(np.log1p(np.exp(-x))))
            s = 1.0 / (1.0 + np.exp(x))  # -dloss/dx
            gu = -s[:, None] * (pi - pj) + lambda_u * pu
            gi = -s[:, None] * pu + lambda_i * pi
            gj = s[:, None] * pu + lambda_j * pj
            rmsprop_rows(ue, ms_ue, ub, gu)
            rmsprop_rows(ie, ms_ie, np.concatenate([ib, jb]),
                         np.concatenate([gi, gj]))
            rmsprop_rows(bi, ms_bi, np.concatenate([ib, jb]),
                         np.concatenate([-s, s]))
        if verbose:
            print(
                f"  ref-bpr epoch {epoch + 1}/{epochs} loss {total:.1f} "
                f"({time.time() - t0:.1f}s)",
                flush=True,
            )
    return ue, ie, bi


# ---------------------------------------------------------------------------
# VBPR (reference single/vbpr.py)
# ---------------------------------------------------------------------------


def train_vbpr_reference(
    n_users: int,
    n_items: int,
    user_items: Dict[int, List[int]],
    feat: np.ndarray,
    epochs: int = 5,
    batch_size: int = 256,
    epoch_sample_limit: int = 1_000_000,
    k: int = 50,
    lambda_u: float = 2.5e-3,
    lambda_i: float = 2.5e-3,
    lambda_j: float = 2.5e-4,
    lambda_b: float = 0.0,
    lambda_e: float = 0.0,
    lr: float = 1.0e-4,
    seed: int = 0,
    verbose: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Reference VBPR in NumPy (ref single/vbpr.py:29-126): split-k
    rating/content user factors, item rating factors + bias, dense content
    projection cem [d, k/2] (const init 2/(d·k), vbpr.py:46) and content
    bias icb [d]; x_uij adds <uce, (f_i-f_j)·cem> and (f_i-f_j)·icb
    (vbpr.py:59-61). Sparse-RMSProp on gathered rows, DENSE RMSProp on
    cem/icb (they join via matmul, not embedding_lookup). Returns the
    COMPOSED full-catalog export (vbpr.py:124-126):
    (fue=[ure‖uce], fie=[ire‖F·cem], fib=irb+F·icb)."""
    rng = np.random.RandomState(seed)
    d = feat.shape[1]
    h = k // 2
    tr_users = np.array(sorted(u for u, it in user_items.items() if it))
    pos_sets = {u: set(its) for u, its in user_items.items()}
    ure = rng.normal(0, 0.01, (n_users, h)).astype(np.float32)
    uce = rng.normal(0, 0.01, (n_users, h)).astype(np.float32)
    ire = rng.normal(0, 0.01, (n_items, h)).astype(np.float32)
    irb = np.zeros(n_items, dtype=np.float32)
    cem = np.full((d, h), 2.0 / (d * k), dtype=np.float32)
    icb = np.zeros(d, dtype=np.float32)
    ms = {n: np.zeros_like(v) for n, v in
          (("ure", ure), ("uce", uce), ("ire", ire), ("irb", irb),
           ("cem", cem), ("icb", icb))}
    batch_limit = int(epoch_sample_limit) // batch_size + 1

    def rmsprop_rows(table, acc, rows, grad):
        uniq, inv = np.unique(rows, return_inverse=True)
        g = np.zeros((len(uniq),) + grad.shape[1:], dtype=np.float32)
        np.add.at(g, inv, grad)
        acc[uniq] = 0.9 * acc[uniq] + 0.1 * g * g
        table[uniq] -= lr * g / np.sqrt(acc[uniq] + 1e-10)

    def rmsprop_dense(table, acc, g):
        acc *= 0.9
        acc += 0.1 * g * g
        table -= lr * g / np.sqrt(acc + 1e-10)

    for epoch in range(epochs):
        t0 = time.time()
        total = 0.0
        for _ in range(batch_limit):
            ub = tr_users[rng.randint(0, len(tr_users), batch_size)]
            ib = np.empty(batch_size, dtype=np.int64)
            jb = np.empty(batch_size, dtype=np.int64)
            for idx in range(batch_size):
                items = user_items[ub[idx]]
                ib[idx] = items[rng.randint(len(items))]
                j = rng.randint(n_items)
                while j in pos_sets[ub[idx]]:
                    j = rng.randint(n_items)
                jb[idx] = j
            fu_r, fu_c = ure[ub], uce[ub]
            fi_r, fj_r = ire[ib], ire[jb]
            df = feat[ib] - feat[jb]              # [B, d]
            dfc = df @ cem                        # [B, h]
            x = (
                irb[ib] - irb[jb]
                + np.sum(fu_r * (fi_r - fj_r), axis=1)
                + np.sum(fu_c * dfc, axis=1)
                + df @ icb
            )
            total += float(np.sum(np.log1p(np.exp(-x))))
            s = 1.0 / (1.0 + np.exp(x))
            g_ur = -s[:, None] * (fi_r - fj_r) + lambda_u * fu_r
            g_uc = -s[:, None] * dfc + lambda_u * fu_c
            g_ir = -s[:, None] * fu_r + lambda_i * fi_r
            g_jr = s[:, None] * fu_r + lambda_j * fj_r
            g_cem = -(df * s[:, None]).T @ fu_c + lambda_e * cem
            g_icb = -(df.T @ s) + lambda_b * icb
            rmsprop_rows(ure, ms["ure"], ub, g_ur)
            rmsprop_rows(uce, ms["uce"], ub, g_uc)
            rmsprop_rows(ire, ms["ire"], np.concatenate([ib, jb]),
                         np.concatenate([g_ir, g_jr]))
            rmsprop_rows(irb, ms["irb"], np.concatenate([ib, jb]),
                         np.concatenate([-s + lambda_b * irb[ib],
                                         s + lambda_b * irb[jb]]))
            rmsprop_dense(cem, ms["cem"], g_cem)
            rmsprop_dense(icb, ms["icb"], g_icb)
        if verbose:
            print(
                f"  ref-vbpr epoch {epoch + 1}/{epochs} loss {total:.1f} "
                f"({time.time() - t0:.1f}s)",
                flush=True,
            )
    fue = np.concatenate([ure, uce], axis=1)
    fie = np.concatenate([ire, feat @ cem], axis=1)
    fib = irb + feat @ icb
    return fue, fie, fib


# ---------------------------------------------------------------------------
# WMF (reference single/wmf.py, intended semantics)
# ---------------------------------------------------------------------------


def _csr_lists(u_arr: np.ndarray, i_arr: np.ndarray, n: int) -> List[np.ndarray]:
    out: List[List[int]] = [[] for _ in range(n)]
    for u, i in zip(u_arr, i_arr):
        out[u].append(i)
    return [np.array(x, dtype=np.int64) for x in out]


def train_wmf_reference(
    n_users: int,
    n_items: int,
    pos_u: np.ndarray,
    pos_i: np.ndarray,
    k: int = 50,
    lu: float = 0.01,
    lv: float = 0.01,
    a: float = 1.0,
    b: float = 0.01,
    max_iter: int = 200,
    tol: float = 1e-4,
    seed: int = 0,
    verbose: bool = False,
    iter_times: Optional[list] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Reference WMF ALS: sequential per-entity k×k host solves
    (ref single/wmf.py:61-101). All ratings are 1 (like=='1' filter,
    wmf.py:50), so the RHS is a·Σv. Unrated entities keep their random
    init (the rated-only guard, wmf.py:74,85). Loss assembly and the
    |Δloss|/loss stopping rule follow wmf.py:81,94-101."""
    rng = np.random.default_rng(seed)
    fue = rng.random((n_users, k)).astype(np.float32)  # ref wmf.py:55-56
    fie = rng.random((n_items, k)).astype(np.float32)
    usm = _csr_lists(pos_u, pos_i, n_users)
    ism = _csr_lists(pos_i, pos_u, n_items)
    u_rated = np.array([u for u in range(n_users) if len(usm[u])])
    i_rated = np.array([i for i in range(n_items) if len(ism[i])])
    ik = np.eye(k)
    loss = np.exp(50)
    for it in range(max_iter):
        t1 = time.time()
        loss_old, loss = loss, 0.0
        vr = fie[i_rated]
        xx = (vr.T @ (vr * b)) + ik * lu
        for uid in range(n_users):
            if len(usm[uid]):
                v = fie[usm[uid]]
                fue[uid] = np.linalg.solve(
                    xx + (v.T @ v) * (a - b), v.sum(axis=0) * a
                )
            loss += 0.5 * lu * float(np.sum(fue[uid] ** 2))
        ur = fue[u_rated]
        xx = ur.T @ (ur * b)
        for iid in range(n_items):
            if len(ism[iid]):
                u = fue[ism[iid]]
                A = xx + (u.T @ u) * (a - b)
                fie[iid] = np.linalg.solve(A + ik * lv, u.sum(axis=0) * a)
                loss += 0.5 * len(ism[iid]) * a
                loss += 0.5 * float(fie[iid] @ A @ fie[iid])
                loss -= float(np.sum(u @ fie[iid])) * a
            loss += 0.5 * lv * float(np.sum(fie[iid] ** 2))
        cond = abs(loss_old - loss) / loss_old
        if iter_times is not None:
            iter_times.append(time.time() - t1)
        if verbose:
            print(
                f"  ref-wmf iter {it} loss {loss:.4f} conv {cond:.6f} "
                f"({time.time() - t1:.1f}s)",
                flush=True,
            )
        if cond < tol:
            break
    return fue, fie


# ---------------------------------------------------------------------------
# DPM (reference single/dpm.py + mlp.py)
# ---------------------------------------------------------------------------


class _RefMLP:
    """Reference MLP encoder in NumPy (ref single/mlp.py:8-40): sigmoid
    hidden stack d->2000->1000->k, linear output, loss 0.5·Σ(y-F)²,
    dense RMSProp(lr=1e-4), shuffled minibatches of 64 per fit sweep.
    Weight init mirrors tf.layers.dense defaults (glorot-uniform, zero
    bias)."""

    def __init__(self, k, d, lr=1e-4, hidden=(2000, 1000), seed=0):
        rng = np.random.default_rng(seed)
        dims = [d, *hidden, k]
        self.W, self.b = [], []
        for fi, fo in zip(dims[:-1], dims[1:]):
            lim = np.sqrt(6.0 / (fi + fo))
            self.W.append(
                rng.uniform(-lim, lim, (fi, fo)).astype(np.float32)
            )
            self.b.append(np.zeros(fo, dtype=np.float32))
        self.msW = [np.zeros_like(w) for w in self.W]
        self.msb = [np.zeros_like(b) for b in self.b]
        self.lr = lr
        self.rng = rng

    def _forward(self, X):
        acts = [X]
        t = X
        for lid in range(len(self.W) - 1):
            t = 1.0 / (1.0 + np.exp(-(t @ self.W[lid] + self.b[lid])))
            acts.append(t)
        out = t @ self.W[-1] + self.b[-1]
        return out, acts

    def out(self, X, batch_size=64):
        F = np.empty((X.shape[0], self.W[-1].shape[1]), dtype=np.float32)
        for i in range(0, X.shape[0], batch_size):
            F[i : i + batch_size] = self._forward(X[i : i + batch_size])[0]
        return F

    def fit(self, X, Y, batch_size=64):
        """One shuffled SGD sweep (ref mlp.py:32-40); returns summed obj."""
        ridxs = self.rng.permutation(X.shape[0])
        obj = 0.0
        for i in range(0, X.shape[0], batch_size):
            sel = ridxs[i : i + batch_size]
            xb, yb = X[sel], Y[sel]
            F, acts = self._forward(xb)
            diff = F - yb
            obj += 0.5 * float(np.sum(diff * diff))
            # backprop through linear out + sigmoid hiddens
            gW, gb = [None] * len(self.W), [None] * len(self.b)
            delta = diff
            for lid in range(len(self.W) - 1, -1, -1):
                gW[lid] = acts[lid].T @ delta
                gb[lid] = delta.sum(axis=0)
                if lid > 0:
                    sig = acts[lid]
                    delta = (delta @ self.W[lid].T) * sig * (1.0 - sig)
            for lid in range(len(self.W)):
                for p, m, g in (
                    (self.W[lid], self.msW[lid], gW[lid]),
                    (self.b[lid], self.msb[lid], gb[lid]),
                ):
                    m *= 0.9
                    m += 0.1 * g * g
                    p -= self.lr * g / np.sqrt(m + 1e-10)
        return obj


def train_dpm_reference(
    n_users: int,
    n_items: int,
    pos_u: np.ndarray,
    pos_i: np.ndarray,
    feat: np.ndarray,
    k: int = 50,
    lu: float = 0.01,
    lv: float = 10.0,
    a: float = 1.0,
    b: float = 0.01,
    max_iter: int = 20,
    seed: int = 0,
    hidden=(2000, 1000),
    verbose: bool = False,
    iter_times: Optional[list] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Reference DPM (ref single/dpm.py:20-64): per iteration the encoder
    re-predicts fie (dpm.py:33), user/item ALS runs with the prediction
    as the lv-weighted item prior (dpm.py:36-58), then the encoder takes
    ONE SGD sweep toward the solved latents (dpm.py:59). After the loop,
    cold-start writeback from the encoder output (dpm.py:61-64)."""
    rng = np.random.default_rng(seed)
    fue = rng.random((n_users, k)).astype(np.float32)
    enc = _RefMLP(k, feat.shape[1], hidden=hidden, seed=seed)
    usm = _csr_lists(pos_u, pos_i, n_users)
    ism = _csr_lists(pos_i, pos_u, n_items)
    u_rated = np.array([u for u in range(n_users) if len(usm[u])])
    i_rated = np.array([i for i in range(n_items) if len(ism[i])])
    ik = np.eye(k, dtype=np.float32)
    fie = enc.out(feat)
    for it in range(max_iter):
        t1 = time.time()
        fie = enc.out(feat)  # re-predict (dpm.py:33)
        Vr = fie[i_rated]
        XX = (Vr.T @ Vr) * b + ik * lu
        for uid in range(n_users):
            if len(usm[uid]):
                Vi = fie[usm[uid]]
                fue[uid] = np.linalg.solve(
                    (Vi.T @ Vi) * (a - b) + XX, Vi.sum(axis=0) * a
                )
        Ur = fue[u_rated]
        XX = (Ur.T @ Ur) * b
        for j in range(n_items):
            B = XX
            Fe_j = fie[j].copy()
            if len(ism[j]):
                Uj = fue[ism[j]]
                B = XX + (Uj.T @ Uj) * (a - b)
                fie[j] = np.linalg.solve(
                    B + ik * lv, Uj.sum(axis=0) * a + Fe_j * lv
                )
            else:
                fie[j] = np.linalg.solve(B + ik * lv, Fe_j * lv)
        enc.fit(feat, fie)  # one sweep toward the latents (dpm.py:59)
        if iter_times is not None:
            iter_times.append(time.time() - t1)
        if verbose:
            print(
                f"  ref-dpm iter {it} ({time.time() - t1:.1f}s)",
                flush=True,
            )
    Fe = enc.out(feat)
    rated_set = set(i_rated.tolist())
    for j in range(n_items):
        if j not in rated_set:
            fie[j] = Fe[j]
    return fue, fie


# ---------------------------------------------------------------------------
# CER (reference single/cer.py)
# ---------------------------------------------------------------------------


def train_cer_reference(
    n_users: int,
    n_items: int,
    pos_u: np.ndarray,
    pos_i: np.ndarray,
    feat: np.ndarray,
    k: int = 50,
    lu: float = 0.01,
    lv: float = 10.0,
    le: float = 10e3,
    a: float = 1.0,
    b: float = 0.01,
    max_iter: int = 20,
    tol: float = 1e-4,
    seed: int = 0,
    verbose: bool = False,
    iter_times: Optional[list] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Reference CER (ref single/cer.py:24-73): WMF ALS + the lv-weighted
    F·E content prior in every item RHS, unrated items solved from the
    prior alone (cer.py:62), closed-form d×d ridge E update (cer.py:27,64)
    and the final cold-start writeback fie[unrated] = (F·E) (cer.py:70-73).
    Returns (fue, fie, E)."""
    rng = np.random.default_rng(seed)
    d = feat.shape[1]
    fue = rng.random((n_users, k)).astype(np.float32)
    fie = rng.random((n_items, k)).astype(np.float32)
    E = rng.standard_normal((d, k)).astype(np.float32)  # ref cer.py:31
    usm = _csr_lists(pos_u, pos_i, n_users)
    ism = _csr_lists(pos_i, pos_u, n_items)
    u_rated = np.array([u for u in range(n_users) if len(usm[u])])
    i_rated = np.array([i for i in range(n_items) if len(ism[i])])
    ik = np.eye(k, dtype=np.float32)
    FF = lv * (feat.T @ feat) + le * np.eye(d, dtype=np.float32)
    loss = np.exp(50)
    for it in range(max_iter):
        t1 = time.time()
        Fe = feat @ E
        loss_old, loss = loss, 0.0
        Vr = fie[i_rated]
        XX = (Vr.T @ Vr) * b + ik * lu
        for uid in range(n_users):
            if len(usm[uid]):
                Vi = fie[usm[uid]]
                fue[uid] = np.linalg.solve(
                    (Vi.T @ Vi) * (a - b) + XX, Vi.sum(axis=0) * a
                )
            loss += 0.5 * lu * float(np.sum(fue[uid] ** 2))
        Ur = fue[u_rated]
        XX = (Ur.T @ Ur) * b
        for j in range(n_items):
            B = XX
            if len(ism[j]):
                Uj = fue[ism[j]]
                B = XX + (Uj.T @ Uj) * (a - b)
                fie[j] = np.linalg.solve(
                    B + ik * lv, Uj.sum(axis=0) * a + Fe[j] * lv
                )
                loss += 0.5 * float(fie[j] @ B @ fie[j])
                loss += 0.5 * len(ism[j]) * a
                loss -= float(np.sum(Uj * fie[j])) * a
            else:
                fie[j] = np.linalg.solve(B + ik * lv, Fe[j] * lv)
            loss += 0.5 * lv * float(np.sum((fie[j] - Fe[j]) ** 2))
        E = np.linalg.solve(FF, lv * (feat.T @ fie))
        loss += 0.5 * le * float(np.sum(E**2))
        cond = abs(loss_old - loss) / loss_old
        if iter_times is not None:
            iter_times.append(time.time() - t1)
        if verbose:
            print(
                f"  ref-cer iter {it} loss {loss:.4f} conv {cond:.6f} "
                f"({time.time() - t1:.1f}s)",
                flush=True,
            )
        if cond < tol:
            break
    # cold-start writeback (ref cer.py:70-73)
    Fe = feat @ E
    rated_set = set(i_rated.tolist())
    for j in range(n_items):
        if j not in rated_set:
            fie[j] = Fe[j]
    return fue, fie, E
