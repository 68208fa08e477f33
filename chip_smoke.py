"""Smoke run of train -> evaluate -> serve on one NVIDIA GPU, at full width.

Drives the system's main path once, in one process, through the entry
points a user calls (``topk_rec_tpu.cli.main``, ``TopKServer``, the model
classes) on a fold generated from ``--seed`` at MovieLens width: 69,878
users x 10,380 items, about 4M positives, k=50, d=20000 content features.
Every result is checked against the in-repo references
(``eval/protocol.py``, float64 NumPy), and any failed check exits non-zero.

Phases: 0 device, 1 fold, 2 BPR train (CLI), 3 evaluate (CLI) vs the
oracle, 4 serve (CLI + TopKServer) vs float64 top-k, 5 WMF/CER at the
library's ALS precision and at HIGHEST, 6 DPM and VBPR, 7 the plain
evaluator's selection pieces, timed. Every phase prints its wall time with
XLA compile time shown apart; these are set-up numbers, not benchmark
metrics.

  python chip_smoke.py               # one card
  python chip_smoke.py --four-cards  # distributed paths on four cards only

The last line of standard output is one JSON object naming the device.
Without a GPU the script exits non-zero before any phase.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import pickle
import re
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# near-tie bound of the evaluate comparison: trained embeddings can carry
# score gaps below float32 resolution that float64 orders differently
MAX_HIT_DIFF = 2
# the serving query matmul runs at DEFAULT precision: TF32 on the GPU
SERVE_RTOL = 2e-3
# distributed == single-device chunk (same key), as in __graft_entry__.py
DIST_RTOL, DIST_ATOL = 2e-4, 1e-5


@dataclasses.dataclass(frozen=True)
class Shape:
    n_users: int = 69878
    n_items: int = 10380
    n_seen: int = 4_400_000   # browsed pairs; ~90% are positives
    n_im: int = 8305          # in-matrix candidates; the rest are cold
    k: int = 50
    d: int = 20000
    feat_nnz: int = 64        # nonzeros per item row of the content matrix
    test_every: int = 7       # every 7th user has in-matrix test likes
    om_every: int = 11        # every 11th user has cold-start test likes
    bpr_samples: int = 98048  # --epoch-sample-limit: 3 chunks of 128x256
    vbpr_samples: int = 16128  # one chunk of 64x256
    serve_batch: int = 256
    topk: int = 30
    four_card_users: int = 69880  # 69,878 + 2 history-less rows: /4


FULL = Shape()


# ---------------------------------------------------------------- fold ----

def generate_interactions(shape: Shape, seed: int):
    """Browsed (user, item, like) triples with zipf item popularity over
    the in-matrix items; the other items never appear in training (the
    cold-start pool). Returns (users, items, likes, im_items, om_items)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(shape.n_items)
    im_items, om_items = perm[: shape.n_im], perm[shape.n_im:]
    draw = int(shape.n_seen * 1.3)
    uu = rng.integers(0, shape.n_users, size=draw).astype(np.int64)
    ii = im_items[(rng.zipf(1.1, size=draw) - 1) % shape.n_im].astype(
        np.int64
    )
    key = np.unique(uu * shape.n_items + ii)
    if key.size < shape.n_seen:
        raise ValueError(f"only {key.size} distinct pairs for {shape}")
    key = rng.permutation(key)[: shape.n_seen]
    key.sort()
    users = (key // shape.n_items).astype(np.int32)
    items = (key % shape.n_items).astype(np.int32)
    likes = rng.random(key.size) < 0.9
    return users, items, likes, im_items, om_items


def _lines(row_ids, names_row, tokens):
    """CSV lines ``row,tok,tok,...`` for rows sorted ascending."""
    counts = np.bincount(row_ids)
    rows = np.nonzero(counts)[0]
    ends = np.cumsum(counts)[rows]
    starts = ends - counts[rows]
    return [
        names_row[r] + "," + ",".join(tokens[s:e])
        for r, s, e in zip(rows, starts, ends)
    ]


def make_fold(root: str, shape: Shape, seed: int) -> dict:
    """Write fold 0 in the reference formats (uid, vid, f0tr.txt,
    f0te.{im,om}.{idl,txt}) plus a d-column content pickle ``meta.pkl``.

    Ids are strings that are not their indices, and candidate lists are in
    shuffled order, so an id-map or candidate-order bug shows up."""
    import scipy.sparse as ss

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed + 1)
    users, items, likes, im_items, om_items = generate_interactions(
        shape, seed
    )
    uid_names = np.array(
        [f"U{x}" for x in rng.permutation(shape.n_users) + 100000],
        dtype=object,
    )
    vid_names = np.array(
        [f"I{x:x}" for x in rng.permutation(shape.n_items) + 4096],
        dtype=object,
    )
    with open(os.path.join(root, "uid"), "w") as f:
        f.write("\n".join(uid_names) + "\n")
    with open(os.path.join(root, "vid"), "w") as f:
        f.write("\n".join(vid_names) + "\n")
    tok1 = np.array([v + ":1" for v in vid_names], dtype=object)
    tok0 = np.array([v + ":0" for v in vid_names], dtype=object)
    tokens = np.where(likes, tok1[items], tok0[items])
    with open(os.path.join(root, "f0tr.txt"), "w") as f:
        f.write("\n".join(_lines(users, uid_names, tokens)) + "\n")

    seen_keys = users.astype(np.int64) * shape.n_items + items
    for scen, pool, every, n_like in (
        ("im", im_items, shape.test_every, 3),
        ("om", om_items, shape.om_every, 2),
    ):
        order = rng.permutation(pool)
        with open(os.path.join(root, f"f0te.{scen}.idl"), "w") as f:
            f.write("\n".join(vid_names[order]) + "\n")
        tu = np.repeat(np.arange(0, shape.n_users, every), n_like)
        # n_like distinct items per user: strictly increasing offsets
        steps = rng.integers(1, pool.size // n_like + 1,
                             size=(tu.size // n_like, n_like))
        steps[:, 0] = rng.integers(0, pool.size, size=steps.shape[0])
        ti = pool[(np.cumsum(steps, axis=1) % pool.size).reshape(-1)]
        # a test item the user already browsed is written as a dislike
        fresh = ~np.isin(tu.astype(np.int64) * shape.n_items + ti, seen_keys)
        ttok = np.where(fresh, tok1[ti], tok0[ti])
        with open(os.path.join(root, f"f0te.{scen}.txt"), "w") as f:
            f.write("\n".join(_lines(tu, uid_names, ttok)) + "\n")

    # tf-idf-like sparse content rows, in vid order (feature ids == vid)
    nnz = shape.n_items * shape.feat_nnz
    feat = ss.csr_matrix(
        (
            rng.random(nnz, dtype=np.float32),
            (
                np.repeat(np.arange(shape.n_items), shape.feat_nnz),
                rng.integers(0, shape.d, size=nnz),
            ),
        ),
        shape=(shape.n_items, shape.d),
    )
    with open(os.path.join(root, "meta.pkl"), "wb") as f:
        pickle.dump(feat, f)
    return {"n_seen": int(users.size), "n_pos": int(likes.sum())}


# ---------------------------------------------------------- references ----

def read_fold_history(root: str, users_wanted=None):
    """user index -> set of browsed item indices, parsed in plain Python
    (independent of the library's parsers)."""
    def ids(name):
        with open(os.path.join(root, name)) as f:
            return {line.strip(): n for n, line in enumerate(f)}

    uids, iids = ids("uid"), ids("vid")
    hist = {}
    with open(os.path.join(root, "f0tr.txt")) as f:
        for line in f:
            terms = line.strip().split(",")
            u = uids.get(terms[0])
            if u is None or (users_wanted is not None and u not in users_wanted):
                continue
            hist.setdefault(u, set()).update(
                iids[t.partition(":")[0]] for t in terms[1:]
            )
    return uids, iids, hist


def oracle_accuracy(root, U, V, B, scenario, step=5, total=30):
    """accuracy@step..total of ``eval/protocol.evaluate_oracle`` on
    float64 scores, restricted to the scenario's test users."""
    from topk_rec_tpu.data.io import load_id_map
    from topk_rec_tpu.eval.protocol import evaluate_oracle, load_test_likes

    uids = load_id_map(os.path.join(root, "uid"))
    iids = load_id_map(os.path.join(root, "vid"))
    cand_map = load_id_map(os.path.join(root, f"f0te.{scenario}.idl"))
    cand = np.array([iids[c] for c in sorted(cand_map, key=cand_map.get)])
    likes = load_test_likes(
        os.path.join(root, f"f0te.{scenario}.txt"), uids, cand_map
    )
    users = np.array(sorted(likes), dtype=np.int64)
    _, _, hist = read_fold_history(root, set(users.tolist()))
    pos = {int(c): n for n, c in enumerate(cand)}
    seen = np.zeros((users.size, cand.size), bool)
    for row, u in enumerate(users):
        for i in hist.get(int(u), ()):
            if i in pos:
                seen[row, pos[i]] = True
    scores = U[users].astype(np.float64) @ V[cand].astype(np.float64).T
    if B is not None:
        scores += B.reshape(-1)[cand].astype(np.float64)[None, :]
    sub_likes = {row: likes[int(u)] for row, u in enumerate(users)}
    res = evaluate_oracle(scores, seen, sub_likes, step=step, total=total)
    return res.accuracy, res.count


def compare_csv(line: str, oracle_acc, count: int):
    """(identical at %.6f, worst bucket difference in hits)."""
    got = np.array([float(x) for x in line.split(",")[1:]])
    want_line = "".join(",%.6f" % a for a in oracle_acc)
    hit_diff = int(np.max(np.round(np.abs(got - np.asarray(oracle_acc)) * count)))
    return line.split(",", 1)[1] == want_line[1:], hit_diff


def topk_reference(U, V, B, seen_rows, users, k):
    """float64 top-k unseen per user: (values, items, scale) where scale
    bounds the magnitude of the summed products per row."""
    u = U[users].astype(np.float64)
    v = V.astype(np.float64)
    scores = u @ v.T
    scale = np.abs(u) @ np.abs(v).T
    if B is not None:
        b = B.reshape(-1).astype(np.float64)
        scores += b[None, :]
        scale += np.abs(b)[None, :]
    scores[seen_rows] = -np.inf
    items = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    vals = np.take_along_axis(scores, items, axis=1)
    return vals, items, scores, scale.max(axis=1)


def check_served(vals, items, ref_scores, ref_vals, row_scale, rtol):
    """Served values within ``rtol`` of the row's term magnitude, and
    every served item scores within that tolerance of the k-th best."""
    tol = rtol * row_scale[:, None]
    val_err = np.abs(vals.astype(np.float64) - ref_vals)
    served = np.take_along_axis(ref_scores, items.astype(np.int64), axis=1)
    kth = ref_vals[:, -1:]
    ok = bool((val_err <= tol).all() and (served >= kth - tol).all())
    return ok, float((val_err / tol).max())


def rel_diff(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# -------------------------------------------------------------- timing ----

class Phases:
    """Wall time per phase, with XLA compile time (JAX's
    backend-compile events, cache retrievals included) shown apart."""

    def __init__(self):
        import jax

        self.compile_s = 0.0
        self.rows = []
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, secs, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            self.compile_s += secs

    @contextlib.contextmanager
    def phase(self, name):
        print(f"== phase {name}", flush=True)
        c0, t0 = self.compile_s, time.perf_counter()
        yield
        wall = time.perf_counter() - t0
        comp = self.compile_s - c0
        self.rows.append((name, wall, comp))
        print(
            f"phase {name}: wall {wall:.3f} s, compile {comp:.3f} s, "
            f"steady {wall - comp:.3f} s",
            flush=True,
        )


def time_device(fn, *args, reps=20):
    """Median seconds of ``fn(*args)`` to ``block_until_ready``, after
    two warm-up calls."""
    import jax

    for _ in range(2):
        jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


class _Tee(io.TextIOBase):
    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, s):
        self.buf.write(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def run_cli(argv):
    """``cli.main(argv)`` in this process; returns its stdout text."""
    from topk_rec_tpu import cli

    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        rc = cli.main(argv)
    if rc != 0:
        raise RuntimeError(f"cli {argv[0]} returned {rc}")
    return tee.buf.getvalue()


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


# ------------------------------------------------------------- phases ----

def phase_device():
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(
            f"chip_smoke: needs an NVIDIA GPU; JAX found "
            f"{devs[0].platform!r} ({devs[0].device_kind})"
        )
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"device: {devs[0].device_kind} x{len(devs)} ({devs[0].platform})")
    return devs, smi


def build_native():
    native = os.path.join(REPO, "topk_rec_tpu", "native")
    if shutil.which(os.environ.get("CXX", "g++")) and shutil.which("make"):
        subprocess.run(["make", "-C", native], check=True,
                       capture_output=True, text=True, timeout=600)
    from topk_rec_tpu.data.io import _native_lib

    print("host parser:",
          "native (libtkr_native.so)" if _native_lib() else "python fallback")


def phase_bpr(fold, out, shape):
    bpr_dir = os.path.join(out, "bpr")
    text = run_cli([
        "train", "--model", "bpr", "-d", fold, "-o", bpr_dir,
        "--k", str(shape.k), "--batch-size", "256", "--epochs", "1",
        "--epoch-sample-limit", str(shape.bpr_samples),
    ])
    losses = [float(l.rsplit("loss ", 1)[1].split(",")[0])
              for l in text.splitlines() if ", loss " in l]
    check(losses and np.isfinite(losses).all(), f"BPR loss {losses}")
    for name in ("U", "V", "B"):
        check(os.path.exists(os.path.join(bpr_dir, f"final-{name}.dat")),
              f"final-{name}.dat missing")
    print(f"bpr: loss {losses[-1]!r}")
    return bpr_dir


def phase_evaluate(fold, bpr_dir):
    from topk_rec_tpu.data.io import read_dat

    text = run_cli(["evaluate", "-d", fold, "-m", bpr_dir, "-f", "0",
                    "-sl", "im", "om"])
    U = read_dat(os.path.join(bpr_dir, "final-U.dat"))
    V = read_dat(os.path.join(bpr_dir, "final-V.dat"))
    B = read_dat(os.path.join(bpr_dir, "final-B.dat"))
    for scen in ("im", "om"):
        line = [l for l in text.splitlines() if l.startswith(scen + ",")][-1]
        acc, count = oracle_accuracy(fold, U, V, B, scen)
        same, hits = compare_csv(line, acc, count)
        print(f"evaluate {scen}: cli {line}")
        print(f"evaluate {scen}: oracle {scen}"
              + "".join(",%.6f" % a for a in acc)
              + f" ({'identical' if same else 'differs'}; worst bucket "
              f"difference {hits} hits of {count})")
        check(hits <= MAX_HIT_DIFF, f"{scen}: {hits} hits beyond the bound")
    return U, V, B


def phase_serve(fold, bpr_dir, U, V, B, shape, seed):
    import jax.numpy as jnp

    from topk_rec_tpu.data.dataset import Interactions
    from topk_rec_tpu.data.io import load_id_map
    from topk_rec_tpu.serving import TopKServer

    uids = load_id_map(os.path.join(fold, "uid"))
    names = sorted(uids, key=uids.get)[:: max(1, shape.n_users // 4)][:4]
    text = run_cli(["recommend", "-d", fold, "-m", bpr_dir, "-k",
                    str(shape.topk), *names])
    lines = text.strip().splitlines()[-len(names):]
    for line, name in zip(lines, names):
        check(line.startswith(name + ",") and
              len(line.split(",")) == shape.topk + 1,
              f"recommend line for {name}: {line[:80]}")
    print(f"recommend: {len(lines)} users served through the CLI")

    inter, _, _ = Interactions.from_files(
        os.path.join(fold, "uid"), os.path.join(fold, "vid"),
        os.path.join(fold, "f0tr.txt"),
    )
    srv = TopKServer(U, V, B, inter)
    check(srv.U.dtype == jnp.float32, "fp32 tables expected")
    rng = np.random.default_rng(seed + 2)
    users = rng.choice(shape.n_users, size=shape.serve_batch, replace=False)
    vals, items = srv.recommend(users, k=shape.topk, method="exact")
    _, _, hist = read_fold_history(fold, set(users.tolist()))
    seen = np.zeros((users.size, shape.n_items), bool)
    for row, u in enumerate(users):
        seen[row, list(hist.get(int(u), ()))] = True
    ref_vals, _, ref_scores, scale = topk_reference(
        U, V, B, seen, users, shape.topk
    )
    ok, worst = check_served(vals, items, ref_scores, ref_vals, scale,
                             SERVE_RTOL)
    print(f"serve exact: batch {users.size}, k {shape.topk}, query matmul "
          f"at DEFAULT precision; worst |err| / ({SERVE_RTOL} x row term "
          f"magnitude) = {worst:.4f}")
    check(ok, "served top-k outside the TF32 tolerance")


def lowering_findings():
    """What HIGH and approx_max_k compile to on this card."""
    import jax
    import jax.numpy as jnp

    a = jnp.asarray(np.random.default_rng(0).standard_normal((2048, 2048)),
                    jnp.float32)
    ref = np.asarray(a, np.float64) @ np.asarray(a, np.float64)
    for prec in ("DEFAULT", "HIGH", "HIGHEST"):
        p = getattr(jax.lax.Precision, prec)
        fn = jax.jit(lambda x, p=p: jnp.dot(x, x, precision=p))
        hlo = fn.lower(a).compile().as_text()
        marks = sorted(set(re.findall(
            r'custom_call_target="[^"]+"|algorithm=\w+|"algorithm":"\w+"'
            r'|"operand_precision":\[[^\]]*\]|"kind":"__\w+"', hlo)))
        err = rel_diff(np.asarray(fn(a)), ref)
        print(f"lowering: f32 dot at {prec}: {marks}; relative error vs "
              f"float64 {err:.3e}")
    x = jnp.asarray(np.random.default_rng(1).standard_normal((256, 10380)),
                    jnp.float32)
    for name, sel in (("approx_max_k", jax.lax.approx_max_k),
                      ("lax.top_k", jax.lax.top_k)):
        hlo = jax.jit(lambda s, sel=sel: sel(s, 30)).lower(x) \
            .compile().as_text()
        print(f"lowering: {name} [256, 10380] k=30: "
              f"{sorted(set(re.findall(r'custom_call_target=\S+', hlo)))}")
    ai = np.asarray(jax.lax.approx_max_k(x, 30)[1])
    ei = np.asarray(jax.lax.top_k(x, 30)[1])
    print(f"lowering: approx_max_k indices equal lax.top_k's: "
          f"{bool((ai == ei).all())}")


def train_als(fold, shape, precision, log_root):
    """WMF (1 iteration) and CER (3 iterations) with the ALS assembly
    precision set to ``precision``; returns their tables and losses."""
    import jax

    from topk_rec_tpu.models import CER, WMF
    from topk_rec_tpu.ops import als

    als._ALS_PRECISION = precision
    jax.clear_caches()
    files = [os.path.join(fold, n) for n in ("uid", "vid", "f0tr.txt")]
    out = {}
    wmf = WMF(k=shape.k, seed=0)
    wmf.load_training_data(*files)
    wmf.train(max_iter=1, log_dir=os.path.join(log_root, "wmf"))
    out["wmf"] = (wmf.fue, wmf.fie, _last_loss(log_root, "wmf"))
    cer = CER(k=shape.k, d=shape.d, seed=0)
    cer.load_training_data(*files)
    cer.load_content_data(os.path.join(fold, "meta.pkl"), files[1])
    cer.train(max_iter=3, tol=0.0, log_dir=os.path.join(log_root, "cer"))
    out["cer"] = (cer.fue, cer.fie, _last_loss(log_root, "cer"))
    return out, cer.feat


def _last_loss(log_root, name):
    with open(os.path.join(log_root, name, "state.log")) as f:
        return float(f.read().strip().splitlines()[-1].split()[2])


def phase_als(fold, out, shape):
    import jax

    from topk_rec_tpu.ops import als

    default = als._ALS_PRECISION
    lowering_findings()
    runs = {}
    try:
        for prec in (jax.lax.Precision.HIGH, jax.lax.Precision.HIGHEST):
            name = str(prec).rsplit(".", 1)[-1]
            runs[name], feat = train_als(
                fold, shape, prec, os.path.join(out, f"als_{name}")
            )
    finally:
        als._ALS_PRECISION = default
        jax.clear_caches()
    print(f"als: library default assembly precision {default}")
    for model in ("wmf", "cer"):
        hi, best = runs["HIGH"][model], runs["HIGHEST"][model]
        for tables in (hi, best):
            check(all(np.isfinite(t).all() for t in tables),
                  f"{model}: non-finite result")
        print(f"als {model}: loss HIGH {hi[2]!r} HIGHEST {best[2]!r}; "
              f"relative difference fue {rel_diff(hi[0], best[0]):.3e} "
              f"fie {rel_diff(hi[1], best[1]):.3e} "
              f"loss {abs(hi[2] - best[2]) / abs(best[2]):.3e}")
    return feat


def phase_dpm_vbpr(fold, feat, shape):
    from topk_rec_tpu.models import DPM, VBPR, MLPEncoder

    files = [os.path.join(fold, n) for n in ("uid", "vid", "f0tr.txt")]
    dpm = DPM(k=shape.k, d=shape.d, seed=0)
    dpm.load_training_data(*files)
    dpm.set_features(feat)
    dpm.train(MLPEncoder, max_iter=1)
    check(np.isfinite(dpm.fue).all() and np.isfinite(dpm.fie).all(),
          "DPM: non-finite tables")
    print("dpm: 1 iteration, tables finite")
    vbpr = VBPR(k=shape.k, d=shape.d, seed=0)
    vbpr.load_training_data(*files)
    vbpr.set_features(feat)
    vbpr.train(epochs=1, batch_size=256,
               epoch_sample_limit=shape.vbpr_samples, scan_steps=64)
    check(all(np.isfinite(t).all() for t in (vbpr.fue, vbpr.fie, vbpr.fib)),
          "VBPR: non-finite tables")
    print("vbpr: 1 chunk, tables finite")


def phase_selection(fold, shape, seed, user_chunk=8192):
    """The plain evaluator's pieces at full width, one chunk each, plus
    the whole chunked evaluation: one-shot timings, not benchmark
    metrics."""
    import jax
    import jax.numpy as jnp

    from topk_rec_tpu.data.dataset import Interactions
    from topk_rec_tpu.eval.device import (
        _score_topk_chunk,
        evaluate_scores_device_full,
    )
    from topk_rec_tpu.ops.mask import expand_seen_mask

    inter, _, _ = Interactions.from_files(
        os.path.join(fold, "uid"), os.path.join(fold, "vid"),
        os.path.join(fold, "f0tr.txt"),
    )
    rng = np.random.default_rng(seed + 3)
    n_u, n_i, k = shape.n_users, shape.n_items, shape.topk
    U = rng.standard_normal((n_u, shape.k)).astype(np.float32)
    V = rng.standard_normal((n_i, shape.k)).astype(np.float32)
    u = jnp.asarray(U[:user_chunk])
    v = jnp.asarray(V)
    words = jnp.asarray(inter.seen_bitmap[:user_chunk])
    score = jax.jit(lambda u, v: jnp.dot(
        u, v.T, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST))
    expand = jax.jit(lambda w: expand_seen_mask(w, n_i))
    topk = jax.jit(lambda s: jax.lax.top_k(s, k))
    s = score(u, v)
    rows = u.shape[0]
    pieces = [
        ("score matmul (HIGHEST)", score, (u, v),
         rows * n_i * 4 + (rows + n_i) * shape.k * 4),
        ("expand_seen_mask", expand, (words,),
         rows * n_i + words.size * 4),
        ("lax.top_k", topk, (s,), rows * n_i * 4),
        ("_score_topk_chunk (all three)", lambda *a: _score_topk_chunk(
            *a, n_i, k), (u, v, None, words),
         (rows + n_i) * shape.k * 4 + words.size * 4),
    ]
    for name, fn, args, nbytes in pieces:
        t = time_device(fn, *args)
        print(f"selection: {name}: {t * 1e3:.3f} ms per {rows}x{n_i} chunk "
              f"(min bytes moved {nbytes / 1e6:.1f} MB)")
    cand = np.arange(n_i)
    likes = {int(x): [int(rng.integers(0, n_i))]
             for x in range(0, n_u, shape.test_every)}
    seen_dev = jnp.asarray(inter.seen_bitmap)
    run = lambda: evaluate_scores_device_full(  # noqa: E731
        U, V, None, seen_dev, cand, likes, total=k, want_rr=False)
    run()
    t0 = time.perf_counter()
    run()
    print(f"selection: evaluate_scores_device_full {n_u}x{n_i}, k={k}: "
          f"{(time.perf_counter() - t0) * 1e3:.3f} ms end to end "
          f"(host counting included)")


# ---------------------------------------------------------- four cards ----

def four_cards(shape: Shape, seed: int):
    """Distributed paths on four cards against their single-device
    counterparts: GSPMD and explicit-exchange BPR chunks, the sharded ALS
    half sweep, and the user-sharded TopKServer."""
    import jax
    import jax.numpy as jnp

    from topk_rec_tpu.data.dataset import Interactions
    from topk_rec_tpu.models import BPR
    from topk_rec_tpu.models.bpr import _train_chunk
    from topk_rec_tpu.ops.als import ALSPlan, half_sweep
    from topk_rec_tpu.parallel import DistributedBPRTrainer, make_mesh
    from topk_rec_tpu.parallel.als import DistributedALS
    from topk_rec_tpu.serving import TopKServer

    check(len(jax.devices()) >= 4, f"need 4 devices, have {jax.devices()}")
    users, items, likes, _, _ = generate_interactions(shape, seed)
    inter = Interactions(
        shape.four_card_users, shape.n_items, users[likes], items[likes],
        users, items,
    )
    batch, steps = 256, 64
    key = jax.random.PRNGKey(seed)

    def local_chunk(model):
        s = model.sampler
        hyper = {"lu": model.lu, "li": model.li, "lj": model.lj,
                 "lb": model.lb, "lr": model.lr}
        params = jax.tree.map(jnp.copy, model._params)
        ms = jax.tree.map(jnp.copy, model._ms)
        params, _, loss = _train_chunk(
            params, ms, key, s.user_rows, s.flat_pos, s.pos_bitmap, hyper,
            batch, model.n_items, model.k_candidates, steps, model.mode,
        )
        return jax.tree.map(np.asarray, params), float(loss)

    for dp, mp, exchange in ((2, 2, "gspmd"), (1, 4, "explicit")):
        model = BPR(k=shape.k, seed=seed, membership="bitmap")
        model.set_interactions(inter)
        model._init_params(jax.random.PRNGKey(seed))
        want, want_loss = local_chunk(model)
        extra = {"capacity": batch // mp} if exchange == "explicit" else {}
        trainer = DistributedBPRTrainer(
            model, make_mesh(dp=dp, mp=mp), batch_size=batch,
            scan_steps=steps, exchange=exchange, **extra,
        )
        loss = trainer.train_chunk(key)
        trainer.sync_to_model()
        got = {"ue": model.fue, "ie": model.fie, "ib": model.fib.reshape(-1)}
        worst = max(float(np.max(np.abs(got[n] - want[n])
                                 / (DIST_ATOL + DIST_RTOL * np.abs(want[n]))))
                    for n in want)
        print(f"four cards: BPR {dp}x{mp} {exchange}: loss {loss!r} vs "
              f"single device {want_loss!r}; worst |diff| / tolerance "
              f"{worst:.4f}; overflow {getattr(trainer, 'last_overflow', 0)}")
        check(worst <= 1.0, f"BPR {dp}x{mp} {exchange} differs")

    rng = np.random.default_rng(seed + 4)
    U = rng.random((inter.n_users, shape.k), dtype=np.float32)
    V = rng.random((inter.n_items, shape.k), dtype=np.float32)
    indptr, flat = inter.user_csr
    plan = ALSPlan(indptr, flat, inter.n_users)
    rated = jnp.asarray(inter.rated_items)
    got, got_fit = DistributedALS(make_mesh(dp=1, mp=4)).half_sweep(
        plan, U, V, rated, 1.0, 0.01, 0.01)
    want, want_fit = half_sweep(plan, U, V, rated, 1.0, 0.01, 0.01)
    worst = float(np.max(np.abs(got - want) / (2e-5 + 2e-4 * np.abs(want))))
    print(f"four cards: ALS half sweep 1x4: fit {got_fit!r} vs {want_fit!r}; "
          f"worst |diff| / tolerance {worst:.4f}")
    check(worst <= 1.0 and abs(got_fit - want_fit) <= 1e-3 * abs(want_fit),
          "distributed ALS half sweep differs")

    Us = rng.standard_normal((inter.n_users, shape.k)).astype(np.float32)
    Vs = rng.standard_normal((inter.n_items, shape.k)).astype(np.float32)
    bs = rng.standard_normal(inter.n_items).astype(np.float32)
    q = rng.choice(shape.n_users, size=shape.serve_batch, replace=False)
    lv, li = TopKServer(Us, Vs, bs, inter).recommend(q, k=shape.topk)
    dv, di = TopKServer(Us, Vs, bs, inter,
                        mesh=make_mesh(dp=1, mp=4)).recommend(q, k=shape.topk)
    print(f"four cards: TopKServer 1x4 vs unsharded: indices equal "
          f"{bool((di == li).all())}, max |value diff| "
          f"{float(np.max(np.abs(dv - lv)))!r}")
    check((di == li).all(), "sharded TopKServer indices differ")


# ---------------------------------------------------------------- main ----

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--work", default=os.path.join(REPO, ".cache",
                                                   "chip_smoke"),
                    help="scratch directory for the fold and models "
                         "(removed at the end)")
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the distributed paths on four cards")
    args = ap.parse_args(argv)

    devs, smi = phase_device()
    from topk_rec_tpu.utils.compile_cache import configure_compile_cache

    print("compile cache:", configure_compile_cache())
    phases = Phases()
    shape = FULL
    if args.four_cards:
        with phases.phase("four cards"):
            four_cards(shape, args.seed)
    else:
        build_native()
        shutil.rmtree(args.work, ignore_errors=True)
        fold = os.path.join(args.work, "fold")
        try:
            with phases.phase("1 fold"):
                stats = make_fold(fold, shape, args.seed)
                print(f"fold: {shape.n_users} users x {shape.n_items} items, "
                      f"{stats['n_pos']} positives of {stats['n_seen']} "
                      f"browsed pairs, d={shape.d}")
            with phases.phase("2 bpr train (cli)"):
                bpr_dir = phase_bpr(fold, args.work, shape)
            with phases.phase("3 evaluate (cli) vs oracle"):
                U, V, B = phase_evaluate(fold, bpr_dir)
            with phases.phase("4 serve"):
                phase_serve(fold, bpr_dir, U, V, B, shape, args.seed)
            with phases.phase("5 wmf + cer, HIGH and HIGHEST"):
                feat = phase_als(fold, args.work, shape)
            with phases.phase("6 dpm + vbpr"):
                phase_dpm_vbpr(fold, feat, shape)
            with phases.phase("7 selection pieces"):
                phase_selection(fold, shape, args.seed)
        finally:
            shutil.rmtree(args.work, ignore_errors=True)
    for name, wall, comp in phases.rows:
        print(f"summary: {name}: wall {wall:.3f} s, compile {comp:.3f} s")
    peak = [(d.memory_stats() or {}).get("peak_bytes_in_use", 0)
            for d in devs[:4]]
    print(f"peak device memory: {[p / 2**30 for p in peak]} GiB")
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": 4 if args.four_cards else 1,
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
