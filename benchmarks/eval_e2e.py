"""End-to-end evaluate-CLI wall time: this framework vs the reference CLI.

Generates a synthetic fold at full MovieLens scale (69,878 users x 10,380
items, ~4M positives, 8,305 im candidates; the fold generator of
chip_smoke.py) with random continuous embeddings, then times

  python /root/reference/evaluate.py -d D -m M -f 0 -sl im     (CPU NumPy)
  python -m topk_rec_tpu.cli evaluate -d D -m M -f 0 -sl im    (device path)

on the identical inputs, asserting the CSV outputs are byte-identical.
The reference's hot path is a full np.argsort of the [69878 x 8305] score
matrix plus a per-user Python ranking walk (evaluate.py:81-108); ours is
chunked device scoring + masked top-k. Both timings include process
startup and data parsing (the honest CLI-to-CLI comparison).

Usage: python benchmarks/eval_e2e.py  [--n-seen 4400000]
Long runs can be split: --root DIR persists the generated fold and
--only gen|ours|ref runs one phase (timings print per phase).
"""

import argparse
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REFERENCE_CLI = "/root/reference/evaluate.py"


def make_fold(root: str, n_users: int, n_items: int, n_seen: int,
              n_cand: int, k: int, seed: int = 0) -> str:
    """Fold 0 in the reference formats plus random continuous
    ``final-U/V.dat`` (ties would be rank-ambiguous) under ``root/model``."""
    from chip_smoke import Shape, make_fold as write_fold
    from topk_rec_tpu.data.io import write_dat

    write_fold(root, Shape(n_users=n_users, n_items=n_items, n_seen=n_seen,
                           n_im=n_cand, k=k), seed)
    rng = np.random.default_rng(seed)
    mdir = os.path.join(root, "model")
    os.makedirs(mdir)
    write_dat(os.path.join(mdir, "final-U.dat"),
              rng.normal(size=(n_users, k)).astype(np.float32))
    write_dat(os.path.join(mdir, "final-V.dat"),
              rng.normal(size=(n_items, k)).astype(np.float32))
    return mdir


def run_timed(cmd, env=None):
    t0 = time.time()
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=3600,
                       env=env)
    dt = time.time() - t0
    assert r.returncode == 0, r.stderr[-2000:]
    line = [l for l in r.stdout.splitlines() if l.startswith("im,")][-1]
    return dt, line


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-seen", type=int, default=4_400_000)
    ap.add_argument("--n-users", type=int, default=69878)
    ap.add_argument("--n-items", type=int, default=10380)
    ap.add_argument("--n-cand", type=int, default=8305)
    ap.add_argument("--k", type=int, default=50)
    ap.add_argument("--root", default=None,
                    help="persist/reuse the fold here instead of a tempdir")
    ap.add_argument("--only", choices=["gen", "ours", "ref"], default=None)
    args = ap.parse_args()

    ctx = tempfile.TemporaryDirectory() if args.root is None else None
    root = args.root or ctx.name
    mdir = os.path.join(root, "model")
    try:
        if args.only in (None, "gen"):
            os.makedirs(root, exist_ok=True)
            print(f"generating fold ({args.n_seen:,} browsed pairs)...",
                  flush=True)
            t0 = time.time()
            make_fold(root, args.n_users, args.n_items, args.n_seen,
                      args.n_cand, args.k)
            print(f"generated in {time.time() - t0:.1f} s", flush=True)
            if args.only == "gen":
                return
        ours_cmd = [
            sys.executable, "-m", "topk_rec_tpu.cli", "evaluate",
            "-d", root, "-m", mdir, "-f", "0", "-sl", "im",
        ]
        ref_cmd = [
            sys.executable, REFERENCE_CLI,
            "-d", root, "-m", mdir, "-f", "0", "-sl", "im",
        ]
        if args.only in (None, "ours"):
            print("running this framework (device path)...", flush=True)
            t_ours, line_ours = run_timed(ours_cmd)
            print(f"ours (cold): {t_ours:8.1f} s  {line_ours}", flush=True)
            t_ours2, _ = run_timed(ours_cmd)
            print(f"ours (warm): {t_ours2:8.1f} s", flush=True)
            if args.only == "ours":
                return
        if args.only in (None, "ref"):
            print("running reference CLI (CPU)...", flush=True)
            t_ref, line_ref = run_timed(ref_cmd)
            print(f"reference  : {t_ref:8.1f} s  {line_ref}", flush=True)
            if args.only == "ref":
                return
        assert line_ours == line_ref, (
            f"CSV mismatch:\nref : {line_ref}\nours: {line_ours}"
        )
        print(f"\nbyte-identical output: {line_ref}")
        print(f"speedup (warm): {t_ref / t_ours2:.1f}x")
    finally:
        if ctx is not None:
            ctx.cleanup()


if __name__ == "__main__":
    main()
