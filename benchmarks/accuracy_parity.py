"""Trained-model accuracy parity: this framework vs the reference's math.

Trains BOTH the reference's exact NumPy re-implementation
(benchmarks/reference_models.py — cited to reference single/bpr.py,
wmf.py, cer.py line-by-line) AND this framework's models on the SAME
synthetic structured fold, evaluates BOTH through the UNTOUCHED reference
CLI (/root/reference/evaluate.py), and reports accuracy@10/30 (im, and om
for the content model) side-by-side over several seeds.

The fold has planted low-rank structure plus item content features that
linearly encode the generating latents, so:
  * BPR / WMF learn the in-matrix signal;
  * CER generalizes to out-of-matrix (cold-start) items through F·E.

The fold is written in reference file formats (uid/vid/f0tr.txt/
f0te.{im,om}.{idl,txt}) so the reference CLI runs on it unmodified.
Both sides export `final-U/V.dat`; BPR's item bias is folded into an
extra latent column on BOTH sides (U'=[U,1], V'=[V,b]) because the
reference CLI's bias path requires candidates == full catalog
(evaluate.py:80 broadcasts [1, n_items] onto [n_users, n_cand]).

Usage:
  python benchmarks/accuracy_parity.py                  # full run, 3 seeds
  python benchmarks/accuracy_parity.py --models bpr --seeds 1 --quick

Results land in benchmarks/accuracy_parity_results.json.
tests/test_accuracy_parity.py runs a scaled-down version.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Dict, List

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REFERENCE_CLI = "/root/reference/evaluate.py"


# ---------------------------------------------------------------------------
# fold generation
# ---------------------------------------------------------------------------


def make_parity_fold(
    root: str,
    n_users: int = 8000,
    n_items: int = 1600,
    n_om: int = 200,
    latent: int = 16,
    top_t: int = 30,
    train_frac: float = 0.8,
    noise: float = 0.4,
    d: int = 300,
    feat_noise: float = 0.2,
    seed: int = 0,
) -> dict:
    """Plant low-rank preference structure; split each user's top-T items
    into train / im-test / om-test; write reference file formats.

    Out-of-matrix items never appear in training (cold-start); their only
    path into the latent space is the content features, which are a noisy
    random linear embedding of the generating item latents.
    """
    rng = np.random.default_rng(seed)
    u_lat = rng.normal(size=(n_users, latent)) / np.sqrt(latent)
    i_lat = rng.normal(size=(n_items, latent)) / np.sqrt(latent)
    om_items = rng.choice(n_items, size=n_om, replace=False)
    om_mask = np.zeros(n_items, dtype=bool)
    om_mask[om_items] = True

    aff = u_lat @ i_lat.T + noise * rng.normal(size=(n_users, n_items))
    top = np.argpartition(-aff, top_t, axis=1)[:, :top_t]

    tr_u, tr_i = [], []
    im_test: Dict[int, List[int]] = {}
    om_test: Dict[int, List[int]] = {}
    for u in range(n_users):
        liked = top[u]
        om_liked = liked[om_mask[liked]]
        im_liked = liked[~om_mask[liked]]
        rng.shuffle(im_liked)
        cut = max(1, int(len(im_liked) * train_frac))
        tr_u.extend([u] * cut)
        tr_i.extend(im_liked[:cut].tolist())
        if len(im_liked) > cut:
            im_test[u] = im_liked[cut:].tolist()
        if len(om_liked):
            om_test[u] = om_liked.tolist()
    pos_u = np.array(tr_u, dtype=np.int32)
    pos_i = np.array(tr_i, dtype=np.int32)

    # im candidates = items that occur in training (the reference's im
    # candidate lists are the train-fold items, README.md:11)
    im_cand = np.unique(pos_i)
    im_cand_set = set(im_cand.tolist())
    # drop im-test likes whose item fell out of the candidate list
    im_test = {
        u: [i for i in its if i in im_cand_set]
        for u, its in im_test.items()
    }
    im_test = {u: its for u, its in im_test.items() if its}
    om_cand = np.sort(om_items)

    feat_proj = rng.normal(size=(latent, d))
    feat = (i_lat @ feat_proj + feat_noise * rng.normal(size=(n_items, d))
            ).astype(np.float32)

    os.makedirs(root, exist_ok=True)
    uids = [f"u{i}" for i in range(n_users)]
    vids = [f"v{i}" for i in range(n_items)]
    with open(os.path.join(root, "uid"), "w") as f:
        f.write("\n".join(uids) + "\n")
    with open(os.path.join(root, "vid"), "w") as f:
        f.write("\n".join(vids) + "\n")
    with open(os.path.join(root, "f0tr.txt"), "w") as f:
        order = np.argsort(pos_u, kind="stable")
        start = 0
        su, si = pos_u[order], pos_i[order]
        n = len(su)
        while start < n:
            stop = start
            while stop < n and su[stop] == su[start]:
                stop += 1
            f.write(
                uids[su[start]] + ","
                + ",".join(f"{vids[x]}:1" for x in si[start:stop]) + "\n"
            )
            start = stop
    for scen, cand, test in (
        ("im", im_cand, im_test),
        ("om", om_cand, om_test),
    ):
        with open(os.path.join(root, f"f0te.{scen}.idl"), "w") as f:
            f.write("\n".join(vids[c] for c in cand) + "\n")
        with open(os.path.join(root, f"f0te.{scen}.txt"), "w") as f:
            for u in sorted(test):
                f.write(
                    uids[u] + ","
                    + ",".join(f"{vids[x]}:1" for x in test[u]) + "\n"
                )
    return {
        "n_users": n_users,
        "n_items": n_items,
        "pos_u": pos_u,
        "pos_i": pos_i,
        "feat": feat,
        "root": root,
    }


# ---------------------------------------------------------------------------
# export + reference-CLI evaluation
# ---------------------------------------------------------------------------


def _write_dat(path: str, mat: np.ndarray) -> None:
    from topk_rec_tpu.data.io import write_dat

    write_dat(path, np.asarray(mat, dtype=np.float32))


def export_embeddings(
    mdir: str, U: np.ndarray, V: np.ndarray, bias: np.ndarray | None = None
) -> None:
    """final-U/V.dat; bias folded into an extra latent column (see module
    docstring for why final-B.dat can't be used with candidate subsets)."""
    os.makedirs(mdir, exist_ok=True)
    if bias is not None:
        U = np.concatenate([U, np.ones((U.shape[0], 1), U.dtype)], axis=1)
        V = np.concatenate([V, np.asarray(bias).reshape(-1, 1)], axis=1)
    _write_dat(os.path.join(mdir, "final-U.dat"), U)
    _write_dat(os.path.join(mdir, "final-V.dat"), V)


def evaluate_reference_cli(
    data_root: str, mdir: str, scenarios: List[str]
) -> Dict[str, Dict[str, float]]:
    """Run the untouched reference CLI; return {scenario: {acc@K: v}}."""
    cmd = [
        sys.executable, REFERENCE_CLI, "-d", data_root, "-m", mdir,
        "-f", "0", "-sl", *scenarios,
    ]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=3600)
    assert r.returncode == 0, r.stderr[-2000:]
    out = {}
    for line in r.stdout.splitlines():
        parts = line.strip().split(",")
        if parts[0] in scenarios:
            vals = [float(x) for x in parts[1:]]
            out[parts[0]] = {
                "acc@10": vals[1],
                "acc@30": vals[5],
                "all": vals,
            }
    assert set(out) == set(scenarios), r.stdout
    return out


# ---------------------------------------------------------------------------
# per-model train-and-export (both sides)
# ---------------------------------------------------------------------------


def _interactions(fold):
    from topk_rec_tpu.data.dataset import Interactions

    return Interactions(
        fold["n_users"], fold["n_items"], fold["pos_u"], fold["pos_i"]
    )


def _user_items(fold) -> Dict[int, List[int]]:
    ui: Dict[int, List[int]] = {}
    for u, i in zip(fold["pos_u"].tolist(), fold["pos_i"].tolist()):
        ui.setdefault(u, []).append(i)
    return ui


def train_side(
    model: str, side: str, fold: dict, seed: int, mdir: str, cfg: dict
) -> float:
    """Train one (model, side, seed) and export .dat; returns wall time."""
    t0 = time.time()
    if side == "ref":
        import reference_models as rm

        if model == "bpr":
            ue, ie, bi = rm.train_bpr_reference(
                fold["n_users"], fold["n_items"], _user_items(fold),
                epochs=cfg["bpr_epochs"], batch_size=256,
                epoch_sample_limit=cfg["bpr_limit"], k=cfg["k"],
                seed=seed, verbose=cfg["verbose"],
            )
            export_embeddings(mdir, ue, ie, bi)
        elif model == "vbpr":
            fue, fie, fib = rm.train_vbpr_reference(
                fold["n_users"], fold["n_items"], _user_items(fold),
                fold["feat"], epochs=cfg["bpr_epochs"], batch_size=256,
                epoch_sample_limit=cfg["bpr_limit"], k=cfg["k"],
                seed=seed, verbose=cfg["verbose"],
            )
            export_embeddings(mdir, fue, fie, fib)
        elif model in ("dpm", "dpm_fast"):
            # dpm_fast's reference side IS the standard batch-64 reference
            # alternation: the fast mode's claim is that a larger encoder
            # fit batch reproduces the reference's accuracy
            fue, fie = rm.train_dpm_reference(
                fold["n_users"], fold["n_items"], fold["pos_u"],
                fold["pos_i"], fold["feat"], k=cfg["k"],
                max_iter=cfg["cer_iters"], seed=seed,
                hidden=cfg.get("dpm_hidden", (2000, 1000)),
                verbose=cfg["verbose"],
            )
            export_embeddings(mdir, fue, fie)
        elif model == "wmf":
            fue, fie = rm.train_wmf_reference(
                fold["n_users"], fold["n_items"], fold["pos_u"],
                fold["pos_i"], k=cfg["k"], max_iter=cfg["als_iters"],
                tol=cfg["tol"], seed=seed, verbose=cfg["verbose"],
            )
            export_embeddings(mdir, fue, fie)
        elif model == "cer":
            fue, fie, _ = rm.train_cer_reference(
                fold["n_users"], fold["n_items"], fold["pos_u"],
                fold["pos_i"], fold["feat"], k=cfg["k"],
                max_iter=cfg["cer_iters"], tol=cfg["tol"], seed=seed,
                verbose=cfg["verbose"],
            )
            export_embeddings(mdir, fue, fie)
        else:
            raise ValueError(model)
    else:
        from topk_rec_tpu.models import BPR, CER, DPM, VBPR, WMF, MLPEncoder

        inter = _interactions(fold)
        if model == "bpr":
            m = BPR(k=cfg["k"], seed=seed)
            m.set_interactions(inter)
            m.train(
                epochs=cfg["bpr_epochs"], batch_size=256,
                epoch_sample_limit=cfg["bpr_limit"],
                verbose=cfg["verbose"],
            )
            export_embeddings(mdir, m.fue, m.fie, m.fib.reshape(-1))
        elif model == "vbpr":
            m = VBPR(k=cfg["k"], d=fold["feat"].shape[1], seed=seed)
            m.set_interactions(inter)
            m.set_features(fold["feat"])
            m.train(
                epochs=cfg["bpr_epochs"], batch_size=256,
                epoch_sample_limit=cfg["bpr_limit"],
                verbose=cfg["verbose"],
            )
            export_embeddings(mdir, m.fue, m.fie, m.fib.reshape(-1))
        elif model in ("dpm", "dpm_fast"):
            m = DPM(k=cfg["k"], d=fold["feat"].shape[1], seed=seed)
            m.set_interactions(inter)
            m.set_features(fold["feat"])
            enc = MLPEncoder(
                cfg["k"], fold["feat"].shape[1],
                hidden_layers=cfg.get("dpm_hidden", (2000, 1000)),
                seed=seed,
            )
            m.train(
                enc, max_iter=cfg["cer_iters"], verbose=cfg["verbose"],
                fit_batch=1024 if model == "dpm_fast" else None,
            )
            export_embeddings(mdir, m.fue, m.fie)
        elif model == "wmf":
            m = WMF(k=cfg["k"], seed=seed)
            m.set_interactions(inter)
            m.train(max_iter=cfg["als_iters"], tol=cfg["tol"],
                    verbose=cfg["verbose"])
            export_embeddings(mdir, m.fue, m.fie)
        elif model == "cer":
            m = CER(k=cfg["k"], d=fold["feat"].shape[1], seed=seed)
            m.set_interactions(inter)
            m.set_features(fold["feat"])
            m.train(max_iter=cfg["cer_iters"], tol=cfg["tol"],
                    verbose=cfg["verbose"])
            export_embeddings(mdir, m.fue, m.fie)
        else:
            raise ValueError(model)
    return time.time() - t0


MODEL_SCENARIOS = {
    "bpr": ["im"],
    "wmf": ["im"],
    "vbpr": ["im", "om"],
    "cer": ["im", "om"],
    "dpm": ["im", "om"],
    "dpm_fast": ["im", "om"],
}


def run_parity(
    fold: dict,
    models: List[str],
    seeds: List[int],
    cfg: dict,
    work: str,
) -> dict:
    results: dict = {}
    for model in models:
        scen = MODEL_SCENARIOS[model]
        results[model] = {
            s: {"ref": {"acc@10": [], "acc@30": []},
                "ours": {"acc@10": [], "acc@30": []}}
            for s in scen
        }
        results[model]["train_s"] = {"ref": [], "ours": []}
        for seed in seeds:
            for side in ("ref", "ours"):
                mdir = os.path.join(work, f"{model}_{side}_{seed}")
                dt = train_side(model, side, fold, seed, mdir, cfg)
                results[model]["train_s"][side].append(round(dt, 1))
                ev = evaluate_reference_cli(fold["root"], mdir, scen)
                for s in scen:
                    for kk in ("acc@10", "acc@30"):
                        results[model][s][side][kk].append(ev[s][kk])
                print(
                    f"{model:4s} {side:4s} seed={seed} "
                    + "  ".join(
                        f"{s}: @10={ev[s]['acc@10']:.4f} "
                        f"@30={ev[s]['acc@30']:.4f}" for s in scen
                    )
                    + f"  ({dt:.0f}s)",
                    flush=True,
                )
    return results


def summarize(results: dict) -> List[str]:
    lines = []
    for model, res in results.items():
        if model == "floor":
            continue
        for s, sides in res.items():
            if s == "train_s":
                continue
            for kk in ("acc@10", "acc@30"):
                r = np.array(sides["ref"][kk])
                o = np.array(sides["ours"][kk])
                lines.append(
                    f"{model} {s} {kk}: ref {r.mean():.4f}±{r.std():.4f} "
                    f"ours {o.mean():.4f}±{o.std():.4f} "
                    f"Δ {o.mean() - r.mean():+.4f}"
                )
    return lines


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--models", default="bpr,vbpr,wmf,cer,dpm")
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--root", default="/tmp/parity_fold")
    ap.add_argument("--quick", action="store_true",
                    help="small fold + short budgets (smoke test)")
    ap.add_argument("--ml-scale", action="store_true",
                    help="full MovieLens-scale fold (69,878 x 10,380, "
                         "2,075 om items) — the VERDICT r4 #9 parity "
                         "spot-check; pair with --models bpr (reference "
                         "ALS at this scale is hours/seed)")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)),
        "accuracy_parity_results.json"))
    args = ap.parse_args()

    # our side runs on CPU: accuracy parity is a property of the math,
    # not of the device, and the CPU run is reproducible anywhere
    import jax

    jax.config.update("jax_platforms", "cpu")

    if args.quick:
        fold = make_parity_fold(
            args.root, n_users=1200, n_items=400, n_om=60, top_t=20, d=120,
        )
        cfg = dict(k=24, bpr_epochs=3, bpr_limit=60_000, als_iters=60,
                   cer_iters=12, tol=1e-4, verbose=args.verbose)
    elif args.ml_scale:
        # exact MovieLens fold-0 dimensions (SURVEY §6: 69,878 users,
        # 10,380 items, 2,075 om items); same planted-structure recipe,
        # sparsity ~24 likes/user vs MovieLens' ~57. Budget = 2x the
        # reference's own default epoch_sample_limit (train.py:3-6)
        # because this fold's nnz is ~1.7M.
        if args.out.endswith("accuracy_parity_results.json"):
            args.out = args.out.replace(
                "accuracy_parity_results.json",
                "accuracy_parity_results_ml.json",
            )
        fold = make_parity_fold(
            args.root, n_users=69878, n_items=10380, n_om=2075,
            top_t=30, d=300,
        )
        cfg = dict(k=50, bpr_epochs=5, bpr_limit=2_000_000, als_iters=200,
                   cer_iters=20, tol=1e-4, verbose=args.verbose)
    else:
        fold = make_parity_fold(args.root)
        nnz = len(fold["pos_u"])
        # 12*nnz per epoch: at the reference's lr=1e-4 the small synthetic
        # fold needs more passes than MovieLens to reach a well-separated
        # operating point (measured: 3*nnz -> acc@30 0.036, 12*nnz ->
        # 0.044 vs random floor ~0.021); both sides get the same budget
        cfg = dict(k=50, bpr_epochs=5, bpr_limit=12 * nnz, als_iters=200,
                   cer_iters=20, tol=1e-4, verbose=args.verbose)
    print(
        f"fold: {fold['n_users']}x{fold['n_items']} "
        f"nnz={len(fold['pos_u'])}, cfg={cfg}",
        flush=True,
    )
    models = args.models.split(",")
    seeds = list(range(args.seeds))
    work = os.path.join(args.root, "models")
    # random-embedding floor: contextualizes how far above chance the
    # trained numbers sit (ranking among n_cand candidates)
    frng = np.random.default_rng(99)
    floor_dir = os.path.join(work, "floor")
    export_embeddings(
        floor_dir,
        frng.normal(size=(fold["n_users"], cfg["k"])).astype(np.float32),
        frng.normal(size=(fold["n_items"], cfg["k"])).astype(np.float32),
    )
    floor = evaluate_reference_cli(fold["root"], floor_dir, ["im", "om"])
    print(
        "floor im: @10=%.4f @30=%.4f  om: @10=%.4f @30=%.4f"
        % (floor["im"]["acc@10"], floor["im"]["acc@30"],
           floor["om"]["acc@10"], floor["om"]["acc@30"]),
        flush=True,
    )
    results = run_parity(fold, models, seeds, cfg, work)
    results["floor"] = {
        s: {kk: floor[s][kk] for kk in ("acc@10", "acc@30")}
        for s in ("im", "om")
    }
    for line in summarize(results):
        print(line)
    payload = {
        "fold": {k: fold[k] for k in ("n_users", "n_items")}
        | {"nnz": len(fold["pos_u"])},
        "cfg": {k: v for k, v in cfg.items() if k != "verbose"},
        "seeds": seeds,
        "results": results,
        "summary": summarize(results),
    }
    # merge into an existing results file (a partial --models run must
    # not clobber other families' recorded results)
    if os.path.exists(args.out):
        try:
            with open(args.out) as f:
                prev = json.load(f)
            merged = prev.get("results", {})
            merged.update(payload["results"])
            payload["results"] = merged
            payload["summary"] = [
                l for l in prev.get("summary", [])
                if not any(l.startswith(m + " ") for m in results)
            ] + payload["summary"]
        except Exception:
            pass
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
