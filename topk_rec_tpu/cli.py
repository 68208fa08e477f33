"""Command-line interface: train / evaluate / fuse.

``evaluate`` is flag-compatible with the reference CLI
(reference evaluate.py:48-55: -d -m -f -s -t -sl) and prints the same
``scenario,acc@step,...,acc@total`` CSV lines, but scores + top-k run on
device. ``train`` replaces the reference's edit-the-script driver
(reference train.py) with a real subcommand over the typed config.

Usage:
  python -m topk_rec_tpu.cli evaluate -d data -m embed/bpr -f 0 -sl im om
  python -m topk_rec_tpu.cli train --model bpr -d data -o embed/bpr --k 50
  python -m topk_rec_tpu.cli fuse --strategy average -d data \
      -m embed/cer_meta embed/cer_tfidf -sl im
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import numpy as np

from .config import DataConfig, EvalConfig, ModelConfig, TrainConfig
from .data import Interactions, load_id_map, read_dat  # noqa: F401
from .eval import DeviceEvaluator
from .eval.protocol import load_test_likes
from .serving import METHODS, TopKServer
from .utils import tprint
from .utils.compile_cache import configure_compile_cache

# single source of defaults for the CLI flags (SURVEY §5: one typed config
# system feeding all entry points, vs the reference's four ad-hoc layers)
_MC = ModelConfig()
_TC = TrainConfig()
_EC = EvalConfig()


def _load_fold(data_dir: str, fold: int):
    uids = load_id_map(os.path.join(data_dir, "uid"))
    iids = load_id_map(os.path.join(data_dir, "vid"))
    inter, _, _ = Interactions.from_files(
        os.path.join(data_dir, "uid"),
        os.path.join(data_dir, "vid"),
        os.path.join(data_dir, f"f{fold}tr.txt"),
    )
    return inter, uids, iids


def _scenario_inputs(data_dir: str, fold: int, scenario: str, uids, iids):
    idl = os.path.join(data_dir, f"f{fold}te.{scenario}.idl")
    txt = os.path.join(data_dir, f"f{fold}te.{scenario}.txt")
    cand_map = load_id_map(idl)
    cand_ids = np.empty(len(cand_map), dtype=np.int64)
    for cid, pos in cand_map.items():
        cand_ids[pos] = iids[cid]
    likes = load_test_likes(txt, uids, cand_map)
    return cand_ids, likes


def _fail(msg: str) -> "SystemExit":
    """Friendly CLI error: message on stderr, exit code 2, no traceback
    (the reference CLI is the product surface this replaces; a missing
    model dir must not dump a read_dat stack)."""
    print(f"error: {msg}", file=sys.stderr)
    return SystemExit(2)


def _read_model_mat(mdir: str, name: str, ids) -> np.ndarray:
    path = os.path.join(mdir, name)
    if not os.path.isdir(mdir):
        raise _fail(
            f"model directory {mdir!r} does not exist — expected a "
            f"directory holding final-U.dat / final-V.dat "
            f"(train + export first)"
        )
    if not os.path.exists(path):
        raise _fail(
            f"{path!r} not found — the model directory must contain "
            f"final-U.dat and final-V.dat (optional final-B.dat)"
        )
    try:
        return read_dat(path, ids)
    except ValueError as e:
        raise _fail(str(e))


def cmd_evaluate(args) -> int:
    # TKR_TIMING=1: per-phase wall times on stderr (fixed-cost tracking)
    timing = os.environ.get("TKR_TIMING") == "1"
    import time as _time

    marks = [("start", _time.time())]

    def mark(name):
        if timing:
            marks.append((name, _time.time()))

    inter, uids, iids = _load_fold(args.data, args.fold)
    mark("fold_parse")
    umat = _read_model_mat(args.model, "final-U.dat", uids)
    vmat = _read_model_mat(args.model, "final-V.dat", iids)
    bpath = os.path.join(args.model, "final-B.dat")
    bmat = (
        _read_model_mat(args.model, "final-B.dat", iids)
        if os.path.exists(bpath)
        else None
    )
    mark("dat_parse")
    ev = DeviceEvaluator(
        inter.seen_bitmap, step=args.step, total=args.total,
        user_chunk=args.user_chunk,
        want_rr=False,  # CSV prints accuracy only (ref evaluate.py:113-117)
    )
    for scenario in args.scenarios:
        cand_ids, likes = _scenario_inputs(
            args.data, args.fold, scenario, uids, iids
        )
        mark(f"{scenario}_inputs")
        res = ev.evaluate(umat, vmat, bmat, cand_ids, likes)
        mark(f"{scenario}_eval")
        line = scenario + "".join(",%.6f" % a for a in res.accuracy)
        print(line)
    if timing:
        prev = marks[0][1]
        for name, t in marks[1:]:
            print(f"timing: {name} {t - prev:.2f}s", file=sys.stderr)
            prev = t
        print(f"timing: total {prev - marks[0][1]:.2f}s", file=sys.stderr)
    return 0


def build_model(mc: ModelConfig, mesh=None):
    """Instantiate a model from its typed config."""
    from .models import BPR, CER, DPM, VBPR, WMF

    name = mc.model
    if name == "bpr":
        return BPR(
            k=mc.k, lambda_u=mc.lambda_u, lambda_i=mc.lambda_i,
            lambda_j=mc.lambda_j, lambda_b=mc.lambda_b, lr=mc.lr,
            mode=mc.mode, seed=mc.seed, membership=mc.membership,
        )
    if name == "vbpr":
        return VBPR(
            k=mc.k, d=mc.d, lambda_u=mc.lambda_u,
            lambda_i=mc.lambda_i, lambda_j=mc.lambda_j,
            lambda_b=mc.lambda_b, lambda_e=mc.lambda_e, lr=mc.lr,
            mode=mc.mode, seed=mc.seed, membership=mc.membership,
        )
    if name == "wmf":
        return WMF(
            k=mc.k, lu=mc.als_lu, lv=mc.als_lv, a=mc.als_a,
            b=mc.als_b, seed=mc.seed, mesh=mesh,
        )
    if name == "cer":
        return CER(
            k=mc.k, d=mc.d, lu=mc.als_lu, lv=mc.als_lv,
            le=mc.als_le, a=mc.als_a, b=mc.als_b, seed=mc.seed, mesh=mesh,
        )
    if name == "dpm":
        return DPM(
            k=mc.k, d=mc.d, lu=mc.als_lu, lv=mc.als_lv,
            le=mc.als_le, a=mc.als_a, b=mc.als_b, seed=mc.seed, mesh=mesh,
        )
    raise SystemExit(f"unknown model {name!r}")


def _parse_mesh(spec: str):
    """Build a device mesh from a CLI spec: "auto" or "DPxMP" (e.g. 2x4)."""
    from .parallel import make_mesh

    if spec == "auto":
        return make_mesh()
    dp, _, mp = spec.partition("x")
    return make_mesh(dp=int(dp), mp=int(mp))


def _train_pairwise_distributed(model, mesh, cfg: TrainConfig):
    """Epoch loop for BPR/VBPR over a mesh via the distributed trainers
    (tables row-sharded over "mp", batches over "dp")."""
    import time

    import jax

    from .parallel import DistributedBPRTrainer, DistributedVBPRTrainer

    if cfg.warm_start is not None:
        tprint("Initialize weights with the previous trained model")
        model.import_embeddings(cfg.warm_start)
    limit = cfg.epoch_sample_limit or model.inter.nnz
    batch_limit = int(limit) // cfg.batch_size + 1
    scan_steps = min(64, batch_limit)
    n_chunks = max(1, -(-batch_limit // scan_steps))
    is_vbpr = type(model).__name__ == "VBPR"
    cls = DistributedVBPRTrainer if is_vbpr else DistributedBPRTrainer
    extra = {} if is_vbpr else {"exchange": cfg.exchange}
    trainer = cls(
        model, mesh, batch_size=cfg.batch_size, scan_steps=scan_steps,
        **extra,
    )
    key = jax.random.PRNGKey(model.seed)
    for eid in range(cfg.epochs):
        t0 = time.time()
        total = 0.0
        for _ in range(n_chunks):
            key, sub = jax.random.split(key)
            total += trainer.train_chunk(sub)
        tprint(
            "Epoch %3d, loss %.4f, time %.3fs (mesh %s)"
            % (eid + 1, total, time.time() - t0,
               dict(zip(mesh.axis_names, mesh.devices.shape)))
        )
    trainer.sync_to_model()


def train_from_config(cfg: TrainConfig, mesh=None):
    """Library-level training driver over the typed config (used by the
    CLI and scripts; replaces the reference's edit-the-script train.py).
    Returns the trained model after exporting embeddings."""
    from .utils.profiling import profile_trace

    mc = cfg.model
    if cfg.theta_init and mc.model != "wmf":
        # cer/dpm derive their item prior internally (F·E / encoder
        # output) — a user-supplied theta would be silently ignored;
        # the reference only threads --theta_init into the cr binary
        # from its own outer loops (old/methods/cer_train.py:72-76).
        raise SystemExit(
            f"--theta-init is only consumed by --model wmf "
            f"(got --model {mc.model})"
        )
    if cfg.exchange == "explicit" and mc.model != "bpr":
        raise SystemExit(
            "--exchange explicit is implemented for --model bpr "
            "(the other distributed paths ride GSPMD collectives)"
        )
    if cfg.exchange == "explicit" and mesh is None:
        # without a mesh the single-chip path runs and cfg.exchange is
        # never read — reject rather than silently train the wrong path
        raise SystemExit(
            "--exchange explicit requires --mesh (the all-to-all "
            "exchange runs over a device mesh)"
        )
    if cfg.exchange == "explicit" and mesh is not None:
        axes = dict(zip(mesh.axis_names, mesh.devices.shape))
        if int(axes.get("dp", 1)) != 1:
            raise SystemExit(
                "--exchange explicit shards the batch over 'mp' and "
                f"requires a pure-mp mesh (dp=1); got mesh axes {axes}"
            )
    model = build_model(mc, mesh=mesh)
    model.load_training_data(
        os.path.join(cfg.data.data_dir, cfg.data.uid_file),
        os.path.join(cfg.data.data_dir, cfg.data.iid_file),
        os.path.join(cfg.data.data_dir, cfg.data.train_file),
    )
    if mc.model in ("vbpr", "cer", "dpm"):
        if not cfg.data.content_file:
            raise SystemExit(f"--content is required for {mc.model}")
        model.load_content_data(
            os.path.join(cfg.data.data_dir, cfg.data.content_file),
            os.path.join(cfg.data.data_dir, cfg.data.iid_file),
        )
    save_dir = cfg.out_dir if cfg.save_lag else None
    with profile_trace(cfg.profile_dir):
        if mc.model in ("bpr", "vbpr"):
            if mesh is not None:
                _train_pairwise_distributed(model, mesh, cfg)
            else:
                model.train(
                    epochs=cfg.epochs,
                    batch_size=cfg.batch_size,
                    epoch_sample_limit=cfg.epoch_sample_limit,
                    model_path=cfg.warm_start,
                    ckpt_dir=cfg.ckpt_dir,
                    ckpt_every=cfg.ckpt_every,
                )
        elif mc.model == "dpm":
            from .models import MLPEncoder, SDAEEncoder

            enc_cls = {"mlp": MLPEncoder, "sdae": SDAEEncoder}.get(cfg.encoder)
            if enc_cls is None:
                raise SystemExit(f"unknown encoder {cfg.encoder!r}")
            enc = enc_cls(
                mc.k, model.d, hidden_layers=tuple(cfg.encoder_hidden),
                seed=mc.seed, mesh=mesh,
            )
            model.train(
                enc, max_iter=cfg.max_iter, model_path=cfg.warm_start,
                log_dir=cfg.log_dir, save_lag=cfg.save_lag,
                save_dir=save_dir,
            )
        else:
            extra = {}
            if mc.model == "wmf" and cfg.theta_init:
                # reference cr --theta_init (old/cr/main.cpp:33): a raw
                # row-major [n_items, k] matrix in item-index order, as
                # written by the legacy outer loops (final.gamma,
                # old/methods/cer_train.py:72-75); read like cr.cpp:24-40.
                from .data.io import read_dat

                extra["theta"] = read_dat(cfg.theta_init)
            model.train(
                max_iter=cfg.max_iter, tol=cfg.tol,
                model_path=cfg.warm_start, log_dir=cfg.log_dir,
                save_lag=cfg.save_lag, save_dir=save_dir,
                **extra,
            )
    model.export_embeddings(cfg.out_dir)
    tprint(f"Exported embeddings to {cfg.out_dir}")
    return model


def cmd_train(args) -> int:
    cfg = TrainConfig(
        data=DataConfig(
            data_dir=args.data,
            fold=args.fold,
            content_file=args.content,
        ),
        model=ModelConfig(
            model=args.model_name, k=args.k, d=args.d,
            lambda_u=args.lambda_u, lambda_i=args.lambda_i,
            lambda_j=args.lambda_j, lambda_b=args.lambda_b,
            lambda_e=args.lambda_e, lr=args.lr, mode=args.mode,
            als_lu=args.als_lu,
            als_lv=args.als_lv_wmf if args.model_name == "wmf" else args.als_lv,
            als_le=args.als_le, als_a=args.als_a, als_b=args.als_b,
            seed=args.seed, membership=args.membership,
        ),
        out_dir=args.out,
        epochs=args.epochs,
        batch_size=args.batch_size,
        epoch_sample_limit=args.epoch_sample_limit,
        max_iter=args.max_iter,
        tol=args.tol,
        warm_start=args.warm_start,
        encoder=args.encoder,
        encoder_hidden=list(args.encoder_hidden),
        log_dir=args.log_dir,
        profile_dir=args.profile_dir,
        save_lag=args.save_lag,
        theta_init=args.theta_init,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        exchange=args.exchange,
    )
    if args.coordinator or os.environ.get("TKR_COORDINATOR"):
        # multi-host: join the coordination service before any backend use
        from .parallel import initialize

        initialize(args.coordinator, args.num_processes, args.process_id)
    mesh = _parse_mesh(args.mesh) if args.mesh else None
    train_from_config(cfg, mesh=mesh)
    return 0


def cmd_fuse(args) -> int:
    from .fusion import (
        ModalityScores,
        average_weights,
        bpr_fusion_weights,
        error_weights,
        evaluate_fused,
        rank_geometric_weights,
        svm_fusion_weights,
    )

    inter, uids, iids = _load_fold(args.data, args.fold)
    embeddings = []
    for mdir in args.models:
        U = _read_model_mat(mdir, "final-U.dat", uids)
        V = _read_model_mat(mdir, "final-V.dat", iids)
        embeddings.append((U, V))
    modalities = ModalityScores(embeddings)
    F = len(embeddings)

    if args.strategy == "average":
        weights = average_weights(F)
    elif args.strategy == "rank":
        if args.p_sweep:
            # reference pfusion sweeps p in {0.1..0.9} and reports each
            # (ref old/methods/pfusion.py:113)
            from .ops.mask import pack_candidate_bitmap

            # pack each scenario's seen bitmap ONCE across the 9 p values
            scen_inputs = {}
            for scenario in args.scenarios:
                cand_ids, likes = _scenario_inputs(
                    args.data, args.fold, scenario, uids, iids
                )
                packed = pack_candidate_bitmap(inter.seen_bitmap, cand_ids)
                scen_inputs[scenario] = (cand_ids, likes, packed)
            for p_val in [round(0.1 * i, 1) for i in range(1, 10)]:
                weights = rank_geometric_weights(F, p_val)
                for scenario in args.scenarios:
                    cand_ids, likes, packed = scen_inputs[scenario]
                    res = evaluate_fused(
                        modalities, weights, inter.seen_bitmap, cand_ids,
                        likes, step=args.step, total=args.total,
                        packed_seen=packed,
                    )
                    line = f"rank-p{p_val}-{scenario}" + "".join(
                        ",%.6f" % a for a in res.accuracy
                    )
                    print(line)
            return 0
        weights = rank_geometric_weights(F, args.p)
    elif args.strategy == "error":
        tr_cand = np.arange(inter.n_items)
        weights = error_weights(modalities, inter, tr_cand)
    elif args.strategy == "svm":
        weights = svm_fusion_weights(
            modalities, inter,
            n_samples=args.n_samples if args.n_samples is not None
            else 100_000,
            seed=args.seed,
        )
    elif args.strategy == "bpr":
        weights = bpr_fusion_weights(
            modalities, inter,
            n_samples=args.n_samples if args.n_samples is not None
            else 10_000_000,
            seed=args.seed,
        )
    else:
        raise SystemExit(f"unknown strategy {args.strategy!r}")

    for scenario in args.scenarios:
        cand_ids, likes = _scenario_inputs(
            args.data, args.fold, scenario, uids, iids
        )
        res = evaluate_fused(
            modalities, weights, inter.seen_bitmap, cand_ids, likes,
            step=args.step, total=args.total,
        )
        line = f"{args.strategy}-{scenario}" + "".join(
            ",%.6f" % a for a in res.accuracy
        )
        print(line)
    return 0


def cmd_recommend(args) -> int:
    """Online-serving surface: top-k unseen items for the given users.

    Loads the exported embeddings + the fold's train history (for seen
    exclusion) into a TopKServer and prints one CSV line per requested
    user: ``user_id,item_id:score,...``. Users can come from the command
    line (original string ids) or one-per-line from ``--users-file``.
    The reference has no serving path at all — its closest analog is
    re-running the offline evaluate.py batch job.
    """
    inter, uids, iids = _load_fold(args.data, args.fold)
    umat = _read_model_mat(args.model, "final-U.dat", uids)
    vmat = _read_model_mat(args.model, "final-V.dat", iids)
    bpath = os.path.join(args.model, "final-B.dat")
    bmat = (
        _read_model_mat(args.model, "final-B.dat", iids).reshape(-1)
        if os.path.exists(bpath)
        else None
    )
    raw_users = list(args.users or [])
    if args.users_file:
        with open(args.users_file) as f:
            raw_users += [ln.strip() for ln in f if ln.strip()]
    if not raw_users:
        raise _fail("no users given — pass ids as arguments or --users-file")
    missing = [u for u in raw_users if u not in uids]
    if missing:
        raise _fail(
            f"unknown user id(s): {', '.join(missing[:5])}"
            + (" ..." if len(missing) > 5 else "")
        )
    inv_items = {v: k for k, v in iids.items()}
    srv = TopKServer(
        umat, vmat, bmat, inter, exclude_seen=not args.include_seen
    )
    idx = np.array([uids[u] for u in raw_users], dtype=np.int32)
    vals, items = srv.recommend(idx, k=args.k, method=args.method)
    for row, u in enumerate(raw_users):
        cells = [
            f"{inv_items[int(i)]}:{float(v):.6f}"
            for v, i in zip(vals[row], items[row])
            if np.isfinite(v)
        ]
        print(u + "," + ",".join(cells))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="topk_rec_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    pe = sub.add_parser("evaluate", help="evaluate exported .dat embeddings")
    pe.add_argument("-d", "--data", required=True)
    pe.add_argument("-m", "--model", required=True)
    pe.add_argument("-f", "--fold", type=int, default=_EC.fold)
    pe.add_argument("-s", "--step", type=int, default=_EC.step)
    pe.add_argument("-t", "--total", type=int, default=_EC.total)
    pe.add_argument("-sl", "--scenarios", nargs="+", default=_EC.scenarios)
    pe.add_argument("--user-chunk", type=int, default=_EC.user_chunk)
    pe.set_defaults(func=cmd_evaluate)

    pt = sub.add_parser("train", help="train a model and export embeddings")
    pt.add_argument("--model", dest="model_name", required=True,
                    choices=["bpr", "vbpr", "wmf", "cer", "dpm"])
    pt.add_argument("-d", "--data", required=True)
    pt.add_argument("-o", "--out", required=True)
    pt.add_argument("-f", "--fold", type=int, default=0)
    pt.add_argument("--content", default=None, help="content pickle filename")
    pt.add_argument("--k", type=int, default=_MC.k)
    pt.add_argument("--d", type=int, default=_MC.d)
    pt.add_argument("--epochs", type=int, default=_TC.epochs)
    pt.add_argument("--batch-size", type=int, default=_TC.batch_size)
    pt.add_argument("--epoch-sample-limit", type=int,
                    default=_TC.epoch_sample_limit)
    pt.add_argument("--max-iter", type=int, default=_TC.max_iter)
    pt.add_argument("--tol", type=float, default=_TC.tol)
    pt.add_argument("--lr", type=float, default=_MC.lr)
    pt.add_argument("--mode", default=_MC.mode, choices=["l2", "l1"])
    pt.add_argument("--lambda-u", type=float, default=_MC.lambda_u)
    pt.add_argument("--lambda-i", type=float, default=_MC.lambda_i)
    pt.add_argument("--lambda-j", type=float, default=_MC.lambda_j)
    pt.add_argument("--lambda-b", type=float, default=_MC.lambda_b)
    pt.add_argument("--lambda-e", type=float, default=_MC.lambda_e)
    pt.add_argument("--als-lu", type=float, default=_MC.als_lu)
    pt.add_argument("--als-lv", type=float, default=_MC.als_lv)
    pt.add_argument("--als-lv-wmf", type=float, default=0.01,
                    help="WMF uses lv=0.01 (ref wmf.py:11) vs CER/DPM's 10")
    pt.add_argument("--als-le", type=float, default=_MC.als_le)
    pt.add_argument("--als-a", type=float, default=_MC.als_a)
    pt.add_argument("--als-b", type=float, default=_MC.als_b)
    pt.add_argument("--seed", type=int, default=_MC.seed)
    pt.add_argument(
        "--membership", default=_MC.membership,
        choices=["auto", "bitmap", "sorted"],
        help="negative-sampling membership store (auto switches to the "
             "catalog-size-independent sorted-CSR probe when the dense "
             "bitmap would exceed ~1 GiB)",
    )
    pt.add_argument("--warm-start", default=_TC.warm_start)
    pt.add_argument("--log-dir", default=_TC.log_dir,
                    help="write state.log/settings.txt here (ALS models)")
    pt.add_argument("--profile-dir", default=_TC.profile_dir,
                    help="capture a jax.profiler trace of training here")
    pt.add_argument("--ckpt-dir", default=_TC.ckpt_dir,
                    help="native crash-resume checkpoints (params + "
                         "optimizer state) every --ckpt-every epochs; "
                         "restarting the same command resumes")
    pt.add_argument("--ckpt-every", type=int, default=_TC.ckpt_every)
    pt.add_argument("--theta-init", default=_TC.theta_init,
                    help="item-prior .dat matrix ([n_items, k], item-index "
                         "order): inits V and enters every item solve as the "
                         "lv-weighted prior (reference cr --theta_init, "
                         "old/cr/main.cpp:33, cr.cpp:24-57); wmf only")
    pt.add_argument("--save-lag", type=int, default=_TC.save_lag,
                    help="dump %%04d-U/V.dat into -o every N ALS iterations "
                         "(reference cr --save_lag)")
    pt.add_argument("--encoder", default=_TC.encoder,
                    choices=["mlp", "sdae"],
                    help="DPM content encoder (sdae = CDL-style with "
                         "layer-wise denoising pretraining)")
    pt.add_argument("--encoder-hidden", type=int, nargs="+",
                    default=_TC.encoder_hidden)
    pt.add_argument("--mesh", default=None,
                    help='device mesh for distributed training: "auto" '
                         '(all devices) or "DPxMP" (e.g. 2x4); tables '
                         'row-shard over mp, batches over dp')
    pt.add_argument("--exchange", default=_TC.exchange,
                    choices=["gspmd", "explicit"],
                    help="distributed BPR communication: GSPMD-inserted "
                         "collectives or the explicit deduplicated "
                         "all-to-all lookup/update exchange "
                         "(parameter-server pattern; requires "
                         "a pure-mp mesh, e.g. --mesh 1x8)")
    pt.add_argument("--coordinator", default=None,
                    help="multi-host: coordination service address "
                         "host:port (jax.distributed)")
    pt.add_argument("--num-processes", type=int, default=None)
    pt.add_argument("--process-id", type=int, default=None)
    pt.set_defaults(func=cmd_train)

    pf = sub.add_parser("fuse", help="late-fuse several model dirs")
    pf.add_argument("--strategy", required=True,
                    choices=["average", "rank", "error", "svm", "bpr"])
    pf.add_argument("-d", "--data", required=True)
    pf.add_argument("-m", "--models", nargs="+", required=True)
    pf.add_argument("-f", "--fold", type=int, default=0)
    pf.add_argument("-s", "--step", type=int, default=5)
    pf.add_argument("-t", "--total", type=int, default=30)
    pf.add_argument("-sl", "--scenarios", nargs="+", default=["im", "om"])
    pf.add_argument("--p", type=float, default=0.5, help="rank-fusion p")
    pf.add_argument("--p-sweep", action="store_true",
                    help="rank strategy: evaluate p in {0.1..0.9}, one CSV "
                         "line each (reference pfusion.py:113)")
    # None -> per-strategy parity default: svm 100k (sfusion-scale), bpr
    # 10M (ref ranking_fusion.py:44)
    pf.add_argument("--n-samples", type=int, default=None)
    pf.add_argument("--seed", type=int, default=0)
    pf.set_defaults(func=cmd_fuse)

    pr = sub.add_parser(
        "recommend", help="top-k unseen items for given users (serving)"
    )
    pr.add_argument("-d", "--data", required=True)
    pr.add_argument("-m", "--model", required=True)
    pr.add_argument("-f", "--fold", type=int, default=0)
    pr.add_argument("-k", type=int, default=30)
    pr.add_argument("--method", default="exact", choices=METHODS)
    pr.add_argument("--include-seen", action="store_true",
                    help="do not exclude train-seen items")
    pr.add_argument("--users-file", default=None,
                    help="file with one user id per line")
    pr.add_argument("users", nargs="*", help="user ids (as in the uid file)")
    pr.set_defaults(func=cmd_recommend)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    configure_compile_cache()
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
