"""chip_smoke.py: refuses to run without a GPU; its fold generator and
comparison functions hold at a tiny size."""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

from topk_rec_tpu.cli import main as cli_main
from topk_rec_tpu.data.dataset import Interactions
from topk_rec_tpu.data.io import load_id_map, write_dat

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_ARGS = dict(n_users=210, n_items=120, n_seen=2500, n_im=96, k=6, d=40,
                 feat_nnz=5, serve_batch=16, topk=8)


def _load():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py")
    )
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # dataclasses resolve the module by name
    spec.loader.exec_module(mod)
    return mod


cs = _load()
TINY = cs.Shape(**TINY_ARGS)


@pytest.fixture(scope="module")
def fold(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("smoke_fold"))
    stats = cs.make_fold(root, TINY, seed=3)
    return root, stats


def test_refuses_to_run_on_cpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
         "--work", str(tmp_path / "w")],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs an NVIDIA GPU" in r.stderr
    assert not (tmp_path / "w").exists()  # no phase ran


def test_make_fold_reference_formats(fold):
    root, stats = fold
    for name in ("uid", "vid", "f0tr.txt", "f0te.im.idl", "f0te.im.txt",
                 "f0te.om.idl", "f0te.om.txt", "meta.pkl"):
        assert os.path.exists(os.path.join(root, name)), name
    uids = load_id_map(os.path.join(root, "uid"))
    iids = load_id_map(os.path.join(root, "vid"))
    assert len(uids) == TINY.n_users and len(iids) == TINY.n_items
    # string ids are never their own indices
    assert all(name != str(idx) for name, idx in {**uids, **iids}.items())
    inter, _, _ = Interactions.from_files(
        os.path.join(root, "uid"), os.path.join(root, "vid"),
        os.path.join(root, "f0tr.txt"),
    )
    assert inter.seen_u.size == stats["n_seen"] == TINY.n_seen
    assert inter.nnz == stats["n_pos"] < stats["n_seen"]
    om = [iids[v] for v in load_id_map(os.path.join(root, "f0te.om.idl"))]
    im = [iids[v] for v in load_id_map(os.path.join(root, "f0te.im.idl"))]
    assert len(im) == TINY.n_im and len(om) == TINY.n_items - TINY.n_im
    assert not np.isin(om, inter.seen_i).any()  # cold-start pool
    with open(os.path.join(root, "f0te.im.txt")) as f:
        for line in f:
            items = [t.partition(":")[0] for t in line.strip().split(",")[1:]]
            assert len(items) == len(set(items)) == 3


def test_content_pickle_loads_at_width(fold):
    from topk_rec_tpu.data.io import load_features

    root, _ = fold
    feat = load_features(
        os.path.join(root, "meta.pkl"), os.path.join(root, "vid"),
        load_id_map(os.path.join(root, "vid")),
    )
    assert feat.shape == (TINY.n_items, TINY.d)
    assert ((feat != 0).sum(axis=1) <= TINY.feat_nnz).all()


def test_oracle_agrees_with_cli_evaluate(fold, tmp_path, capsys):
    root, _ = fold
    rng = np.random.default_rng(0)
    U = rng.normal(size=(TINY.n_users, TINY.k)).astype(np.float32)
    V = rng.normal(size=(TINY.n_items, TINY.k)).astype(np.float32)
    B = rng.normal(size=(TINY.n_items, 1)).astype(np.float32)
    for name, mat in (("U", U), ("V", V), ("B", B)):
        write_dat(str(tmp_path / f"final-{name}.dat"), mat)
    assert cli_main(["evaluate", "-d", root, "-m", str(tmp_path), "-f", "0",
                     "-sl", "im", "om"]) == 0
    out = capsys.readouterr().out.splitlines()
    from topk_rec_tpu.data.io import read_dat

    Ur, Vr, Br = (read_dat(str(tmp_path / f"final-{n}.dat"))
                  for n in "UVB")
    for scen in ("im", "om"):
        line = [l for l in out if l.startswith(scen + ",")][-1]
        acc, count = cs.oracle_accuracy(root, Ur, Vr, Br, scen)
        assert count > 0
        assert cs.compare_csv(line, acc, count) == (True, 0)


def test_compare_csv_counts_hit_differences():
    acc = np.array([0.1, 0.2])
    assert cs.compare_csv("im,0.100000,0.200000", acc, 50) == (True, 0)
    # one bucket off by 2 hits of 50
    assert cs.compare_csv("im,0.100000,0.240000", acc, 50) == (False, 2)


def test_check_served_tolerance():
    rng = np.random.default_rng(4)
    U = rng.normal(size=(10, 6)).astype(np.float32)
    V = rng.normal(size=(40, 6)).astype(np.float32)
    seen = rng.random((10, 40)) < 0.2
    users = np.arange(10)
    vals, items, scores, scale = cs.topk_reference(U, V, None, seen, users, 5)
    assert not seen[users[:, None], items].any()
    assert (np.diff(vals, axis=1) <= 0).all()
    ok, worst = cs.check_served(vals.astype(np.float32), items, scores,
                                vals, scale, 2e-3)
    assert ok and worst < 0.01
    # a served item from outside the top-k by more than the tolerance
    bad = items.copy()
    bad[:, -1] = np.argsort(np.where(seen, np.inf, scores), axis=1)[:, 0]
    ok, _ = cs.check_served(vals.astype(np.float32), bad, scores, vals,
                            scale, 2e-3)
    assert not ok
    ok, worst = cs.check_served(vals.astype(np.float32) + 1.0, items,
                                scores, vals, scale, 2e-3)
    assert not ok and worst > 1.0


def test_rel_diff():
    a = np.array([1.0, 2.0, 2.0])
    assert cs.rel_diff(a, a) == 0.0
    assert cs.rel_diff(a * 1.01, a) == pytest.approx(0.01)
