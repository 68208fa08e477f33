"""Trained-accuracy parity vs the reference's math, asserted in CI.

Scaled-down version of benchmarks/accuracy_parity.py (whose full 3-seed
run is in benchmarks/accuracy_parity_results*.json): train the reference-exact NumPy
trainers AND this framework's models on one synthetic structured fold,
evaluate BOTH through the untouched reference CLI, and assert the
accuracy@10/30 deltas stay within run-variance bounds. Slow-marked
(~40 s): deselect with ``-m "not slow"`` when iterating.
"""

import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "benchmarks"))

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def parity_fold(tmp_path_factory):
    from accuracy_parity import make_parity_fold

    root = str(tmp_path_factory.mktemp("parity"))
    return make_parity_fold(
        root, n_users=1200, n_items=400, n_om=60, top_t=20, d=120
    )


CFG = dict(k=24, bpr_epochs=3, bpr_limit=120_000, als_iters=60,
           cer_iters=12, tol=1e-4, verbose=False)


@pytest.mark.parametrize("model", ["bpr", "wmf", "cer"])
def test_trained_accuracy_matches_reference(parity_fold, model, tmp_path):
    from accuracy_parity import (
        MODEL_SCENARIOS,
        evaluate_reference_cli,
        train_side,
    )

    fold = parity_fold
    scen = MODEL_SCENARIOS[model]
    got = {}
    for side in ("ref", "ours"):
        mdir = str(tmp_path / f"{model}_{side}")
        train_side(model, side, fold, 0, mdir, CFG)
        got[side] = evaluate_reference_cli(fold["root"], mdir, scen)
    for s in scen:
        for metric in ("acc@10", "acc@30"):
            r = got["ref"][s][metric]
            o = got["ours"][s][metric]
            # single-seed bound: |Δ| within max(0.02 abs, 25% rel) —
            # the 3-seed full-scale run pins ±1σ deltas
            assert abs(o - r) <= max(0.02, 0.25 * r), (
                model, s, metric, r, o
            )
