"""Evaluation-protocol tests: oracle exactness + device == oracle."""

import numpy as np
import pytest

from topk_rec_tpu.eval import evaluate_oracle, evaluate_scores_device
from topk_rec_tpu.eval.device import DeviceEvaluator


def test_oracle_hand_computed():
    # 2 users, 5 candidates, step=1 total=3 (interval 3).
    scores = np.array(
        [
            [5.0, 4.0, 3.0, 2.0, 1.0],   # user 0 ranks: 0,1,2,3,4
            [1.0, 2.0, 3.0, 4.0, 5.0],   # user 1 ranks: 4,3,2,1,0
        ],
        dtype=np.float32,
    )
    seen = np.zeros((2, 5), dtype=bool)
    seen[0, 0] = True  # user 0's best-scored item was browsed -> skipped
    likes = {0: [1, 3], 1: [4]}
    res = evaluate_oracle(scores, seen, likes, step=1, total=3)
    # user 0 unseen order: 1,2,3 -> like 1 at unseen-rank 0, like 3 at rank 2
    # user 1 unseen order: 4,3,2 -> like 4 at unseen-rank 0
    np.testing.assert_array_equal(res.hits, [2.0, 2.0, 3.0])
    assert res.count == 3
    np.testing.assert_allclose(res.accuracy, [2 / 3, 2 / 3, 1.0])
    # RR buckets by RAW rank with value 1/(t+1) (ref utils.py:116-119):
    # user0 item1 at t=1 -> bucket 1 value 1/2; item3 at t=3 -> bucket 3
    # >= interval, dropped; user1 item4 at t=0 -> bucket 0 value 1.
    np.testing.assert_allclose(res.rr, [1.0, 1.0 + 1 / 2, 1.0 + 1 / 2])


def test_oracle_total_cutoff():
    # Like sits beyond the `total` unseen cutoff -> never counted.
    scores = np.array([[5.0, 4.0, 3.0, 2.0]], dtype=np.float32)
    likes = {0: [3]}
    seen = np.zeros((1, 4), dtype=bool)
    res = evaluate_oracle(scores, seen, likes, step=1, total=2)
    np.testing.assert_array_equal(res.hits, [0.0, 0.0])
    res = evaluate_oracle(scores, seen, likes, step=1, total=4)
    np.testing.assert_array_equal(res.hits, [0, 0, 0, 1])


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("step,total", [(5, 30), (3, 9)])
def test_device_matches_oracle(seed, step, total):
    rng = np.random.default_rng(seed)
    n_users, n_items, dim = 60, 90, 8
    n_cand = 40
    U = rng.normal(size=(n_users, dim)).astype(np.float32)
    V = rng.normal(size=(n_items, dim)).astype(np.float32)
    bias = rng.normal(size=n_items).astype(np.float32)
    cand_ids = rng.choice(n_items, size=n_cand, replace=False).astype(np.int64)

    # random seen bitmap over the full item space
    n_words = (n_items + 31) // 32
    seen_bm = np.zeros((n_users, n_words), dtype=np.uint32)
    seen_dense = rng.random((n_users, n_items)) < 0.3
    for u, i in zip(*np.nonzero(seen_dense)):
        seen_bm[u, i >> 5] |= np.uint32(1) << np.uint32(i & 31)

    likes = {}
    for u in range(0, n_users, 2):
        likes[u] = list(rng.choice(n_cand, size=rng.integers(1, 5), replace=False))
    likes[2] = []  # user with empty like list is skipped

    V_cand = V[cand_ids]
    b_cand = bias[cand_ids]
    scores = U @ V_cand.T + b_cand[None, :]
    seen_cand = seen_dense[:, cand_ids]

    oracle = evaluate_oracle(scores, seen_cand, likes, step=step, total=total)
    dev = evaluate_scores_device(
        U, V_cand, b_cand, seen_bm, cand_ids, likes,
        step=step, total=total, user_chunk=17,
    )
    np.testing.assert_array_equal(dev.hits, oracle.hits)
    assert dev.count == oracle.count
    np.testing.assert_allclose(dev.accuracy, oracle.accuracy)
    # reciprocal-rank parity: device reconstructs the reference's raw-rank
    # semantics (utils.py:116-119) via the seen-above counts
    np.testing.assert_allclose(dev.rr, oracle.rr, rtol=1e-6)


def test_device_evaluator_wrapper():
    rng = np.random.default_rng(3)
    n_users, n_items, dim = 20, 30, 4
    U = rng.normal(size=(n_users, dim)).astype(np.float32)
    V = rng.normal(size=(n_items, dim)).astype(np.float32)
    seen_bm = np.zeros((n_users, 1), dtype=np.uint32)
    cand = np.arange(10, 20)
    likes = {u: [int(rng.integers(0, 10))] for u in range(n_users)}
    ev = DeviceEvaluator(seen_bm, step=2, total=6)
    res = ev.evaluate(U, V, None, cand, likes)
    scores = U @ V[cand].T
    oracle = evaluate_oracle(
        scores, np.zeros((n_users, 10), bool), likes, step=2, total=6
    )
    np.testing.assert_array_equal(res.hits, oracle.hits)


def test_device_no_bias_matches_with_zero_bias():
    rng = np.random.default_rng(5)
    U = rng.normal(size=(8, 4)).astype(np.float32)
    V_cand = rng.normal(size=(12, 4)).astype(np.float32)
    seen_bm = np.zeros((8, 1), dtype=np.uint32)
    cand_ids = np.arange(12)
    likes = {u: [u % 12] for u in range(8)}
    a = evaluate_scores_device(U, V_cand, None, seen_bm, cand_ids, likes)
    b = evaluate_scores_device(
        U, V_cand, np.zeros(12, np.float32), seen_bm, cand_ids, likes
    )
    np.testing.assert_array_equal(a.hits, b.hits)


def test_want_rr_false_skips_rr_but_keeps_hits():
    rng = np.random.default_rng(7)
    U = rng.normal(size=(12, 4)).astype(np.float32)
    V_cand = rng.normal(size=(20, 4)).astype(np.float32)
    seen_bm = np.zeros((12, 1), dtype=np.uint32)
    cand_ids = np.arange(20)
    likes = {u: [u % 20] for u in range(12)}
    full = evaluate_scores_device(
        U, V_cand, None, seen_bm, cand_ids, likes
    )
    no_rr = evaluate_scores_device(
        U, V_cand, None, seen_bm, cand_ids, likes, want_rr=False
    )
    np.testing.assert_array_equal(no_rr.hits, full.hits)
    assert no_rr.count == full.count
    assert np.all(no_rr.rr == 0.0) and np.any(full.rr > 0.0)
