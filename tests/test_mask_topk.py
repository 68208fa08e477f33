"""Seen-mask packing and the exact masked top-k of the evaluator chunk and
``TopKServer(method="exact")``, checked against the ``eval/protocol.py``
walk (descending score, seen items skipped)."""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest

from topk_rec_tpu.data.dataset import Interactions
from topk_rec_tpu.eval.device import _count_hits, _score_topk_chunk
from topk_rec_tpu.eval.protocol import evaluate_oracle
from topk_rec_tpu.ops.mask import expand_seen_mask, pack_candidate_bitmap
from topk_rec_tpu.serving import TopKServer


def _bitmap(dense):
    n_users, n_items = dense.shape
    bm = np.zeros((n_users, (n_items + 31) // 32), dtype=np.uint32)
    for u, i in zip(*np.nonzero(dense)):
        bm[u, i >> 5] |= np.uint32(1) << np.uint32(i & 31)
    return bm


def test_mask_roundtrip():
    rng = np.random.default_rng(2)
    n_users, n_items = 40, 100
    dense = (rng.random((n_users, n_items)) < 0.3).astype(np.uint32)
    bm = _bitmap(dense)
    cand = rng.choice(n_items, size=37, replace=False)
    packed = pack_candidate_bitmap(bm, cand)
    expanded = np.asarray(expand_seen_mask(jnp.asarray(packed), 37))
    np.testing.assert_array_equal(expanded, dense[:, cand].astype(np.int8))


@pytest.mark.parametrize("n_cand", [1, 31, 33, 63, 101])
def test_pack_expand_roundtrip_ragged_words(n_cand):
    """Candidate counts that leave a partial last word: the padding bits
    stay zero and never leak into the expanded mask."""
    rng = np.random.default_rng(n_cand)
    n_users, n_items = 9, 150
    dense = rng.random((n_users, n_items)) < 0.4
    cand = rng.permutation(n_items)[:n_cand]
    packed = pack_candidate_bitmap(_bitmap(dense), cand)
    assert packed.shape == (n_users, (n_cand + 31) // 32)
    if n_cand % 32:
        assert not (packed[:, -1] >> np.uint32(n_cand % 32)).any()
    expanded = np.asarray(expand_seen_mask(jnp.asarray(packed), n_cand))
    assert expanded.shape == (n_users, n_cand)
    np.testing.assert_array_equal(expanded, dense[:, cand].astype(np.int8))


def _case(name):
    """(U, V, bias or None, seen [n_u, n_i] bool, k) for one named case."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))

    def rand(n_u, n_i, d, density, with_bias):
        U = rng.normal(size=(n_u, d)).astype(np.float32)
        V = rng.normal(size=(n_i, d)).astype(np.float32)
        b = rng.normal(size=n_i).astype(np.float32) if with_bias else None
        return U, V, b, rng.random((n_u, n_i)) < density

    if name == "random_small":
        return (*rand(64, 96, 16, 0.2, True), 8)
    if name == "random_large":
        return (*rand(130, 300, 20, 0.2, True), 30)
    if name == "few_unseen_no_bias":
        U, V, _, seen = rand(8, 10, 4, 0.0, False)
        seen[0, :] = True
        seen[0, 3] = False  # user 0 has exactly one unseen item
        return U, V, None, seen, 5
    if name == "all_ties":
        return (np.ones((16, 2), np.float32), np.ones((384, 2), np.float32),
                None, np.zeros((16, 384), bool), 6)
    if name == "planted_cluster":
        V = np.full((384, 1), -5.0, np.float32)
        V[5, 0], V[133, 0], V[261, 0], V[7, 0] = 100.0, 99.0, 98.0, 50.0
        return (np.ones((8, 1), np.float32), V, None,
                np.zeros((8, 384), bool), 4)
    if name == "duplicate_rows":
        U, V, b, seen = rand(48, 1500, 12, 0.1, True)
        V[700] = V[1300] = V[10]  # exact ties far apart in the catalog
        b[700] = b[1300] = b[10]
        return U, V, b, seen, 16
    if name == "wide_catalog":
        return (*rand(12, 12_300, 8, 0.05, True), 16)
    if name == "padding_never_returned":
        U, V, _, seen = rand(32, 400, 8, 0.0, False)
        # every real score is strictly negative: a leaked zero-score
        # padding column would win
        return U, V, np.full(400, -100.0, np.float32), seen, 10
    if name == "k64":
        return (*rand(32, 768, 8, 0.1, False), 64)
    raise KeyError(name)


CASES = [
    "random_small", "random_large", "few_unseen_no_bias", "all_ties",
    "planted_cluster", "duplicate_rows", "wide_catalog",
    "padding_never_returned", "k64",
]


def _protocol_walk(scores, seen, k):
    """The protocol's order: descending score (ties by item index, as
    lax.top_k breaks them), seen items skipped, first ``k`` kept; rows
    with fewer than k unseen items end in -inf."""
    n_u = scores.shape[0]
    idx = np.zeros((n_u, k), np.int64)
    vals = np.full((n_u, k), -np.inf)
    for u in range(n_u):
        order = [i for i in np.argsort(-scores[u], kind="stable")
                 if not seen[u, i]][:k]
        idx[u, : len(order)] = order
        vals[u, : len(order)] = scores[u, order]
    return vals, idx


def _run(target, U, V, b, seen, k):
    n_u, n_i = seen.shape
    if target == "chunk":
        vals, idx = _score_topk_chunk(
            jnp.asarray(U), jnp.asarray(V),
            None if b is None else jnp.asarray(b),
            jnp.asarray(_bitmap(seen)), n_i, k,
        )
        return np.asarray(vals), np.asarray(idx)
    su, si = np.nonzero(seen)
    inter = Interactions(
        n_u, n_i, su.astype(np.int32), si.astype(np.int32),
    )
    srv = TopKServer(U, V, b, inter)
    return srv.recommend(np.arange(n_u), k=k, method="exact")


@pytest.mark.parametrize("target", ["chunk", "server"])
@pytest.mark.parametrize("name", CASES)
def test_exact_topk_matches_protocol(name, target):
    U, V, b, seen, k = _case(name)
    scores = U.astype(np.float64) @ V.astype(np.float64).T
    if b is not None:
        scores += b.astype(np.float64)[None, :]
    want_vals, want_idx = _protocol_walk(scores, seen, k)
    vals, idx = _run(target, U, V, b, seen, k)
    assert vals.shape == idx.shape == (U.shape[0], k)
    finite = np.isfinite(want_vals)
    np.testing.assert_array_equal(np.isfinite(vals), finite)
    np.testing.assert_allclose(vals[finite], want_vals[finite], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(np.where(finite, idx, -1),
                                  np.where(finite, want_idx, -1))
    assert idx[finite].max() < V.shape[0]
    # hit counts of the protocol oracle equal those of the device lists
    rng = np.random.default_rng(0)
    likes = {u: list(rng.choice(V.shape[0], size=3, replace=False))
             for u in range(0, U.shape[0], 2)}
    total = k - k % 2 if k > 1 else 1
    step = max(1, total // 2)
    want = evaluate_oracle(scores, seen, likes, step=step, total=total)
    if name not in ("all_ties", "duplicate_rows"):  # argsort's tie order
        got = _count_hits(idx[:, :total], vals[:, :total], None, likes,
                          V.shape[0], step, total)
        np.testing.assert_array_equal(got.hits, want.hits)


@pytest.mark.chip
def test_evaluator_chunk_matches_float64_on_gpu():
    """On the card the evaluator's HIGHEST-precision score matmul is fp32,
    not TF32: at MovieLens catalog width its top-30 equals the float64
    protocol walk (TF32 rounding would reorder near-ties)."""
    rng = np.random.default_rng(7)
    U = rng.normal(size=(512, 50)).astype(np.float32)
    V = rng.normal(size=(10_380, 50)).astype(np.float32)
    seen = rng.random((512, 10_380)) < 0.02
    scores = U.astype(np.float64) @ V.astype(np.float64).T
    want_vals, want_idx = _protocol_walk(scores, seen, 30)
    vals, idx = _run("chunk", U, V, None, seen, 30)
    np.testing.assert_allclose(vals, want_vals, rtol=1e-5)
    assert (idx == want_idx).mean() > 0.999
