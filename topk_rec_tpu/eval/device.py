"""On-device top-k evaluation: chunked U·Vᵀ scoring + masked top-k.

Device replacement for the reference CLI's hot path — the full
``np.argsort`` of a [n_users, n_cand] score matrix (reference
evaluate.py:81) becomes a streamed, jit-compiled matmul + seen-mask +
``lax.top_k`` over user chunks, so the full score matrix never leaves the
device (and never needs a full sort: only the first ``total`` unseen
candidates matter, see eval/protocol.py).

Per-user seen-item exclusion uses the packed training bitmap from
``data.dataset.Interactions.seen_bitmap``: one gathered uint32 word + shift
per (user, candidate) instead of a Python set probe (reference
evaluate.py:98).
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.mask import expand_seen_mask, pack_candidate_bitmap
from .protocol import EvalResult


@partial(jax.jit, static_argnames=("k", "n_cand"))
def _mask_topk(
    scores: jax.Array,        # [CU, n_cand]
    packed_seen: jax.Array,   # [CU, ceil(n_cand/32)] uint32, candidate space
    n_cand: int,
    k: int,
):
    # Dense bit expansion (repeat + shift) instead of a per-candidate
    # gather of bitmap words.
    seen = expand_seen_mask(packed_seen, n_cand)
    masked = jnp.where(seen != 0, -jnp.inf, scores)
    vals, idx = jax.lax.top_k(masked, k)
    return vals, idx


@partial(jax.jit, static_argnames=("n_cand",))
def _seen_above_from_scores(
    scores: jax.Array,       # [CU, n_cand] raw (unmasked) scores
    packed_seen: jax.Array,  # [CU, ceil(n_cand/32)] uint32
    idx: jax.Array,          # [CU, kk] returned unseen candidate indices
    n_cand: int,
) -> jax.Array:
    """Per returned candidate: # of SEEN candidates scoring strictly above.

    unseen-rank + this count = the raw rank ``t`` the reference walks
    (evaluate.py:95-97 counts seen rows too before skipping them), which
    the reciprocal-rank metric needs (utils.py:116-119 uses ``t`` for both
    bucket and value). Sort-then-searchsorted keeps it O(n log n) per row
    instead of kk full-row comparisons.
    """
    seen = expand_seen_mask(packed_seen, n_cand) != 0
    vals = jnp.take_along_axis(scores, idx, axis=1)
    ss = jnp.sort(jnp.where(seen, scores, -jnp.inf), axis=1)
    pos = jax.vmap(lambda a, v: jnp.searchsorted(a, v, side="right"))(ss, vals)
    return (n_cand - pos).astype(jnp.int32)


@partial(jax.jit, static_argnames=("n_cand",))
def _raw_rank_scores(u_emb, v_cand, bias, packed_seen, idx, n_cand):
    scores = jnp.dot(
        u_emb, v_cand.T, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    if bias is not None:
        scores = scores + bias[None, :]
    return _seen_above_from_scores(scores, packed_seen, idx, n_cand)


@partial(jax.jit, static_argnames=("k", "n_cand"))
def _score_topk_chunk(
    u_emb: jax.Array,        # [CU, k_dim]
    v_cand: jax.Array,       # [n_cand, k_dim]
    bias: Optional[jax.Array],   # [n_cand] or None
    packed_seen: jax.Array,
    n_cand: int,
    k: int,
):
    # full-fp32 matmul: the protocol path ranks by exact scores. DEFAULT
    # precision may round the inputs (TF32 on the GPU), which flips
    # near-tied rankings at catalog scale — the serving path may trade
    # this off (serving.py), the eval path must not.
    scores = jnp.dot(
        u_emb, v_cand.T, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    if bias is not None:
        scores = scores + bias[None, :]
    return _mask_topk(scores, packed_seen, n_cand, k)


def topk_unseen(
    U: np.ndarray,
    V_cand: np.ndarray,
    bias: Optional[np.ndarray],
    seen_bitmap: np.ndarray,
    cand_item_ids: np.ndarray,
    k: int,
    user_chunk: int = 8192,
    want_raw_rank: bool = False,
):
    """Top-k *unseen* candidates per user, in descending score order.

    Args:
      U: [n_users, dim] user embeddings.
      V_cand: [n_cand, dim] candidate item embeddings (rows in candidate
        order, ref evaluate.py:75-77).
      bias: optional [n_cand] item bias (ref evaluate.py:79-80).
      seen_bitmap: uint32 [n_users, ceil(n_items/32)] browsed-item bits.
      cand_item_ids: [n_cand] global item index of each candidate.
      k: how many unseen candidates to keep (== ``total`` of the protocol).
      want_raw_rank: also return per-slot seen-above counts (for the
        reciprocal-rank metric; costs one extra scoring matmul per chunk,
        so it is off on the serving path).

    Returns (values, indices[, seen_above]) as numpy [n_users, k]; positions
    whose value is -inf have fewer than k unseen candidates and must be
    ignored.
    """
    n_users = U.shape[0]
    n_cand = V_cand.shape[0]
    k = min(k, n_cand)
    packed = pack_candidate_bitmap(seen_bitmap, cand_item_ids)
    v_dev = jnp.asarray(V_cand)
    b_dev = jnp.asarray(bias).reshape(-1) if bias is not None else None
    bm_dev = jnp.asarray(packed)

    out_vals = np.empty((n_users, k), dtype=np.float32)
    out_idx = np.empty((n_users, k), dtype=np.int32)
    out_sa = np.empty((n_users, k), dtype=np.int32) if want_raw_rank else None
    for start in range(0, n_users, user_chunk):
        stop = min(start + user_chunk, n_users)
        pad = user_chunk - (stop - start)
        u_emb = U[start:stop]
        seen_words = bm_dev[start:stop]
        if pad:
            u_emb = np.pad(u_emb, ((0, pad), (0, 0)))
            seen_words = jnp.pad(seen_words, ((0, pad), (0, 0)))
        u_dev = jnp.asarray(u_emb)
        vals, idx = _score_topk_chunk(
            u_dev, v_dev, b_dev, seen_words, n_cand, k
        )
        out_vals[start:stop] = np.asarray(vals)[: stop - start]
        out_idx[start:stop] = np.asarray(idx)[: stop - start]
        if want_raw_rank:
            sa = _raw_rank_scores(u_dev, v_dev, b_dev, seen_words, idx, n_cand)
            out_sa[start:stop] = np.asarray(sa)[: stop - start]
    if want_raw_rank:
        return out_vals, out_idx, out_sa
    return out_vals, out_idx


def topk_unseen_scorer(
    scorer,
    n_users: int,
    n_cand: int,
    seen_bitmap: np.ndarray,
    cand_item_ids: np.ndarray,
    k: int,
    user_chunk: int = 8192,
    packed_seen: Optional[np.ndarray] = None,
    want_rr: bool = True,
):
    """Top-k unseen candidates from an arbitrary chunk scorer.

    ``scorer(start, stop)`` must return device scores [stop-start, n_cand]
    for that user range (used by the fusion engine, which combines several
    modality score matrices per chunk without ever materializing the full
    [n_users, n_cand, n_feats] tensor the reference builds in RAM,
    reference old/methods/efusion.py:141-155).

    ``want_rr=False`` skips the raw-rank reconstruction (a full per-row
    sort per chunk, ``_seen_above_from_scores``) and returns
    ``seen_above=None`` — accuracy-only callers (the CLI ``fuse`` path)
    shouldn't pay for a metric they never print.
    """
    k = min(k, n_cand)
    packed = (
        packed_seen
        if packed_seen is not None
        else pack_candidate_bitmap(seen_bitmap, cand_item_ids)
    )
    bm_dev = jnp.asarray(packed)
    out_vals = np.empty((n_users, k), dtype=np.float32)
    out_idx = np.empty((n_users, k), dtype=np.int32)
    out_sa = np.empty((n_users, k), dtype=np.int32) if want_rr else None
    for start in range(0, n_users, user_chunk):
        stop = min(start + user_chunk, n_users)
        scores = scorer(start, stop)
        vals, idx = _mask_topk(scores, bm_dev[start:stop], n_cand, k)
        if want_rr:
            sa = _seen_above_from_scores(
                jnp.asarray(scores), bm_dev[start:stop], idx, n_cand
            )
            out_sa[start:stop] = np.asarray(sa)
        out_vals[start:stop] = np.asarray(vals)
        out_idx[start:stop] = np.asarray(idx)
    return out_vals, out_idx, out_sa


def _count_hits(
    top_idx: np.ndarray,
    top_vals: np.ndarray,
    seen_above: Optional[np.ndarray],
    likes: Dict[int, Sequence[int]],
    n_cand: int,
    step: int,
    total: int,
) -> EvalResult:
    """Vectorized bucketed hit counting from per-user top-k unseen lists.

    Hits bucket by unseen rank (the CLI contract, ref evaluate.py:100);
    the reciprocal-rank variant buckets by RAW rank with value 1/(t+1)
    (ref utils.py:116-119), reconstructed as unseen-rank + ``seen_above``.
    With ``seen_above=None`` the rr field is returned as zeros (callers
    that skip the extra scoring pass).
    """
    interval = total // step
    users = np.array([u for u, l in likes.items() if len(l) > 0], dtype=np.int64)
    count = sum(len(l) for l in likes.values())
    if users.size == 0:
        return EvalResult(
            hits=np.zeros(interval), rr=np.zeros(interval), count=count
        )
    # Pack like-sets (candidate space) into a bitmap for vectorized probing.
    n_words = (n_cand + 31) // 32
    like_bm = np.zeros((users.size, n_words), dtype=np.uint32)
    for row, u in enumerate(users):
        for c in likes[int(u)]:
            like_bm[row, c >> 5] |= np.uint32(1) << np.uint32(c & 31)
    idx = top_idx[users]                       # [nu, k]
    valid = np.isfinite(top_vals[users])
    words = like_bm[np.arange(users.size)[:, None], idx >> 5]
    hit = ((words >> (idx & 31).astype(np.uint32)) & 1).astype(bool) & valid
    k_eff = idx.shape[1]
    hits = np.zeros(interval)
    for j in range(interval):
        cut = min((j + 1) * step, k_eff)
        hits[j] = hit[:, :cut].sum()
    rrs = np.zeros(interval)
    if seen_above is not None:
        raw = np.arange(k_eff)[None, :] + seen_above[users]  # raw rank t
        rr_vals = np.where(hit, 1.0 / (raw + 1.0), 0.0)
        bucket = raw // step
        for j in range(interval):
            rrs[j] = rr_vals[bucket <= j].sum()
    return EvalResult(hits=hits, rr=rrs, count=count)


def evaluate_scores_device(
    U: np.ndarray,
    V_cand: np.ndarray,
    bias: Optional[np.ndarray],
    seen_bitmap: np.ndarray,
    cand_item_ids: np.ndarray,
    likes: Dict[int, Sequence[int]],
    step: int = 5,
    total: int = 30,
    user_chunk: int = 8192,
    want_rr: bool = True,
) -> EvalResult:
    """End-to-end device evaluation equivalent to ``evaluate_oracle``.

    Scoring + seen-masking + top-``total`` run jit-compiled on device;
    bucketed hit counting is a vectorized bitmap pass on host.
    ``want_rr=False`` skips the raw-rank reconstruction pass (a per-row
    sort — the accuracy-only CLI path doesn't pay for a metric it never
    prints; rr comes back as zeros).
    """
    if want_rr:
        vals, idx, seen_above = topk_unseen(
            U, V_cand, bias, seen_bitmap, cand_item_ids, total, user_chunk,
            want_raw_rank=True,
        )
    else:
        vals, idx = topk_unseen(
            U, V_cand, bias, seen_bitmap, cand_item_ids, total, user_chunk,
        )
        seen_above = None
    return _count_hits(
        idx, vals, seen_above, likes, V_cand.shape[0], step, total
    )


def _notcand_words(n_items: int, cand_item_ids: np.ndarray) -> np.ndarray:
    """uint32 [ceil(n_items/32)] bitmap with 1 for NON-candidate items."""
    n_words = (n_items + 31) // 32
    bits = np.ones(n_words * 32, dtype=np.uint8)
    bits[np.asarray(cand_item_ids, dtype=np.int64)] = 0
    return np.ascontiguousarray(
        np.packbits(bits, bitorder="little")
    ).view("<u4")


def evaluate_scores_device_full(
    U: np.ndarray,
    V: np.ndarray,                 # FULL catalog [n_items, dim]
    bias: Optional[np.ndarray],
    seen_bitmap: np.ndarray,       # full item space
    cand_item_ids: np.ndarray,
    likes: Dict[int, Sequence[int]],
    step: int = 5,
    total: int = 30,
    user_chunk: int = 8192,
    want_rr: bool = True,
) -> EvalResult:
    """Full-item-space evaluation: scores every item, excludes
    seen-or-non-candidate via ONE dense bitmap — no candidate-space
    bitmap repacking (the gather-heavy ``pack_candidate_bitmap``) and
    no per-candidate gathers anywhere. Candidate scores are identical
    dot products, so results match the candidate-submatrix formulation
    exactly; returned global item indices translate to candidate
    positions through a host lookup.
    """
    n_items = V.shape[0]
    cand = np.asarray(cand_item_ids, dtype=np.int64)
    k = min(total, len(cand))
    notcand = _notcand_words(n_items, cand)
    # combine seen | notcand ON DEVICE: the host OR materializes (and
    # then ships) a fresh ~91 MB bitmap per scenario at MovieLens scale;
    # the device OR ships the seen bitmap once (callers may pass an
    # already-device-resident bitmap — DeviceEvaluator caches it across
    # scenarios) plus n_words*4 bytes of notcand.
    seen_dev = (
        seen_bitmap
        if isinstance(seen_bitmap, jax.Array)
        else jnp.asarray(seen_bitmap)
    )
    nc_dev = jnp.asarray(notcand)
    excl = _or_bitmap(seen_dev, nc_dev)
    if want_rr:
        # raw rank counts SEEN CANDIDATES ranked above (the reference
        # walks the candidate list only, evaluate.py:95-97): that mask is
        # seen AND candidate = seen AND NOT notcand
        rr_bitmap = _andnot_bitmap(seen_dev, nc_dev)
        vals, idx, seen_above = _topk_excl(
            U, V, bias, excl, rr_bitmap, k, user_chunk,
        )
    else:
        vals, idx = _topk_excl(
            U, V, bias, excl, None, k, user_chunk,
        )
        seen_above = None
    # global item index -> candidate position (invalid slots are masked
    # by the -inf values in _count_hits)
    inv = np.full(n_items, 0, dtype=np.int32)
    inv[cand] = np.arange(len(cand), dtype=np.int32)
    idx = inv[np.clip(idx, 0, n_items - 1)]
    return _count_hits(idx, vals, seen_above, likes, len(cand), step, total)


@jax.jit
def _or_bitmap(seen: jax.Array, notcand: jax.Array) -> jax.Array:
    return seen | notcand[None, :]


@jax.jit
def _andnot_bitmap(seen: jax.Array, notcand: jax.Array) -> jax.Array:
    return seen & ~notcand[None, :]


def _topk_excl(U, V, bias, excl_bitmap, rr_bitmap, k, user_chunk):
    """Chunked device top-k with a precomputed full-space exclusion bitmap
    (and optional raw-rank counting against ``rr_bitmap``)."""
    n_users, n_items = U.shape[0], V.shape[0]
    v_dev = jnp.asarray(V)
    b_dev = jnp.asarray(bias).reshape(-1) if bias is not None else None
    bm_dev = jnp.asarray(excl_bitmap)
    rr_dev = jnp.asarray(rr_bitmap) if rr_bitmap is not None else None
    out_vals = np.empty((n_users, k), dtype=np.float32)
    out_idx = np.empty((n_users, k), dtype=np.int32)
    out_sa = np.empty((n_users, k), dtype=np.int32) if rr_dev is not None else None
    # dispatch ALL chunks asynchronously, fetch once at the end: a
    # per-chunk np.asarray would stall the host on every chunk
    pending = []
    for start in range(0, n_users, user_chunk):
        stop = min(start + user_chunk, n_users)
        pad = user_chunk - (stop - start)
        u_emb = U[start:stop]
        excl_words = bm_dev[start:stop]
        if pad:
            u_emb = np.pad(u_emb, ((0, pad), (0, 0)))
            excl_words = jnp.pad(excl_words, ((0, pad), (0, 0)))
        u_dev = jnp.asarray(u_emb)
        vals, idx = _score_topk_chunk(
            u_dev, v_dev, b_dev, excl_words, n_items, k
        )
        sa = None
        if rr_dev is not None:
            rr_words = rr_dev[start:stop]
            if pad:
                rr_words = jnp.pad(rr_words, ((0, pad), (0, 0)))
            sa = _raw_rank_scores(
                u_dev, v_dev, b_dev, rr_words, idx, n_items
            )
        pending.append((start, stop, vals, idx, sa))
    for start, stop, vals, idx, sa in pending:
        out_vals[start:stop] = np.asarray(vals)[: stop - start]
        out_idx[start:stop] = np.asarray(idx)[: stop - start]
        if sa is not None:
            out_sa[start:stop] = np.asarray(sa)[: stop - start]
    if rr_dev is not None:
        return out_vals, out_idx, out_sa
    return out_vals, out_idx


class DeviceEvaluator:
    """Reusable evaluator bound to one fold's history and candidate lists.

    Mirrors the reference CLI's per-scenario flow (evaluate.py:72-112):
    build the candidate submatrix, score, exclude train-seen, bucket hits.
    """

    def __init__(
        self,
        seen_bitmap: np.ndarray,
        step: int = 5,
        total: int = 30,
        user_chunk: int = 8192,
        want_rr: bool = True,
    ):
        self.seen_bitmap = seen_bitmap
        self.step = step
        self.total = total
        self.user_chunk = user_chunk
        self.want_rr = want_rr
        self._seen_dev = None  # lazy device copy, shared across scenarios

    def evaluate(
        self,
        U: np.ndarray,
        V: np.ndarray,
        bias: Optional[np.ndarray],
        cand_item_ids: np.ndarray,
        likes: Dict[int, Sequence[int]],
    ) -> EvalResult:
        cand_item_ids = np.asarray(cand_item_ids)
        if self._seen_dev is None:
            # ship the ~91 MB (MovieLens-scale) seen bitmap ONCE; each
            # scenario ORs its tiny notcand words on device
            self._seen_dev = jnp.asarray(self.seen_bitmap)
        return evaluate_scores_device_full(
            U,
            V,
            bias.reshape(-1) if bias is not None else None,
            self._seen_dev,
            cand_item_ids,
            likes,
            self.step,
            self.total,
            self.user_chunk,
            self.want_rr,
        )
