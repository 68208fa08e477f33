"""Late score-fusion of per-modality recommendation models.

Device re-design of the reference's five fusion strategies over
per-content-modality CER score matrices (reference old/methods/, §2.3 O7
in SURVEY.md):

  * average        — uniform weights (afusion.py:26-31)
  * rank-geometric — weights p·(1-p)^i over the modality list (pfusion.py:64-70)
  * error-weighted — per-user exp(-(RMSE - mean)) from train-set
                     reconstruction error (efusion.py:57-82)
  * svm            — linear SVM on pairwise score-difference vectors
                     (sfusion.py:28-63; sklearn LinearSVC(C=0.01) becomes a
                     jit-compiled squared-hinge solver)
  * bpr            — pairwise-ranking weight vector over score features
                     (ranking_fusion.py:19-62)

Key structural change: the reference materializes dense
[n_users × n_cand × n_feats] tensors in host RAM (efusion.py:141-155 —
~18 GB at MovieLens scale with 8 modalities). Here modality scores are
produced on device per user-chunk (one k-dim matmul per modality), fused
into one score block, and reduced straight into top-k; weight
*learning* touches only sampled or streamed entries, so the full tensor
never exists anywhere.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..data.dataset import Interactions
from ..eval.device import _count_hits, topk_unseen_scorer
from ..eval.protocol import EvalResult
from ..ops.sampling import TripletSampler


class ModalityScores:
    """Per-modality embeddings with on-device chunked scoring.

    Each modality f contributes scores S_f = U_f · V_f[cand]ᵀ. The stacked
    chunk [CU, n_cand, F] is built on device only per user-chunk.
    """

    def __init__(self, embeddings: Sequence[Tuple[np.ndarray, np.ndarray]]):
        """``embeddings``: list of (U_f [n_users,k_f], V_f [n_items,k_f])."""
        assert len(embeddings) > 0
        self.n_feats = len(embeddings)
        self.n_users = embeddings[0][0].shape[0]
        self.n_items = embeddings[0][1].shape[0]
        self._U = [jnp.asarray(U, dtype=jnp.float32) for U, _ in embeddings]
        self._V = [jnp.asarray(V, dtype=jnp.float32) for _, V in embeddings]

    def chunk_stack(
        self, start: int, stop: int, cand_ids: jax.Array
    ) -> jax.Array:
        """[stop-start, n_cand, F] stacked scores for a user range."""
        cols = []
        for U, V in zip(self._U, self._V):
            cols.append(
                jnp.dot(
                    U[start:stop],
                    V[cand_ids].T,
                    preferred_element_type=jnp.float32,
                )
            )
        return jnp.stack(cols, axis=-1)

    def sample_scores(
        self, u: jax.Array, i: jax.Array
    ) -> jax.Array:
        """S[u, i, :] for paired index vectors — gather + row dot, [B, F]."""
        cols = []
        for U, V in zip(self._U, self._V):
            cols.append(jnp.sum(U[u] * V[i], axis=1))
        return jnp.stack(cols, axis=-1)

    def fused_scorer(self, weights: np.ndarray, cand_ids):
        """Chunk scorer computing the WEIGHTED fusion as one concat
        matmul: Σ_f w_f·U_f·V_fᵀ == concat_f(w_f·U_f) · concat_f(V_f)ᵀ —
        blockwise-scaling the user side folds the weights in exactly, so
        the [CU, n_cand, F] stack (and its memory traffic) never
        exists on the eval path. Works for global [F] and per-user
        [n_users, F] weights (error fusion); the per-modality stack is
        still used where modalities are needed separately
        (``chunk_stack`` — weight learning).
        """
        weights = jnp.asarray(np.asarray(weights, dtype=np.float32))
        per_user = weights.ndim == 2
        cand = jnp.asarray(np.asarray(cand_ids))
        V_cat = jnp.concatenate([V[cand] for V in self._V], axis=1)
        # eager ops (each is one fused XLA call; no jitted closure over
        # the big V_cat — closures bake arrays into the HLO and the
        # remote-compile service rejects large requests, CLAUDE.md)
        if not per_user:
            U_cat = jnp.concatenate(
                [w * U for w, U in zip(weights, self._U)], axis=1
            )

            def scorer(start, stop):
                return jnp.dot(
                    U_cat[start:stop], V_cat.T,
                    preferred_element_type=jnp.float32,
                )
        else:

            def scorer(start, stop):
                w = weights[start:stop]
                U_cat = jnp.concatenate(
                    [
                        w[:, f : f + 1] * U[start:stop]
                        for f, U in enumerate(self._U)
                    ],
                    axis=1,
                )
                return jnp.dot(
                    U_cat, V_cat.T, preferred_element_type=jnp.float32
                )

        return scorer


# ---------------------------------------------------------------------------
# weight strategies


def average_weights(n_feats: int) -> np.ndarray:
    """Uniform late fusion (ref afusion.py:26-31)."""
    return np.full(n_feats, 1.0 / n_feats, dtype=np.float32)


def rank_geometric_weights(n_feats: int, p: float) -> np.ndarray:
    """w_i = p·(1-p)^i over the modality list order (ref pfusion.py:64-70)."""
    i = np.arange(n_feats)
    return (np.power(1.0 - p, i) * p).astype(np.float32)


def error_weights(
    modalities: ModalityScores,
    inter: Interactions,
    cand_ids: np.ndarray,
    user_chunk: int = 4096,
) -> np.ndarray:
    """Per-user error-based weights (ref efusion.py:57-82).

    weight[u,f] = sqrt( Σ_c ((S_f[u,c] − L[u,c])²·L[u,c]) / max(1, Σ_c L[u,c]) )
    then per user: subtract the row mean and exponentiate exp(−·); rows whose
    mean is exactly 0 are left as zeros (the reference's wmean==0 guard).
    Computed streaming over user chunks; L is the 0/1 train like matrix
    restricted to the candidate list.
    """
    cand_ids = np.asarray(cand_ids)
    n_users = modalities.n_users
    F = modalities.n_feats
    # like matrix in candidate space, expanded from the packed positive
    # bitmap ON DEVICE: a host expansion would build and ship a
    # [chunk, n_cand] float32 like-matrix per chunk (~2.3 GB across
    # MovieLens-scale chunks); the packed words ship once (~91 MB) and
    # each chunk expands on the device.
    bm_dev = jnp.asarray(inter.pos_bitmap)
    cw_dev = jnp.asarray((cand_ids >> 5).astype(np.int32))
    cb_dev = jnp.asarray((cand_ids & 31).astype(np.uint32))
    cand_dev = jnp.asarray(cand_ids)

    @jax.jit
    def chunk_weights(stack, bm_rows):
        # stack [CU, n_cand, F]; bm_rows [CU, n_words] packed likes
        like = ((bm_rows[:, cw_dev] >> cb_dev[None, :]) & 1).astype(
            jnp.float32
        )
        sq = (stack - like[:, :, None]) ** 2 * like[:, :, None]
        svec = jnp.maximum(jnp.sum(like, axis=1), 1.0)
        return jnp.sqrt(jnp.sum(sq, axis=1) / svec[:, None])

    weight = np.zeros((n_users, F), dtype=np.float32)
    # bounded pipelining (window 3): the async-RTT win without letting
    # every chunk's multi-GB [CU, n_cand, F] stack buffer be live at
    # once — an unbounded dispatch queue held ~17 x 1.3 GB of enqueued
    # outputs at MovieLens scale and risks RESOURCE_EXHAUSTED on a
    # 16 GB chip at slightly larger shapes
    pending = []
    for start in range(0, n_users, user_chunk):
        stop = min(start + user_chunk, n_users)
        stack = modalities.chunk_stack(start, stop, cand_dev)
        pending.append((start, stop, chunk_weights(stack, bm_dev[start:stop])))
        if len(pending) > 3:
            s0, s1, out = pending.pop(0)
            weight[s0:s1] = np.asarray(out)[: s1 - s0]
    for s0, s1, out in pending:
        weight[s0:s1] = np.asarray(out)[: s1 - s0]
    wmean = weight.mean(axis=1, keepdims=True)
    nz = (wmean != 0).reshape(-1)
    weight[nz] = np.exp(-(weight[nz] - wmean[nz]))
    return weight


@partial(jax.jit, static_argnames=("n_iters",), donate_argnums=())
def _squared_hinge_fit(
    X: jax.Array, y: jax.Array, C: float, lr: float, n_iters: int
):
    """min_w 0.5‖w‖² + C·Σ max(0, 1 − y(Xw + b))² by full-batch Adam."""
    F = X.shape[1]

    def loss_fn(wb):
        w, b = wb
        margin = jnp.maximum(0.0, 1.0 - y * (X @ w + b))
        return 0.5 * jnp.sum(w**2) + C * jnp.sum(margin**2)

    w0 = jnp.zeros(F, dtype=jnp.float32)
    b0 = jnp.zeros((), dtype=jnp.float32)
    m0 = (jnp.zeros_like(w0), jnp.zeros_like(b0))
    v0 = (jnp.zeros_like(w0), jnp.zeros_like(b0))

    def step(carry, t):
        wb, m, v = carry
        g = jax.grad(loss_fn)(wb)
        m = jax.tree.map(lambda a, b_: 0.9 * a + 0.1 * b_, m, g)
        v = jax.tree.map(lambda a, b_: 0.999 * a + 0.001 * b_ * b_, v, g)
        mh = jax.tree.map(lambda a: a / (1 - 0.9 ** (t + 1.0)), m)
        vh = jax.tree.map(lambda a: a / (1 - 0.999 ** (t + 1.0)), v)
        wb = jax.tree.map(
            lambda p, a, b_: p - lr * a / (jnp.sqrt(b_) + 1e-8), wb, mh, vh
        )
        return (wb, m, v), loss_fn(wb)

    (wb, _, _), losses = jax.lax.scan(
        step, ((w0, b0), m0, v0), jnp.arange(n_iters, dtype=jnp.float32)
    )
    return wb[0], losses[-1]


def svm_fusion_weights(
    modalities: ModalityScores,
    inter: Interactions,
    n_samples: int = 100_000,
    C: float = 0.01,
    seed: int = 0,
    lr: float = 0.05,
    n_iters: int = 500,
) -> np.ndarray:
    """Linear-SVM fusion weights on pairwise difference vectors.

    Mirrors reference sfusion.py:28-63: sample (user, liked, disliked)
    triplets, features are S[u,pos,:] − S[u,neg,:], labels alternate ±1 with
    the feature negated for the −1 class; a squared-hinge linear SVM
    (sklearn LinearSVC's default loss) yields the weight vector. Triplets
    come from the device sampler; scores are gathered on the fly.
    """
    sampler = TripletSampler(inter)
    key = jax.random.PRNGKey(seed)
    u, i, j = sampler(key, n_samples)
    x = modalities.sample_scores(u, i) - modalities.sample_scores(u, j)
    sign = jnp.where(jnp.arange(n_samples) % 2 == 0, 1.0, -1.0)
    X = x * sign[:, None]
    y = sign
    w, _ = _squared_hinge_fit(X, y, C, lr, n_iters)
    return np.asarray(w)


@partial(
    jax.jit,
    static_argnames=("n_chunks", "widths", "n_batches", "batch_size"),
)
def _fusion_build_d(Ucat, Vcat, u, i, j, n_chunks, widths, n_batches,
                    batch_size):
    """Score-difference precompute for the bpr-fusion fit: chunked big
    row-gathers over the CONCATENATED modality tables. Module-level jit
    taking the tables as ARGUMENTS — defining jits inside the fit
    function retraced + recompiled per call with the tables baked in as
    constants (the lookup.py _cached_jit lesson applied again). ``widths`` (static tuple) carries
    each modality's embedding width so heterogeneous-k modality sets
    reduce the right column segments (a uniform reshape would silently
    mix columns across modalities)."""
    total = u.shape[0]
    gchunk = total // n_chunks
    offsets = np.concatenate([[0], np.cumsum(widths)])

    def build_d(_, idxs):
        uu, ii, jj = idxs
        g = Ucat[uu] * (Vcat[ii] - Vcat[jj])   # [gchunk, sum(widths)]
        d = jnp.stack(
            [
                jnp.sum(g[:, offsets[f] : offsets[f + 1]], axis=1)
                for f in range(len(widths))
            ],
            axis=-1,
        )
        return None, d

    _, d_all = jax.lax.scan(
        build_d,
        None,
        (
            u.reshape(n_chunks, gchunk),
            i.reshape(n_chunks, gchunk),
            j.reshape(n_chunks, gchunk),
        ),
    )
    return d_all.reshape(n_batches, batch_size, len(widths))


@jax.jit
def _fusion_sgd(d_all, w0, lr, lambda_w):
    """Minibatch SGD over precomputed score-difference batches
    (ref ranking_fusion.py:28-37 loss)."""

    def step(w, d):
        def cost(w_):
            return -jnp.sum(
                jax.nn.log_sigmoid(d @ w_)
            ) + 0.5 * lambda_w * jnp.sum(w_**2)

        g = jax.grad(cost)(w)
        return w - lr * g, cost(w)

    return jax.lax.scan(step, w0, d_all)


def bpr_fusion_weights(
    modalities: ModalityScores,
    inter: Interactions,
    n_samples: int = 10_000_000,
    batch_size: int = 10_000,
    lr: float = 1.0e-4,
    lambda_w: float = 0.0025,
    seed: int = 0,
) -> np.ndarray:
    """Pairwise-ranking fusion weights (ref ranking_fusion.py:19-62).

    W starts at zero; plain SGD on −Σ log σ(W·(S[u,i,:] − S[u,j,:])) +
    λw/2·‖W‖², sampled triplets, batches of 10k. The default sample
    budget matches the reference's 10M (ranking_fusion.py:44) — at
    device sampling+gather speed the whole budget is one scan of 1000
    batches, so there is no reason to diverge from parity.
    """
    sampler = TripletSampler(inter)
    F = modalities.n_feats
    n_batches = max(1, n_samples // batch_size)

    # d-precompute chunking: few LARGE gathers instead of many small ones
    # (fewer dispatched ops; not measured on H100)
    total = n_batches * batch_size
    n_gather_chunks = max(1, min(n_batches, 40))
    while total % n_gather_chunks:
        n_gather_chunks -= 1

    # Scheduling: the score-difference vectors d do NOT depend on w, so
    # sampling + gathers + per-modality dots are hoisted out of the
    # sequential SGD chain; the 8 modality tables are CONCATENATED once
    # ([n, F*k]) so each precompute chunk issues 3 big row-gathers
    # instead of 24 small ones; and sampling, gathering, and SGD run as
    # THREE separate jit calls handing device arrays over — fused into
    # one program, XLA rematerializes the upstream stage inside the
    # downstream scan (the 10M-triplet sample was recomputed per gather
    # chunk). Jit boundaries are the reliable barrier.
    key = jax.random.PRNGKey(seed)
    u, i, j = sampler(key, total)  # sampler is its own jitted program
    Ucat = jnp.concatenate(modalities._U, axis=1)   # [n_users, F*k]
    Vcat = jnp.concatenate(modalities._V, axis=1)   # [n_items, F*k]
    d_all = _fusion_build_d(
        Ucat, Vcat, u, i, j, n_gather_chunks,
        tuple(int(Uf.shape[1]) for Uf in modalities._U),
        n_batches, batch_size,
    )
    w, _ = _fusion_sgd(
        d_all, jnp.zeros(F, dtype=jnp.float32), lr, lambda_w
    )
    return np.asarray(w)


# ---------------------------------------------------------------------------
# fused evaluation


def evaluate_fused(
    modalities: ModalityScores,
    weights: np.ndarray,
    seen_bitmap: np.ndarray,
    cand_ids: np.ndarray,
    likes: Dict[int, Sequence[int]],
    step: int = 5,
    total: int = 30,
    user_chunk: int = 4096,
    packed_seen: np.ndarray = None,
    want_rr: bool = False,
) -> EvalResult:
    """Evaluate the weighted fusion under the standard protocol.

    ``weights`` is [F] (global strategies) or [n_users, F] (per-user,
    error-weighted). Fusion happens on device per chunk; the stacked tensor
    never materializes globally. ``packed_seen`` lets callers evaluating
    several strategies on one (fold, scenario) pack the candidate-space
    seen bitmap once (pack_candidate_bitmap) instead of per call.
    ``want_rr`` defaults OFF: the fusion surfaces (CLI ``fuse``, the
    reference's fusion scripts) print accuracy only, and the raw-rank
    reconstruction costs a full per-row sort per chunk; pass True to get
    the reciprocal-rank variant populated (ref utils.py:116-119).
    """
    weights = np.asarray(weights, dtype=np.float32)
    # one blockwise-scaled concat matmul per chunk — the per-modality
    # [CU, n_cand, F] stack never materializes (see fused_scorer)
    scorer = modalities.fused_scorer(weights, cand_ids)

    vals, idx, seen_above = topk_unseen_scorer(
        scorer,
        modalities.n_users,
        len(np.asarray(cand_ids)),
        seen_bitmap,
        cand_ids,
        total,
        user_chunk,
        packed_seen=packed_seen,
        want_rr=want_rr,
    )
    return _count_hits(
        idx, vals, seen_above, likes, len(np.asarray(cand_ids)), step, total
    )
