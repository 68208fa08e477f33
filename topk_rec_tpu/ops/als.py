"""Batched weighted-ALS solves on the accelerator.

Device replacement for the reference's sequential host solves — the
per-user/per-item k×k ``np.linalg.solve`` loops (reference single/wmf.py:
70-97, single/cer.py:39-63) and the GSL rank-1-update solver
(reference old/cr/cr.cpp:131-265).

Math (identical semantics, restructured as blocked matmuls): with confidence
weights a (positive) / b (background), the normal equations for entity t
with positive set I_t over fixed embeddings V are

    A_t = b·Vᵣᵀ Vᵣ + (a-b)·Σ_{j∈I_t} v_j v_jᵀ + λ·I
    A_t x_t = a·Σ_{j∈I_t} v_j  (+ λ·prior_t for content-coupled models)

Instead of per-entity gathers and host BLAS we process entities in blocks:
build the 0/1 selection matrix S ∈ {0,1}^{B×n} from the CSR layout and get

    Σ_{j∈I_t} v_j v_jᵀ  =  (S @ VV)_t  reshaped to k×k,   VV = [v_j v_jᵀ]_j
    Σ_{j∈I_t} v_j       =  (S @ V)_t

— two big matmuls per block followed by one batched k×k solve.
This also fixes the reference WMF's latent dict/list bug (wmf.py:75-76 calls
``.keys()/.values()`` on lists — see SURVEY.md §2.1 C4) by implementing the
*intended* weighted-ALS semantics directly (all ratings are 1 after the
like==1 filter, so the RHS rating weights reduce to a·Σ v_j).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

# Matmul precision for normal-equation ASSEMBLY (gram/selection dots).
# Rounded inputs put relative error into A that the prior-coupled DPM/CER
# alternation can amplify to NaN. On the H100, HIGH compiles to the same
# TF32 cuBLAS gemm as DEFAULT (~3e-4 relative error on a 2048^2 product),
# and one full-width DPM iteration (69,878 x 10,380, d=20000, MLP encoder)
# goes NaN with it; HIGHEST (fp32, ~8e-7) stays finite.
_ALS_PRECISION = jax.lax.Precision.HIGHEST


def gram_matrix(emb: jax.Array, rows: Optional[jax.Array] = None) -> jax.Array:
    """Eᵣᵀ Eᵣ over the selected rows (ref wmf.py:70-71 ``vr.T @ vr``)."""
    sel = emb[rows] if rows is not None else emb
    return jnp.dot(sel.T, sel, preferred_element_type=jnp.float32,
                   precision=_ALS_PRECISION)


def batched_solve(A: jax.Array, rhs: jax.Array) -> jax.Array:
    """Solve A_t x_t = rhs_t for a batch of SPD k×k systems.

    Hand-built batched Cholesky + triangular solves from ``fori_loop`` +
    dynamic slices (3 loops of k steps of batched vector ops). Conjugate
    gradients would diverge to NaN in fp32 on the ill-conditioned systems
    ALS produces when the fixed-side vectors are nearly collinear (e.g. an
    untrained encoder's outputs in DPM — rank-1-dominant A with cond
    ~1e5); Cholesky is stable for SPD systems and exact. Whether
    ``jnp.linalg.cholesky`` + ``cho_solve`` is faster on H100 is not
    measured (ROADMAP D2).
    """
    squeeze = rhs.ndim == A.ndim - 1
    if squeeze:
        rhs = rhs[..., None]
    k = A.shape[-1]
    row_idx = jnp.arange(k)
    # fp32 safety on near-singular systems (e.g. rank-1-dominant normal
    # matrices from nearly-collinear fixed-side vectors): trace-scaled
    # jitter keeps trailing pivots positive; the clip floor is relative so
    # a rounding-negative pivot can't explode into inf.
    scale = (
        jnp.trace(A, axis1=-2, axis2=-1) / k
    )[..., None, None]
    A = A + 1e-6 * scale * jnp.eye(k, dtype=A.dtype)
    pivot_floor = 1e-10 * scale

    def chol_body(j, state):
        L, A = state
        ajj = jnp.maximum(
            jax.lax.dynamic_slice_in_dim(
                jax.lax.dynamic_slice_in_dim(A, j, 1, axis=-1), j, 1, axis=-2
            ),
            pivot_floor,
        )  # [..., 1, 1]
        d = jnp.sqrt(ajj)
        col = jax.lax.dynamic_slice_in_dim(A, j, 1, axis=-1) / d  # [...,k,1]
        mask = (row_idx >= j)[..., :, None]
        col = jnp.where(mask, col, 0.0)
        L = jax.lax.dynamic_update_slice_in_dim(L, col, j, axis=-1)
        A = A - col * jnp.swapaxes(col, -1, -2)
        return L, A

    L, _ = jax.lax.fori_loop(
        0, k, chol_body, (jnp.zeros_like(A), A)
    )

    # forward substitution: L y = rhs
    def fwd_body(j, y):
        Lrow = jax.lax.dynamic_slice_in_dim(L, j, 1, axis=-2)  # [...,1,k]
        ljj = jax.lax.dynamic_slice_in_dim(Lrow, j, 1, axis=-1)
        rj = jax.lax.dynamic_slice_in_dim(rhs, j, 1, axis=-2)
        yj = (rj - jnp.matmul(Lrow, y)) / ljj
        return jax.lax.dynamic_update_slice_in_dim(y, yj, j, axis=-2)

    y = jax.lax.fori_loop(0, k, fwd_body, jnp.zeros_like(rhs))

    # back substitution: Lᵀ x = y
    Lt = jnp.swapaxes(L, -1, -2)

    def bwd_body(i, x):
        j = k - 1 - i
        Lrow = jax.lax.dynamic_slice_in_dim(Lt, j, 1, axis=-2)
        ljj = jax.lax.dynamic_slice_in_dim(Lrow, j, 1, axis=-1)
        yj = jax.lax.dynamic_slice_in_dim(y, j, 1, axis=-2)
        xj = (yj - jnp.matmul(Lrow, x)) / ljj
        return jax.lax.dynamic_update_slice_in_dim(x, xj, j, axis=-2)

    x = jax.lax.fori_loop(0, k, bwd_body, jnp.zeros_like(rhs))
    return x[..., 0] if squeeze else x


class ALSPlan:
    """Precomputed static block layout for one side of the alternation.

    Per-block (row, col) positive pairs are padded once to the max block
    nnz (``cap``) so every block reuses a single compiled kernel, and the
    stacked [n_blocks, ...] layout lets the whole sweep run as one
    ``lax.scan`` on device.

    ``balanced=True`` (default) assigns entities to blocks round-robin in
    descending-degree order instead of by contiguous index ranges: every
    block pays ``cap`` (the max block nnz), so a contiguous split of an
    id-ordered catalog (item ids are often assigned by popularity) can
    concentrate the heavy rows in one block and inflate the padded work
    severalfold; balancing pins cap ≈ nnz / n_blocks for ANY degree
    distribution. (On the MovieLens-scale zipf bench fold the contiguous
    split is already near-balanced — dedup against 69,878 users saturates
    the head degrees — measured cap 699,970 vs 694,536; the guarantee is
    the point, not that fold.) The entity permutation is carried in
    ``perm`` ([n_blocks·block_size] int32, value n_this = padding slot)
    and applied/inverted on device inside the sweep (two [n, k]
    gathers/scatters — noise next to the block matmuls).
    """

    def __init__(
        self,
        indptr: np.ndarray,
        flat: np.ndarray,
        n_this: int,
        block_size: int = 2048,
        balanced: bool = True,
    ):
        self.n_this = n_this
        self.block_size = block_size
        deg = np.diff(indptr).astype(np.int64)
        n_blocks = max(1, -(-n_this // block_size))
        self.n_blocks = n_blocks
        if balanced and n_blocks > 1:
            order = np.argsort(-deg, kind="stable")
        else:
            order = np.arange(n_this)
        # deal entities into blocks round-robin over the chosen order
        # (identity order => contiguous-strided; degree order => balanced)
        per_block = [order[b::n_blocks] for b in range(n_blocks)]
        n_pad = n_blocks * block_size
        perm = np.full(n_pad, n_this, dtype=np.int64)  # n_this = dummy slot
        rows_l, cols_l, deg_l = [], [], []
        cap = 1
        for b, ents in enumerate(per_block):
            cap = max(cap, int(deg[ents].sum()))
        self.cap = cap
        for b, ents in enumerate(per_block):
            perm[b * block_size : b * block_size + len(ents)] = ents
            lens = deg[ents]
            rows = np.repeat(
                np.arange(len(ents), dtype=np.int32), lens
            )
            # gather each entity's CSR segment (vectorized run expansion)
            starts = indptr[ents].astype(np.int64)
            total = int(lens.sum())
            if total:
                offs = np.arange(total, dtype=np.int64) - np.repeat(
                    np.cumsum(lens) - lens, lens
                )
                cols = flat[np.repeat(starts, lens) + offs].astype(np.int32)
            else:
                cols = np.zeros(0, np.int32)
            pad = cap - rows.shape[0]
            rows = np.pad(rows, (0, pad), constant_values=block_size)
            cols = np.pad(cols, (0, pad), constant_values=0)
            deg_block = np.zeros(block_size, dtype=np.int32)
            deg_block[: len(ents)] = lens
            rows_l.append(rows)
            cols_l.append(cols)
            deg_l.append(deg_block)
        # stacked device layout for the fused whole-sweep scan
        self.rows_stack = jnp.asarray(np.stack(rows_l))
        self.cols_stack = jnp.asarray(np.stack(cols_l))
        self.deg_stack = jnp.asarray(np.stack(deg_l))
        self.perm = jnp.asarray(perm.astype(np.int32))


def _sweep_impl(
    rows_stack: jax.Array,    # int32 [n_blocks, cap]
    cols_stack: jax.Array,    # int32 [n_blocks, cap]
    deg_stack: jax.Array,     # int32 [n_blocks, block]
    perm: jax.Array,          # int32 [n_blocks*block] entity per slot
    this_emb: jax.Array,      # [n_this, k]
    other_emb: jax.Array,     # [n_other, k]
    rated_mask: jax.Array,    # float32 [n_other] — 1 for rated rows
    prior: jax.Array,         # [n_this, k] (zeros when unused)
    a,
    b,
    lam,
    *,
    block_size: int,
    n_this: int,
    use_prior: bool,
    keep_old_unrated: bool,
    constrain=None,
) -> Tuple[jax.Array, jax.Array]:
    """Whole half-sweep as one traced scan over blocks (no host syncs).

    ``constrain`` is an optional fn applied to the per-block row-major
    intermediates (the selection matrix S and the solved block) so a mesh
    caller can pin them to an entity-row sharding; GSPMD then partitions
    the S·VV / S·V matmuls and the batched solves row-wise with no
    collectives on the hot path (the distributed analog of the reference's
    sequential GSL entity loop, old/cr/cr.cpp:146-216).
    """
    if constrain is None:
        constrain = lambda x: x
    n_blocks = rows_stack.shape[0]
    n_other, k = other_emb.shape
    # row-wise outer products via broadcast multiply (einsum 'nk,nl->nkl'
    # lowers poorly on this backend)
    vv = (other_emb[:, :, None] * other_emb[:, None, :]).reshape(
        n_other, k * k
    )
    # Normal-equation ASSEMBLY runs at _ALS_PRECISION: rounded inputs
    # put relative error into A's entries that the prior-coupled CER/DPM
    # alternation can amplify to NaN. The solves are fp32 with jittered
    # pivots; it's the Gram/selection matmuls that must not round their
    # inputs. Loss diagnostics below stay at DEFAULT.
    sel = other_emb * rated_mask[:, None]
    gram_b = b * jnp.dot(
        sel.T, sel, preferred_element_type=jnp.float32,
        precision=_ALS_PRECISION,
    )
    # route entities to their (possibly degree-balanced) block slots;
    # perm value n_this marks a padding slot -> zero row via fill
    old_stack = this_emb.at[perm].get(mode="fill", fill_value=0.0).reshape(
        n_blocks, block_size, k
    )
    prior_stack = prior.at[perm].get(mode="fill", fill_value=0.0).reshape(
        n_blocks, block_size, k
    )
    eye = lam * jnp.eye(k, dtype=jnp.float32)

    def block(_, xs):
        rows, cols, deg_block, old_block, prior_block = xs
        S = constrain(
            jnp.zeros((block_size + 1, n_other), dtype=jnp.float32)
            .at[rows, cols]
            .add(1.0)[:block_size]
        )
        P = jnp.dot(
            S, vv, preferred_element_type=jnp.float32,
            precision=_ALS_PRECISION,
        )
        sum_v = jnp.dot(
            S, other_emb, preferred_element_type=jnp.float32,
            precision=_ALS_PRECISION,
        )
        A_fit = gram_b[None, :, :] + (a - b) * P.reshape(block_size, k, k)
        A = A_fit + eye[None]
        rhs = a * sum_v
        if use_prior:
            rhs = rhs + lam * prior_block
        new = batched_solve(A, rhs)
        if keep_old_unrated:
            new = jnp.where((deg_block > 0)[:, None], new, old_block)
        new = constrain(new)
        quad = 0.5 * jnp.einsum("bi,bij,bj->b", new, A_fit, new)
        lin = a * jnp.sum(sum_v * new, axis=1)
        fit = jnp.where(deg_block > 0, 0.5 * deg_block * a + quad - lin, 0.0)
        return None, (new, jnp.sum(fit))

    _, (new_stack, fits) = jax.lax.scan(
        block,
        None,
        (rows_stack, cols_stack, deg_stack, old_stack, prior_stack),
    )
    # scatter block slots back to natural entity order (padding slots
    # carry perm == n_this and drop)
    new = (
        jnp.zeros((n_this, k), jnp.float32)
        .at[perm]
        .set(new_stack.reshape(n_blocks * block_size, k), mode="drop")
    )
    return new, jnp.sum(fits)


@partial(
    jax.jit,
    static_argnames=(
        "block_size",
        "n_this",
        "use_prior",
        "keep_old_unrated",
    ),
)
def _als_sweep(
    rows_stack: jax.Array,
    cols_stack: jax.Array,
    deg_stack: jax.Array,
    perm: jax.Array,
    this_emb: jax.Array,
    other_emb: jax.Array,
    rated_mask: jax.Array,
    prior: jax.Array,
    a: float,
    b: float,
    lam: float,
    block_size: int,
    n_this: int,
    use_prior: bool,
    keep_old_unrated: bool,
) -> Tuple[jax.Array, jax.Array]:
    """Single-device compiled whole half-sweep (see ``_sweep_impl``)."""
    return _sweep_impl(
        rows_stack,
        cols_stack,
        deg_stack,
        perm,
        this_emb,
        other_emb,
        rated_mask,
        prior,
        a,
        b,
        lam,
        block_size=block_size,
        n_this=n_this,
        use_prior=use_prior,
        keep_old_unrated=keep_old_unrated,
    )


def half_sweep(
    plan: ALSPlan,
    this_emb,
    other_emb,
    rated_other,
    a: float,
    b: float,
    lam: float,
    prior=None,
    keep_old_unrated: bool = True,
    as_numpy: bool = True,
) -> Tuple[np.ndarray, float]:
    """One ALS half-sweep: update ``this_emb`` given fixed ``other_emb``.

    Returns (updated embeddings, fit-loss contribution over rated entities).
    ``prior`` enables the content-coupled RHS (+λ·prior, CER/DPM semantics,
    ref cer.py:49-63); with a prior, unrated entities are solved from the
    prior alone (ref cer.py:62) instead of kept (ref wmf.py:82 guard).
    The whole sweep executes as one device program.

    ``as_numpy=False`` skips the host round trip and returns device arrays
    (embeddings + scalar fit), so the training loops keep everything
    device-resident and sync once per iteration on the scalar loss instead
    of fetching and re-uploading the user table per sweep.
    """
    other_emb = jnp.asarray(other_emb)
    k = other_emb.shape[1]
    n_other = other_emb.shape[0]
    rated_mask = (
        jnp.zeros(n_other, jnp.float32).at[jnp.asarray(rated_other)].set(1.0)
    )
    use_prior = prior is not None
    prior_dev = (
        jnp.asarray(prior)
        if use_prior
        else jnp.zeros((plan.n_this, k), jnp.float32)
    )
    new, fit = _als_sweep(
        plan.rows_stack,
        plan.cols_stack,
        plan.deg_stack,
        plan.perm,
        jnp.asarray(this_emb),
        other_emb,
        rated_mask,
        prior_dev,
        float(a),
        float(b),
        float(lam),
        plan.block_size,
        plan.n_this,
        use_prior,
        keep_old_unrated and not use_prior,
    )
    if not as_numpy:
        return new, fit
    # np.array (not asarray): jax buffers are read-only zero-copy views and
    # callers mutate the result (cold-start writeback)
    return np.array(new), float(fit)


def weighted_als_user_update(
    user_emb: np.ndarray,
    item_emb: np.ndarray,
    inter,
    a: float,
    b: float,
    lam_u: float,
    block_size: int = 2048,
) -> np.ndarray:
    """Convenience one-shot user-side update (tests / simple callers)."""
    indptr, flat = inter.user_csr
    plan = ALSPlan(indptr, flat, inter.n_users, block_size)
    new, _ = half_sweep(
        plan,
        user_emb,
        item_emb,
        jnp.asarray(inter.rated_items),
        a,
        b,
        lam_u,
    )
    return new
