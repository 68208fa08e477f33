"""Seen-item masks: packed uint32 bitmaps and their dense expansion.

The evaluator, the serving path and the fusion engine exclude each user's
browsed items with the packed training bitmap from
``data.dataset.Interactions.seen_bitmap`` (bit ``i & 31`` of word
``i >> 5`` is item ``i``). These helpers re-pack it into a candidate
space on the host and expand it into a dense mask on the device.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

def expand_seen_mask(packed: jax.Array, n_cand: int) -> jax.Array:
    """Unpack a uint32 bitmap [rows, ceil(n_cand/32)] into int8 [rows, n_cand].

    Pure dense ops (repeat + shift) — no gathers, unlike indexing the bitmap
    per candidate (``bitmap[:, cand >> 5]``).
    """
    rows, words = packed.shape
    rep = jnp.repeat(packed, 32, axis=1)  # word w -> lanes [32w, 32w+32)
    shift = (
        jax.lax.broadcasted_iota(jnp.uint32, (1, words * 32), 1) % 32
    )
    bits = (rep >> shift) & jnp.uint32(1)
    return bits[:, :n_cand].astype(jnp.int8)


def pack_candidate_bitmap(
    seen_bitmap: np.ndarray, cand_item_ids: np.ndarray
) -> np.ndarray:
    """Re-pack the full-item-space seen bitmap into candidate space.

    Host-side, once per (fold, scenario): out bit c of user u =
    seen_bitmap bit ``cand_item_ids[c]``. This moves the random-access
    gather off the device hot path entirely.

    Processed in user-row chunks with ``np.packbits`` so the working set
    stays near 256 MB instead of several [n_users, n_cand] uint32
    temporaries.
    """
    cand = np.asarray(cand_item_ids, dtype=np.int64)
    n_users = seen_bitmap.shape[0]
    n_cand = cand.shape[0]
    n_words = (n_cand + 31) // 32
    pad = n_words * 32 - n_cand
    word_idx = cand >> 5
    shift = (cand & 31).astype(np.uint32)
    out = np.empty((n_users, n_words), dtype=np.uint32)
    chunk = max(1, (1 << 26) // max(1, n_cand))  # ~256MB working set
    for start in range(0, n_users, chunk):
        stop = min(start + chunk, n_users)
        bits = (
            (seen_bitmap[start:stop, word_idx] >> shift) & 1
        ).astype(np.uint8)
        if pad:
            bits = np.pad(bits, ((0, 0), (0, pad)))
        # little-endian bit pack: bit c of the byte stream = candidate c,
        # so a uint32 little-endian view reproduces the word layout
        packed = np.ascontiguousarray(
            np.packbits(bits, axis=1, bitorder="little")
        )
        out[start:stop] = packed.view("<u4")
    return out
