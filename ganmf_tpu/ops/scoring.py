"""Fused scoring + masked top-K, as one plain XLA program.

Every fused ranking path — the MF family (``U_b @ V^T``) and the
similarity family (``URM[u] @ W``, ``W[u] @ URM``) — is
``top_k(mask(rows @ right))`` plus a probe of the masked scores at each
row's test items. XLA writes the [B, I] score block to device memory and
reads it back for the ranking; at the reference catalogs that round trip
is small against the block's contraction, top-k and metric work.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("k", "mask_from_rows"))
def masked_topk_matmul(
    rows: jnp.ndarray,  # [B, C] left operand (user factors or profile rows)
    W: jnp.ndarray,  # [C, I] right operand (V^T, or a dense similarity/URM matrix)
    seen_mask: jnp.ndarray,  # [B, I] nonzero = exclude; None with mask_from_rows
    pair_ids: jnp.ndarray,  # [B, P] test item ids per row (0-padded)
    k: int,
    mask_from_rows: bool = False,
):
    """`top_k(mask(rows @ W))` plus a test-pair probe, for the MF serving
    path `U[u] @ V^T` and the similarity-family paths `URM[u] @ W`
    (item-based) and `W[u] @ URM` (user-based; reference
    BaseSimilarityMatrixRecommender.py:73-116).

    Returns (values [B, k], ids [B, k], pair_scores [B, P],
    pair_finite [B, P]): the last two give each row's masked score at its
    test items, so the evaluator's RMSE needs no [B, I] readback either.

    The single-array contraction runs at HIGHEST precision, the same as
    every model's ``score_device``, so fused and unfused rankings agree
    list for list.

    Either operand may instead be a tuple of bfloat16 planes (see
    ``split_bf16_planes``): the contraction then runs one bf16 pass per
    plane pair with f32 accumulation, against an operand that is
    bf16-exact (binary profiles are). Ranking goes through ``tiled_topk``
    (value- and tie-identical to ``lax.top_k``: lowest index first) so the
    sort never materializes full-catalog-width rows.

    ``mask_from_rows=True`` derives the exclusion mask from the LEFT operand
    instead of ``seen_mask`` (pass None): for item-based similarity scoring
    the left operand IS the user's training profile, i.e. exactly the
    exclude-seen set, and the [B, I] seen rows would otherwise be re-built
    by a second scatter identical to the one that built ``rows``.
    Value-exact: both the mask and the profile are value-nonzero tests of
    the same stored entries (data/device.padded_rows_mask is
    `padded_rows_dense != 0`).
    """
    from ganmf_tpu.ops.topk import tiled_topk

    if isinstance(rows, tuple) or isinstance(W, tuple):
        rs = rows if isinstance(rows, tuple) else (rows.astype(jnp.bfloat16),)
        ws = W if isinstance(W, tuple) else (W.astype(jnp.bfloat16),)
        s = None
        for r in rs:
            for w in ws:
                t = jax.lax.dot_general(
                    r, w, dimension_numbers=(((1,), (0,)), ((), ())),
                    preferred_element_type=jnp.float32,
                )
                s = t if s is None else s + t
    else:
        s = jax.lax.dot_general(
            rows.astype(jnp.float32), W.astype(jnp.float32),
            dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
    if mask_from_rows:
        assert not isinstance(rows, tuple), (
            "mask_from_rows requires the single-array left operand (the"
            " user profile); plane-split left operands are user-based W"
            " rows, not profiles")
        s = jnp.where(rows != 0, -jnp.inf, s)
    if seen_mask is not None:
        s = jnp.where(seen_mask, -jnp.inf, s)
    vals, idx = tiled_topk(s, k)
    ps = jnp.take_along_axis(s, pair_ids, axis=1)
    fin = jnp.isfinite(ps)
    return vals, idx, jnp.where(fin, ps, 0.0), fin.astype(jnp.float32)


def split_bf16_planes(W: jnp.ndarray, passes: int = 2):
    """Decompose an f32 matrix into ``passes`` bfloat16 planes whose sum
    approximates it to ~8*passes mantissa bits (2 -> ~1e-5 relative, 3 ->
    f32-grade). Against a bf16-exact left operand, contracting plane-by-
    plane with f32 accumulation replaces the HIGHEST-precision f32 matmul
    with ``passes`` bf16 tensor-core products."""
    planes = []
    r = W
    for _ in range(passes - 1):
        p = r.astype(jnp.bfloat16)
        planes.append(p)
        r = r - p.astype(jnp.float32)
    planes.append(r.astype(jnp.bfloat16))
    return tuple(planes)
