"""Top-K ranking ops, including the cross-shard merge.

When scores are sharded over the item (model) axis, ranking is a
per-shard ``lax.top_k`` followed by an all-gather of the k candidates per
shard and a final re-rank — exact whenever k <= shard width (SURVEY §5.7:
the analogue of ring/Ulysses merging for the item "context" axis).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from typing import TYPE_CHECKING

if TYPE_CHECKING:  # deferred: parallel/__init__ imports the GAN models,
    # which import this module's smallest_k_mask (cycle otherwise)
    from ganmf_tpu.parallel.mesh import MeshPlan


def tiled_topk(w: jnp.ndarray, k: int, tile: int = 2048):
    """Exact top-k per row via per-tile selection + candidate merge.

    Splitting the row into `tile`-wide chunks, taking the per-chunk top-k
    and re-ranking the T*k candidates is value-identical to a full-width
    ``lax.top_k`` (ties resolve to the lower global index in both) but
    avoids a full-row sort: the sorted footprint shrinks from n to T*k per
    row.
    """
    r, n = w.shape
    if n <= tile:
        return jax.lax.top_k(w, k)
    kk = min(k, tile)
    pad = (-n) % tile
    wp = jnp.pad(w, ((0, 0), (0, pad)), constant_values=-jnp.inf) if pad else w
    T = (n + pad) // tile
    v, i = jax.lax.top_k(wp.reshape(r, T, tile), kk)  # [r, T, kk]
    i = i + (jnp.arange(T, dtype=jnp.int32) * tile)[None, :, None]
    vv, pos = jax.lax.top_k(v.reshape(r, T * kk), k)
    return vv, jnp.take_along_axis(i.reshape(r, T * kk), pos, axis=1)


@jax.jit
def scatter_col_topk_dense(vals: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """Dense [n, n] W from per-column top-K candidates: W[idx[j, t], j] =
    vals[j, t], zeros elsewhere.

    The device-authoritative export of a column-pruned similarity build:
    equivalent to the host CSC assembly (exact zeros are dropped by CSR
    conversion either way) but nothing leaves the device: no [n, k]
    vals+idx readback.
    """
    n = vals.shape[0]
    cols = jnp.broadcast_to(jnp.arange(n, dtype=idx.dtype)[:, None], idx.shape)
    return jnp.zeros((n, n), vals.dtype).at[idx, cols].set(vals)


def smallest_k_mask(keys: jnp.ndarray, k: jnp.ndarray) -> jnp.ndarray:
    """Boolean mask of each row's ``k[r]`` smallest entries, ties by index.

    Bitwise-identical to the rank-table construction
    ``argsort(argsort(keys, axis=1), axis=1) < k[:, None]`` (stable sort:
    ties resolve to the lower index) but does NO sort at all: the k-th
    order statistic is found by a 32-step bisection over the monotone
    uint32 bitcast of the keys (count rows <= mid per step), then the mask
    is "strictly below the threshold, plus the lowest-indexed ties at it"
    via one cumsum. Each step is a streaming compare+row-sum, so the whole
    draw is bound by device-memory bandwidth instead of paying a sort.
    Verified bitwise-equal on tied, negative and +inf keys
    (tests/test_aux.py, tests/test_select.py). Used by the CFGAN ZR/PM
    samplers and CAAE's Nu draw (cython_utils.pyx:48-66 / CAAE.py:277-285
    semantics).
    """
    b = jax.lax.bitcast_convert_type(keys, jnp.uint32)
    # order-preserving map of IEEE-754 onto uint32 (no NaNs in our keys)
    u = jnp.where(b >> 31 == 1, ~b, b | jnp.uint32(0x80000000))
    lo = jnp.zeros((keys.shape[0],), jnp.uint32)
    hi = jnp.full((keys.shape[0],), 0xFFFFFFFF, jnp.uint32)

    def body(_, lohi):
        lo, hi = lohi
        mid = lo + (hi - lo) // 2
        ge = jnp.sum(u <= mid[:, None], axis=1) >= k
        return jnp.where(ge, lo, mid + 1), jnp.where(ge, mid, hi)

    lo, _ = jax.lax.fori_loop(0, 32, body, (lo, hi))
    thresh = lo[:, None]
    eq = u == thresh
    needed = k[:, None] - jnp.sum(u < thresh, axis=1, keepdims=True)
    sel = (u < thresh) | (eq & (jnp.cumsum(eq.astype(jnp.int32), axis=1) <= needed))
    return sel & (k[:, None] > 0)


def sharded_topk(scores: jnp.ndarray, k: int, plan: "MeshPlan", batch_axes=None):
    """Exact top-k of item-sharded scores with a candidate all-gather merge.

    scores: [B, I] laid out (batch_axes, model) — batch_axes defaults to
    replicated, pass ``plan.user_axes`` when the block rows are sharded
    too. Returns (values [B, k], global indices [B, k]) laid out
    (batch_axes, replicated). Exact whenever k <= I / n_model; both B and
    I must divide evenly over their mesh axes (shard_map requirement).
    """
    from ganmf_tpu.parallel.mesh import MODEL_AXIS

    def local(block):  # [B / n_user_shards, I / n_model] per shard
        v, i = jax.lax.top_k(block, k)
        offset = jax.lax.axis_index(MODEL_AXIS) * block.shape[1]
        i = i + offset
        v_all = jax.lax.all_gather(v, MODEL_AXIS, axis=1, tiled=True)  # [b, n*k]
        i_all = jax.lax.all_gather(i, MODEL_AXIS, axis=1, tiled=True)
        vv, pos = jax.lax.top_k(v_all, k)
        return vv, jnp.take_along_axis(i_all, pos, axis=1)

    fn = shard_map(
        local,
        mesh=plan.mesh,
        in_specs=P(batch_axes, MODEL_AXIS),
        out_specs=(P(batch_axes, None), P(batch_axes, None)),
        # outputs are replicated over model by the all_gather + re-rank;
        # the static varying-manual-axes check cannot prove it
        check_vma=False,
    )
    return fn(scores)
