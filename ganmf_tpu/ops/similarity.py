"""Column-wise similarity engines on the device.

Replaces the reference's blockwise host engines (Base/Similarity/
Compute_Similarity_Python.py:209-383, Compute_Similarity_Euclidean.py:83-236
and the Cython variant): the Gram matrix A^T A is one matmul over the
dense device-resident interaction matrix, the normalization family
(cosine / adjusted / asymmetric / pearson / jaccard / dice / tversky /
euclidean) is fused elementwise, and per-column top-K uses lax.top_k.
Only the final CSR assembly happens on host.
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sps

SIMILARITIES = ("cosine", "adjusted", "asymmetric", "pearson", "jaccard", "tanimoto", "dice", "tversky", "euclidean")

# Above this dense size the [n_rows, n_cols] data matrix never materializes
# on device; the Gram accumulates over padded-CSR row chunks instead
# (ML-20M's 138k x 26.7k dense URM is 14.8 GB). Same knob as the model
# layer's streaming policy.
_DENSE_A_BYTE_LIMIT = int(float(os.environ.get("GANMF_TPU_DENSE_URM_GB", "6")) * (1 << 30))


def _w_block(
    G: jnp.ndarray,  # [n_cand, n_targ_block] Gram block
    ss2_cand: jnp.ndarray,  # [n_cand] sum of squares per candidate column
    ss2_targ: jnp.ndarray,  # [n_targ_block] per target column
    targ_off,  # global index of the block's first target column
    n_rows: int,
    row_weights: jnp.ndarray,
    mode: str,
    shrink: float,
    normalize: bool,
    asymmetric_alpha: float,
    tversky_alpha: float,
    tversky_beta: float,
    normalize_avg_row: bool,
    distance_mode: str,
    use_row_weights: bool,
):
    """Similarity block W[i, j]: candidate item i (full axis) vs target
    column j of this block. The block form is what the sharded build maps
    over target-column shards; the single-device kernel is the one-block
    special case."""
    n_cand = G.shape[0]
    cand_idx = jax.lax.broadcasted_iota(jnp.int32, G.shape, 0)
    targ_idx = jax.lax.broadcasted_iota(jnp.int32, G.shape, 1) + targ_off
    eye = cand_idx == targ_idx

    if mode == "euclidean":
        # (a-b)^2 = a^2 + b^2 - 2ab; reference Compute_Similarity_Euclidean.py:170-207
        dist = ss2_targ[None, :] + ss2_cand[:, None] - 2.0 * G
        dist = jnp.where(eye, 0.0, dist)
        if use_row_weights:
            # reference scales item_distance[i] (the candidate axis) by
            # row_weights[i] (Compute_Similarity_Euclidean.py:181); it only
            # type-checks there when n_rows == n_cols. Candidate axis is
            # dim 0 in this kernel's [candidate, target] orientation.
            dist = dist * row_weights[:n_cand, None]
        if normalize:
            dist = dist / (jnp.sqrt(ss2_cand)[:, None] * jnp.sqrt(ss2_targ)[None, :])
        if normalize_avg_row:
            dist = dist / n_rows
        dist = jnp.sqrt(jnp.maximum(dist, 0.0))
        if distance_mode == "exp":
            W = 1.0 / (jnp.exp(dist) + shrink + 1e-9)
        elif distance_mode == "log":
            W = 1.0 / (jnp.log(dist + 1.0) + shrink + 1e-9)
        else:
            W = 1.0 / (dist + shrink + 1e-9)
        # items with identical interaction sets have distance exactly 0, so
        # euclidean similarity is full of large exact ties; lax.top_k's
        # lowest-index tie-break would concentrate every tied neighborhood
        # on the same few columns (the reference's argpartition spreads ties
        # arbitrarily). A hashed relative perturbation (~1e-6) spreads ties
        # deterministically without disturbing non-tied order. Hash inputs
        # are global indices, so sharded and single-device builds agree.
        h = (cand_idx.astype(jnp.uint32) * jnp.uint32(2654435761)
             + targ_idx.astype(jnp.uint32) * jnp.uint32(97777)) & jnp.uint32(0xFFFFF)
        W = W * (1.0 + 1e-6 * (h.astype(jnp.float32) / float(1 << 20)))
        W = jnp.where(eye, 0.0, W)
    else:
        W = jnp.where(eye, 0.0, G)
        if normalize:
            if mode == "asymmetric":
                # alpha weights the *target column* item j, (1 - alpha) the
                # candidate rows i (Compute_Similarity_Python.py:248-312)
                den = jnp.power(jnp.sqrt(ss2_cand), 2.0 * (1.0 - asymmetric_alpha))[:, None] * jnp.power(
                    jnp.sqrt(ss2_targ), 2.0 * asymmetric_alpha
                )[None, :] + shrink + 1e-6
            else:
                den = jnp.sqrt(ss2_cand)[:, None] * jnp.sqrt(ss2_targ)[None, :] + shrink + 1e-6
            W = W / den
        elif mode in ("jaccard", "tanimoto"):
            W = W / (ss2_cand[:, None] + ss2_targ[None, :] - W + shrink + 1e-6)
        elif mode == "dice":
            W = W / (ss2_cand[:, None] + ss2_targ[None, :] + shrink + 1e-6)
        elif mode == "tversky":
            # tversky_alpha weights the target column j, tversky_beta the
            # candidate rows i (Compute_Similarity_Python.py:328-332)
            W = W / (
                W
                + (ss2_targ[None, :] - W) * tversky_alpha
                + (ss2_cand[:, None] - W) * tversky_beta
                + shrink
                + 1e-6
            )
        elif shrink != 0:
            W = W / shrink

    # cold-item pairs yield 0/0 = NaN under the normalizations; the
    # reference leaves them in W but its sparse scoring never touches them
    # — dense scoring would propagate them, so zero them here
    return jnp.where(jnp.isnan(W), 0.0, W)


@functools.partial(
    jax.jit,
    static_argnames=("mode", "topk", "normalize", "normalize_avg_row", "distance_mode", "use_row_weights", "bf16_ok"),
)
def _similarity_topk(
    A: jnp.ndarray,  # [n_rows, n_cols] preprocessed data
    row_weights: jnp.ndarray,  # [n_rows] (ones when unused)
    mode: str,
    topk: int,
    shrink: float,
    normalize: bool,
    asymmetric_alpha: float,
    tversky_alpha: float,
    tversky_beta: float,
    normalize_avg_row: bool,
    distance_mode: str,
    use_row_weights: bool,
    bf16_ok: bool = False,
):
    hi = jax.lax.Precision.HIGHEST
    n_rows, n_cols = A.shape

    ss2 = jnp.sum(A * A, axis=0)  # sum of squares per column
    if use_row_weights and mode != "euclidean":
        G = jnp.dot((row_weights[:, None] * A).T, A, precision=hi)
    elif bf16_ok:
        # binary data: 0/1 are exact in bf16, products are 0/1, and the
        # product accumulates in f32 (co-rating counts < 2^24) — the
        # one-pass bf16 Gram is BITWISE equal to the f32-HIGHEST build
        # (scripts/bf16_gram_receipt.py checks it on the device)
        Ab = A.astype(jnp.bfloat16)
        G = jnp.dot(Ab.T, Ab, preferred_element_type=jnp.float32)
    else:
        G = jnp.dot(A.T, A, precision=hi)  # [n_cols, n_cols]

    W = _w_block(
        G, ss2, ss2, 0, n_rows, row_weights, mode, shrink, normalize,
        asymmetric_alpha, tversky_alpha, tversky_beta, normalize_avg_row,
        distance_mode, use_row_weights,
    )

    # W[i, j]: similarity of row-item i to column-item j; reference keeps the
    # top-K per *column* (note the reference normalizes with the column item
    # in the first denominator slot; here rows carry ss2_cand == "all
    # items", columns the target item, matching its orientation).
    from ganmf_tpu.ops.topk import tiled_topk

    vals, idx = tiled_topk(W.T, topk)  # per column j: top rows i
    return vals, idx


@functools.partial(jax.jit, static_argnames=("n_cols", "chunk", "use_row_weights", "bf16_ok"))
def _gram_streamed(idx, val, w_pad, n_cols: int, chunk: int, use_row_weights: bool,
                   bf16_ok: bool = False):
    """G = A^T diag(w) A accumulated over padded-CSR row chunks.

    The dense [n_rows, n_cols] matrix never exists: each chunk scatters its
    rows into a [chunk, n_cols] block (pad rows carry the sentinel column
    n_cols and value 0, so they contribute nothing) and the matmul
    accumulates chunk.T @ chunk into the f32 Gram. FLOPs are identical to the one-shot
    matmul; HBM peaks at G + one chunk instead of the full matrix.

    ``bf16_ok`` (binary data, no row weights): the chunk scatters and
    multiplies in bf16 — exact for 0/1 values with disjoint CSR columns —
    halving the dominant HBM scatter traffic and replacing the f32
    HIGHEST product with one bf16 product; the f32 accumulator keeps the
    result bitwise equal (receipt: scripts/bf16_gram_receipt.py)."""
    hi = jax.lax.Precision.HIGHEST
    n_chunks = idx.shape[0] // chunk
    dt = jnp.bfloat16 if bf16_ok else jnp.float32

    def body(c, G):
        bi = jax.lax.dynamic_slice_in_dim(idx, c * chunk, chunk)  # [C, L]
        bv = jax.lax.dynamic_slice_in_dim(val, c * chunk, chunk)
        D = jnp.zeros((chunk, n_cols + 1), dt)
        D = D.at[jnp.arange(chunk)[:, None], bi].add(bv.astype(dt))[:, :n_cols]
        if use_row_weights:
            w = jax.lax.dynamic_slice_in_dim(w_pad, c * chunk, chunk)
            left = w[:, None] * D
        else:
            left = D
        if bf16_ok:
            return G + jnp.dot(left.T, D, preferred_element_type=jnp.float32)
        return G + jnp.dot(left.T, D, precision=hi)

    G0 = jnp.zeros((n_cols, n_cols), jnp.float32)
    return jax.lax.fori_loop(0, n_chunks, body, G0)


@functools.partial(jax.jit, static_argnames=("chunk",))
def _gram_resident_bf16(Ab, chunk: int):
    """G = A^T A over a RESIDENT dense bf16 A — no per-chunk scatter.

    _gram_streamed re-scatters every padded-CSR row chunk into a dense
    block before its matmul; when the whole bf16 matrix fits in HBM
    (7.4 GB at ML-20M) that scatter traffic is pure overhead — the same
    diagnosis that motivated the resident-A randomized SVD
    (models/puresvd.py) and the int8 column-blocked build (:338). Each
    pass slices ``chunk`` resident rows and lets the matmul accumulate
    slice^T @ slice into the f32 Gram: identical chunking, dtype and
    accumulation order to _gram_streamed's bf16 path, so the result is
    bitwise-equal (asserted in tests/test_similarity.py)."""
    R, I = Ab.shape
    n_chunks = R // chunk

    def body(c, G):
        D = jax.lax.dynamic_slice_in_dim(Ab, c * chunk, chunk)
        return G + jax.lax.dot_general(
            D, D, (((0,), (0,)), ((), ())), preferred_element_type=jnp.float32
        )

    return jax.lax.fori_loop(0, n_chunks, body, jnp.zeros((I, I), jnp.float32))


@functools.partial(
    jax.jit,
    static_argnames=("mode", "topk", "n_rows", "normalize", "normalize_avg_row", "distance_mode", "use_row_weights"),
)
def _similarity_topk_from_gram(
    G: jnp.ndarray,  # [n_cols, n_cols] precomputed Gram (row weights applied)
    ss2: jnp.ndarray,  # [n_cols] per-column sum of squares
    row_weights: jnp.ndarray,
    n_rows: int,
    mode: str,
    topk: int,
    shrink: float,
    normalize: bool,
    asymmetric_alpha: float,
    tversky_alpha: float,
    tversky_beta: float,
    normalize_avg_row: bool,
    distance_mode: str,
    use_row_weights: bool,
):
    """Tail of _similarity_topk for a Gram built elsewhere (streamed or
    host): same normalization kernel, same per-column top-K."""
    W = _w_block(
        G, ss2, ss2, 0, n_rows, row_weights, mode, shrink, normalize,
        asymmetric_alpha, tversky_alpha, tversky_beta, normalize_avg_row,
        distance_mode, use_row_weights,
    )
    from ganmf_tpu.ops.topk import tiled_topk

    return tiled_topk(W.T, topk)


# Above this Gram size (bytes of the f32 [I, I] matrix) the streamed build
# processes target columns in blocks: the full Gram never materializes, so
# single-device builds clear the memory ceiling on the catalog size (f32 G
# at I=64k is 17 GB). Override with $GANMF_TPU_GRAM_GB.
_GRAM_BYTE_LIMIT = int(float(os.environ.get("GANMF_TPU_GRAM_GB", "6")) * (1 << 30))

# HBM budget for keeping a binary interaction matrix resident as dense int8
# (1 byte/element) during a column-blocked build.
_INT8_A_BYTE_LIMIT = int(float(os.environ.get("GANMF_TPU_INT8_A_GB", "9")) * (1 << 30))



def _device_memory_bytes() -> int:
    """Bytes the default device lets this process allocate, which sizes
    slabs that must coexist with a resident A8. A device that reports no
    limit is an error: a guessed size would route builds blind."""
    dev = jax.devices()[0]
    limit = (dev.memory_stats() or {}).get("bytes_limit")
    if not limit:
        raise RuntimeError(
            f"{dev.platform} device {dev.device_kind!r} reports no memory limit"
            " (memory_stats()['bytes_limit']); cannot size the column-blocked"
            " similarity build")
    return int(limit)


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_rows", "n_cols", "chunk", "width", "mode", "topk", "shrink",
        "normalize", "asymmetric_alpha", "tversky_alpha", "tversky_beta",
        "normalize_avg_row", "distance_mode", "use_row_weights", "bf16_ok",
    ),
)
def _similarity_topk_colblock(
    idx, val, w_pad, ss2, rw, off,
    *, n_rows: int, n_cols: int, chunk: int, width: int, mode: str, topk: int,
    shrink: float, normalize: bool, asymmetric_alpha: float,
    tversky_alpha: float, tversky_beta: float, normalize_avg_row: bool,
    distance_mode: str, use_row_weights: bool, bf16_ok: bool,
):
    """One target-column block of the streamed similarity build: accumulate
    the [n_cols, width] Gram slab over padded-CSR row chunks, normalize with
    _w_block and rank the block's columns. ``off`` is traced, so every block
    shares one compiled program. HBM peak is one slab + one chunk — the
    full [I, I] Gram never exists."""
    hi = jax.lax.Precision.HIGHEST
    n_chunks = idx.shape[0] // chunk
    dt = jnp.bfloat16 if bf16_ok else jnp.float32
    gram_rw = use_row_weights and mode != "euclidean"

    def body(c, G):
        bi = jax.lax.dynamic_slice_in_dim(idx, c * chunk, chunk)  # [C, L]
        bv = jax.lax.dynamic_slice_in_dim(val, c * chunk, chunk)
        D = jnp.zeros((chunk, n_cols + 1), dt)
        D = D.at[jnp.arange(chunk)[:, None], bi].add(bv.astype(dt))[:, :n_cols]
        T = jax.lax.dynamic_slice(D, (0, off), (chunk, width))
        if gram_rw:
            w = jax.lax.dynamic_slice_in_dim(w_pad, c * chunk, chunk)
            left = w[:, None] * D.astype(jnp.float32)
            return G + jnp.dot(left.T, T.astype(jnp.float32), precision=hi)
        if bf16_ok:
            return G + jnp.dot(D.T, T, preferred_element_type=jnp.float32)
        return G + jnp.dot(D.T, T, precision=hi)

    G = jax.lax.fori_loop(0, n_chunks, body, jnp.zeros((n_cols, width), jnp.float32))
    ss2_targ = jax.lax.dynamic_slice(ss2, (off,), (width,))
    W = _w_block(
        G, ss2, ss2_targ, off, n_rows, rw, mode, shrink, normalize,
        asymmetric_alpha, tversky_alpha, tversky_beta, normalize_avg_row,
        distance_mode, use_row_weights,
    )
    from ganmf_tpu.ops.topk import tiled_topk

    return tiled_topk(W.T, topk)  # [width, k] for this block's columns


@functools.partial(jax.jit, static_argnames=("n_cols", "chunk"))
def _dense_int8_from_padded(idx, val, n_cols: int, chunk: int):
    """Materialize the binary interaction matrix as a dense int8 [R, n_cols]
    (1 byte/element — fits HBM where f32/bf16 do not). Built chunk-by-chunk
    from the padded-CSR planes; values are guaranteed 0/1 here."""
    R = idx.shape[0]
    n_chunks = R // chunk

    def body(c, A):
        bi = jax.lax.dynamic_slice_in_dim(idx, c * chunk, chunk)
        bv = jax.lax.dynamic_slice_in_dim(val, c * chunk, chunk)
        D = jnp.zeros((chunk, n_cols + 1), jnp.int8)
        D = D.at[jnp.arange(chunk)[:, None], bi].add(bv.astype(jnp.int8))[:, :n_cols]
        return jax.lax.dynamic_update_slice(A, D, (c * chunk, 0))

    return jax.lax.fori_loop(0, n_chunks, body, jnp.zeros((R, n_cols), jnp.int8))


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_rows", "width", "mode", "topk", "shrink", "normalize",
        "asymmetric_alpha", "tversky_alpha", "tversky_beta",
        "normalize_avg_row", "distance_mode", "use_row_weights",
    ),
)
def _similarity_topk_colblock_int8(
    A8, ss2, rw, off,
    *, n_rows: int, width: int, mode: str, topk: int, shrink: float,
    normalize: bool, asymmetric_alpha: float, tversky_alpha: float,
    tversky_beta: float, normalize_avg_row: bool, distance_mode: str,
    use_row_weights: bool,
):
    """int8 A-resident variant of the column-blocked build for binary data:
    the dense int8 matrix is read once per slab by the matmul (int8 x int8 ->
    int32 accumulate, exact for 0/1 counts) instead of re-scattering every
    row chunk per slab — scatter traffic was the dominant cost of the
    bf16 slab build at I = 65,536."""
    n_cols = A8.shape[1]
    A8b = jax.lax.dynamic_slice(A8, (0, off), (A8.shape[0], width))
    G = jax.lax.dot_general(
        A8, A8b, (((0,), (0,)), ((), ())), preferred_element_type=jnp.int32
    ).astype(jnp.float32)  # exact: co-rating counts < 2^24
    ss2_targ = jax.lax.dynamic_slice(ss2, (off,), (width,))
    W = _w_block(
        G, ss2, ss2_targ, off, n_rows, rw, mode, shrink, normalize,
        asymmetric_alpha, tversky_alpha, tversky_beta, normalize_avg_row,
        distance_mode, use_row_weights,
    )
    from ganmf_tpu.ops.topk import tiled_topk

    return tiled_topk(W.T, topk)


def _similarity_topk_sharded(
    A: jnp.ndarray,
    row_weights: jnp.ndarray,
    plan,
    *,
    mode: str,
    topk: int,
    shrink: float,
    normalize: bool,
    asymmetric_alpha: float,
    tversky_alpha: float,
    tversky_beta: float,
    normalize_avg_row: bool,
    distance_mode: str,
    use_row_weights: bool,
    bf16_ok: bool = False,
):
    """Item-column-sharded similarity build (VERDICT r2 #6): each chip of
    the mesh's model axis computes the Gram block of *its* target columns
    against the full candidate axis — the [I, I] intermediate never
    materializes on one chip (per-chip footprint I * I / n_model) — and
    ranks its columns locally, so no cross-shard top-K merge is needed.
    Target columns are zero-padded to a multiple of the shard count; padded
    targets are sliced off after the gather."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from ganmf_tpu.parallel.mesh import MODEL_AXIS
    from ganmf_tpu.ops.topk import tiled_topk

    hi = jax.lax.Precision.HIGHEST
    n_rows, n_cols = A.shape
    n_shards = plan.n_model
    pad = (-n_cols) % n_shards
    Ap = jnp.pad(A, ((0, 0), (0, pad))) if pad else A
    width = (n_cols + pad) // n_shards

    def local(A_full, rw):
        off = jax.lax.axis_index(MODEL_AXIS) * width
        A_blk = jax.lax.dynamic_slice(A_full, (0, off), (A_full.shape[0], width))
        ss2_cand = jnp.sum(A_full * A_full, axis=0)
        ss2_targ = jnp.sum(A_blk * A_blk, axis=0)
        if use_row_weights and mode != "euclidean":
            G = jnp.dot((rw[:, None] * A_full).T, A_blk, precision=hi)
        elif bf16_ok:
            # exact for binary data (see _similarity_topk)
            G = jnp.dot(A_full.astype(jnp.bfloat16).T, A_blk.astype(jnp.bfloat16),
                        preferred_element_type=jnp.float32)
        else:
            G = jnp.dot(A_full.T, A_blk, precision=hi)  # [n_cols, width]
        W = _w_block(
            G, ss2_cand, ss2_targ, off, n_rows, rw, mode, shrink, normalize,
            asymmetric_alpha, tversky_alpha, tversky_beta, normalize_avg_row,
            distance_mode, use_row_weights,
        )
        # padded candidate columns must never be selected: -inf (not 0)
        # so they also rank below genuine negative similarities, exactly
        # like the single-device build where they don't exist at all
        if pad:
            cand = jnp.arange(A_full.shape[1])
            W = jnp.where((cand >= n_cols)[:, None], -jnp.inf, W)
        vals, idx = tiled_topk(W.T, topk)  # [width, k] per shard
        return jnp.where(jnp.isfinite(vals), vals, 0.0), idx

    fn = jax.jit(
        shard_map(
            local,
            mesh=plan.mesh,
            in_specs=(P(None, None), P(None)),
            out_specs=(P(MODEL_AXIS, None), P(MODEL_AXIS, None)),
            check_vma=False,
        )
    )
    if use_row_weights and mode == "euclidean":
        # euclidean weights index the candidate (column) axis, which is
        # padded here; compute_similarity has already validated
        # n_rows == n_cols for this combination
        row_weights = jnp.pad(row_weights, (0, max(0, Ap.shape[1] - row_weights.shape[0])))
    vals, idx = fn(Ap, row_weights)
    return vals[:n_cols], idx[:n_cols]


def compute_similarity(
    data_matrix,
    similarity: str = "cosine",
    topK: int = 100,
    shrink: float = 0,
    normalize: bool = True,
    asymmetric_alpha: float = 0.5,
    tversky_alpha: float = 1.0,
    tversky_beta: float = 1.0,
    normalize_avg_row: bool = False,
    similarity_from_distance_mode: str = "lin",
    row_weights: Optional[np.ndarray] = None,
    mesh_plan=None,
    export: str = "csr",
    **_unused,
):
    """Column-to-column similarity with top-K pruning.

    Drop-in equivalent of the reference Compute_Similarity dispatcher
    (Base/Similarity/Compute_Similarity.py:29-107) with every implementation
    unified on one device kernel. Returns CSR [n_cols, n_cols] where column
    j holds the top-K most similar items to j (zeros dropped).

    ``mesh_plan``: shard the [I, I] build over the mesh's model axis — each
    chip holds only its target-column slice of the Gram/similarity matrix,
    removing the single-chip HBM ceiling on the catalog size.

    ``export="device"``: return the pruned W as a dense device-resident
    [I, I] array instead of host CSR — nothing leaves the device, so the
    build cost is pure device time (no [I, k] readback). Values are identical to the CSR export (exact zeros
    dropped either way on conversion). Not available with ``mesh_plan``,
    whose purpose is never materializing [I, I] on one chip.
    """
    if similarity not in SIMILARITIES:
        raise ValueError(f"similarity must be one of {SIMILARITIES}, got '{similarity}'")

    X = sps.csr_matrix(data_matrix, dtype=np.float32).copy()
    n_rows, n_cols = X.shape
    if row_weights is not None and similarity == "euclidean" and n_rows != n_cols:
        # the reference's euclidean row-weighting multiplies per-candidate
        # distances by per-row weights and only type-checks when the matrix
        # is square (Compute_Similarity_Euclidean.py:181); fail loudly
        # rather than silently truncating the weight vector
        raise ValueError(
            f"euclidean row_weights requires a square matrix, got {X.shape}"
        )
    topK = min(topK, n_cols)

    # preprocessing (Compute_Similarity_Python.py:117-204)
    if similarity == "adjusted":
        nnz_per_row = np.diff(X.indptr)
        row_sum = np.asarray(X.sum(axis=1)).ravel()
        avg = np.divide(row_sum, nnz_per_row, out=np.zeros_like(row_sum), where=nnz_per_row > 0)
        X.data = X.data - np.repeat(avg, nnz_per_row)
        mode = "cosine"
    elif similarity == "pearson":
        Xc = X.tocsc()
        nnz_per_col = np.diff(Xc.indptr)
        col_sum = np.asarray(Xc.sum(axis=0)).ravel()
        avg = np.divide(col_sum, nnz_per_col, out=np.zeros_like(col_sum), where=nnz_per_col > 0)
        Xc.data = Xc.data - np.repeat(avg, nnz_per_col)
        X = Xc.tocsr()
        mode = "cosine"
    elif similarity in ("jaccard", "tanimoto", "dice", "tversky"):
        X.data = np.ones_like(X.data)
        mode = "jaccard" if similarity == "tanimoto" else similarity
        # the binary-set similarities carry their own normalization; the
        # reference force-disables cosine normalization for them
        # (Compute_Similarity_Python.py:77-87)
        normalize = False
    else:
        mode = similarity

    rw = jnp.asarray(
        np.asarray(row_weights, dtype=np.float32) if row_weights is not None else np.ones(n_rows, np.float32)
    )

    # Binary data (every implicit-feedback URM, and the jaccard/dice/tversky
    # families which binarize above) takes the one-pass bf16 Gram: bitwise
    # equal to f32-HIGHEST, in one bf16 product. Opt out with
    # GANMF_TPU_BF16_GRAM=0. Centered data (adjusted/pearson) and explicit
    # ratings stay on the f32-HIGHEST floor — bf16 would round their values.
    bf16_ok = (
        row_weights is None
        and bool(X.nnz == 0 or np.all(X.data == 1.0))
        and os.environ.get("GANMF_TPU_BF16_GRAM", "1") != "0"
    )

    kernel_kwargs = dict(
        mode=mode,
        topk=topK,
        shrink=float(shrink),
        normalize=bool(normalize),
        asymmetric_alpha=float(asymmetric_alpha),
        tversky_alpha=float(tversky_alpha),
        tversky_beta=float(tversky_beta),
        normalize_avg_row=bool(normalize_avg_row),
        distance_mode=similarity_from_distance_mode,
        use_row_weights=row_weights is not None,
    )
    if export not in ("csr", "device"):
        raise ValueError(f"export must be 'csr' or 'device', got '{export}'")

    streamed = (
        4 * n_rows * n_cols > _DENSE_A_BYTE_LIMIT
        and (mesh_plan is None or mesh_plan.n_model <= 1)
    )
    if streamed:
        # beyond the dense-HBM budget: accumulate the Gram over padded-CSR
        # row chunks, then run the identical normalize+top-K program on it
        from ganmf_tpu.data.device import padded_csr_from_sparse

        chunk = 2048
        pc = padded_csr_from_sparse(X)
        pad_rows = (-n_rows) % chunk
        idx_a, val_a = pc.idx, pc.val
        if pad_rows:
            idx_a = jnp.concatenate(
                [idx_a, jnp.full((pad_rows, idx_a.shape[1]), n_cols, dtype=idx_a.dtype)]
            )
            val_a = jnp.concatenate([val_a, jnp.zeros((pad_rows, val_a.shape[1]), val_a.dtype)])
        w_pad = jnp.concatenate([rw, jnp.zeros((pad_rows,), rw.dtype)]) if pad_rows else rw
        # row weights fold into the Gram except for euclidean, whose
        # reference semantics weight the distances (handled in _w_block)
        gram_rw = kernel_kwargs["use_row_weights"] and mode != "euclidean"
        ss2 = jnp.asarray(np.asarray(X.multiply(X).sum(axis=0), dtype=np.float32).ravel())
        if 4 * n_cols * n_cols > _GRAM_BYTE_LIMIT:
            # the full f32 Gram would blow the HBM budget: rank target
            # columns in slabs; every block reuses one compiled program
            # (off is traced) and readback is [width, k] per block
            if export == "device":
                raise ValueError(
                    "export='device' materializes [I, I] on one chip; the "
                    "column-blocked build exists because that does not fit"
                )
            width = int(min(n_cols, max(512, _GRAM_BYTE_LIMIT // 2 // (4 * n_cols) // 256 * 256)))
            # binary data whose dense int8 matrix fits the budget: keep A
            # resident (1 byte/elem) and read it per slab by a matmul
            # instead of re-scattering every row chunk per slab
            n_rows_pad = idx_a.shape[0]
            use_int8 = (
                bf16_ok and not gram_rw
                and n_rows_pad * n_cols <= _INT8_A_BYTE_LIMIT
            )
            if use_int8:
                # the resident A8 eats into the slab budget: per width unit
                # the program holds ~24 B/column of temps (Gram f32 + int32
                # dot output + the top-k sort's value/iota/copy buffers), so
                # cap the slab to what fits beside A8 in the device's memory
                free = _device_memory_bytes() - n_rows_pad * n_cols - (1 << 30)
                w_int8 = free // (24 * n_cols) // 256 * 256
                if w_int8 >= 512:
                    width = int(min(width, w_int8))
                else:
                    use_int8 = False  # no useful slab fits beside A8
            A8 = _dense_int8_from_padded(idx_a, val_a, n_cols=n_cols, chunk=chunk) if use_int8 else None
            vals_np = np.empty((n_cols, topK), np.float32)
            idx_np = np.empty((n_cols, topK), np.int64)
            done = 0
            while done < n_cols:
                off = min(done, n_cols - width)
                if use_int8:
                    v_b, i_b = _similarity_topk_colblock_int8(
                        A8, ss2, rw, off, n_rows=n_rows, width=width, **kernel_kwargs,
                    )
                else:
                    v_b, i_b = _similarity_topk_colblock(
                        idx_a, val_a, w_pad, ss2, rw, off,
                        n_rows=n_rows, n_cols=n_cols, chunk=chunk, width=width,
                        bf16_ok=bf16_ok and not gram_rw, **kernel_kwargs,
                    )
                # the last block may overlap already-done columns; keep the tail
                skip = done - off
                vals_np[done : off + width] = np.asarray(v_b)[skip:]
                idx_np[done : off + width] = np.asarray(i_b)[skip:]
                done = off + width
            vals, idx = vals_np, idx_np
        else:
            n_rows_pad = idx_a.shape[0]
            # binary data whose dense bf16 matrix fits beside the f32 Gram
            # and the padded planes: keep A resident and accumulate the
            # Gram from resident row slices — drops the per-chunk scatter
            # that dominates _gram_streamed
            resident = (
                bf16_ok and not gram_rw
                and 2 * n_rows_pad * n_cols            # resident bf16 A
                + 4 * n_cols * n_cols                  # f32 Gram
                + 8 * n_rows_pad * idx_a.shape[1]      # padded idx+val planes
                + (1 << 30)
                <= _device_memory_bytes()
            )
            if resident:
                from ganmf_tpu.data.device import dense_bf16_from_padded

                Ab = dense_bf16_from_padded(idx_a, val_a, n_cols=n_cols, chunk=chunk)
                # free the padded copies before the Gram lands (the
                # unconcatenated planes stay memoized on the train matrix)
                del idx_a, val_a, pc
                G = _gram_resident_bf16(Ab, chunk=chunk)
                del Ab
            else:
                G = _gram_streamed(idx_a, val_a, w_pad, n_cols=n_cols, chunk=chunk,
                                   use_row_weights=gram_rw, bf16_ok=bf16_ok and not gram_rw)
            vals, idx = _similarity_topk_from_gram(G, ss2, rw, n_rows, **kernel_kwargs)
            if export == "device":
                from ganmf_tpu.ops.topk import scatter_col_topk_dense

                return scatter_col_topk_dense(vals, idx)
    else:
        from ganmf_tpu.data.device import dense_from_sparse

        A = dense_from_sparse(X)
        if mesh_plan is not None and mesh_plan.n_model > 1:
            vals, idx = _similarity_topk_sharded(A, rw, mesh_plan, bf16_ok=bf16_ok, **kernel_kwargs)
            if export == "device":
                raise ValueError("export='device' materializes [I, I] on one chip; use export='csr' with mesh_plan")
        else:
            vals, idx = _similarity_topk(A, rw, bf16_ok=bf16_ok, **kernel_kwargs)
            if export == "device":
                from ganmf_tpu.ops.topk import scatter_col_topk_dense

                return scatter_col_topk_dense(vals, idx)
    vals = np.asarray(vals, dtype=np.float32)  # [n_cols, topK] per column
    idx = np.asarray(idx)

    keep = vals != 0.0  # reference drops exact zeros from the top-K
    counts = keep.sum(axis=1)
    indptr = np.zeros(n_cols + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    data = vals[keep]
    indices = idx[keep]
    W = sps.csc_matrix((data, indices, indptr), shape=(n_cols, n_cols), dtype=np.float32)
    return W.tocsr()
