"""HBM-resident dense views of sparse interaction matrices.

The reference densifies CSR rows on host every minibatch
(reference: GANRec/GANMF.py:184). On the device the entire URM fits in
memory for any dataset this framework targets at single-device scale
(<= a few GB dense), so we materialize it once and let every train/eval
step gather rows on device. For multi-device runs the dense matrix is sharded over the mesh's user axis
(see ganmf_tpu.parallel).
"""

from __future__ import annotations

import functools
import hashlib
import os
from collections import OrderedDict
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sps


@functools.partial(jax.jit, static_argnames=("shape",))
def _segment_dense(lin_idx: jnp.ndarray, data: jnp.ndarray, shape):
    # one flat segment_sum over linear indices instead of a 2D .at[].set
    # scatter: a sorted 1D scatter-add, cheap to compile at catalog sizes
    flat = jax.ops.segment_sum(data, lin_idx, num_segments=shape[0] * shape[1])
    return flat.reshape(shape)


def dense_from_sparse(mat: sps.spmatrix, sharding=None) -> jnp.ndarray:
    """Densify on device: ship only the COO triplets (nnz * 12 bytes) and
    segment-sum into an HBM zeros buffer. On a host->device link this beats
    transferring the dense matrix by the sparsity factor (the reference
    datasets are 95-99.9% sparse)."""
    R, C = mat.shape
    if R * C >= 2**31:  # linear int32 indexing would overflow
        dense = np.asarray(mat.todense(), dtype=np.float32)
        out = jnp.asarray(dense)
    else:
        coo = mat.tocoo()
        coo.sum_duplicates()
        lin = coo.row.astype(np.int64) * C + coo.col.astype(np.int64)
        out = _segment_dense(
            jnp.asarray(lin.astype(np.int32)),
            jnp.asarray(coo.data.astype(np.float32)),
            shape=(R, C),
        )
    if sharding is not None:
        out = jax.device_put(out, sharding)
    return out


class DeviceURM:
    """Device-resident dense URM plus cached derived tensors."""

    def __init__(self, urm: sps.spmatrix, dtype=jnp.float32, sharding=None):
        urm = urm.tocsr().astype(np.float32)
        urm.eliminate_zeros()
        self.shape = urm.shape
        self.nnz = urm.nnz
        self._csr = urm
        arr = dense_from_sparse(urm, sharding=sharding)
        if dtype != jnp.float32:
            arr = arr.astype(dtype)
        self.dense = arr
        self._mask: Optional[jnp.ndarray] = None

    @property
    def csr(self) -> sps.csr_matrix:
        return self._csr

    @property
    def mask(self) -> jnp.ndarray:
        """Boolean interaction mask (True where an interaction exists)."""
        if self._mask is None:
            self._mask = self.dense != 0
        return self._mask

    def rows(self, user_ids: jnp.ndarray) -> jnp.ndarray:
        """Gather dense profile rows on device."""
        return jnp.take(self.dense, user_ids, axis=0)

    def item_popularity(self) -> np.ndarray:
        return np.ediff1d(self._csr.tocsc().indptr)


# content-digest -> PaddedCSR LRU (see padded_csr_from_sparse)
_PADDED_CACHE: "OrderedDict[str, PaddedCSR]" = OrderedDict()
_PADDED_CACHE_CAP = int(os.environ.get("GANMF_TPU_PADDED_CACHE", "4"))


class PaddedCSR(NamedTuple):
    """Row-padded sparse matrix resident in HBM: ``idx[r]`` holds row r's
    column indices padded with the ``n_cols`` sentinel, ``val[r]`` the
    values padded with 0. Memory is O(rows * max_row_nnz) instead of
    O(rows * cols) — the streamed-URM storage for datasets whose dense
    [U, I] would not fit HBM (SURVEY §5.7 long-context analogue)."""

    idx: jnp.ndarray  # [R, L] int32
    val: jnp.ndarray  # [R, L] float32


@functools.partial(jax.jit, static_argnames=("R", "L", "C", "binary"))
def _padded_build(indptr, cols, vals, R: int, L: int, C: int, binary: bool):
    """Build the padded [R, L] idx/val planes on device from CSR arrays.

    Row ids are recovered from indptr with one log(R) searchsorted sweep and
    the entries scatter through segment_sum (the fast scatter lowering on
    this toolchain, see _segment_dense). Slots beyond each row's length get
    the sentinel column C / value 0; for binary matrices the value plane is
    synthesized on device and never transferred."""
    nnz = cols.shape[0]
    pos = jnp.arange(nnz, dtype=jnp.int32)
    rows = jnp.searchsorted(indptr, pos, side="right").astype(jnp.int32) - 1
    offs = pos - jnp.take(indptr, rows)
    lin = rows * L + offs
    lens = jnp.diff(indptr)
    fill = jax.lax.broadcasted_iota(jnp.int32, (R, L), 1) < lens[:, None]
    idx = jax.ops.segment_sum(cols, lin, num_segments=R * L).reshape(R, L)
    idx = jnp.where(fill, idx, C)
    if binary:
        val = fill.astype(jnp.float32)
    else:
        val = jax.ops.segment_sum(vals, lin, num_segments=R * L).reshape(R, L)
    return idx, val


def padded_csr_from_sparse(mat: sps.spmatrix, cache: bool = True) -> PaddedCSR:
    """Host work and host->device traffic are O(nnz): the padded [R, L]
    planes are scatter-built on device (_padded_build). The previous host
    np.full/np.repeat construction wrote O(R*L) bytes through this host's
    single (slow-write) core — 41 s for ML-20M's 138k x 1028 train plane
    vs ~1 s this way.

    The planes are memoized by CONTENT digest (``cache=True``): at ML-20M
    the build costs ~5 s of transfer + device scatter, paid once per
    distinct matrix instead of once per fit. Object identity can't key
    the cache — every model `.copy()`s its URM on construction (reference
    isolation semantics, models/base.py), so a tuning harness that refits
    the same train matrix dozens of times presents dozens of equal-content
    objects. A blake2b over (shape, indptr, indices, data) costs ~0.2 s at
    20M and is collision-safe; the LRU keeps the last
    $GANMF_TPU_PADDED_CACHE (default 4) plane sets (~1.1 GB each at 20M)."""
    hit = getattr(mat, "_ganmf_padded_dev", None)  # same-object fast path
    if cache and hit is not None and hit[0] == (mat.shape, mat.nnz, mat.dtype.str):
        return hit[1]
    csr = mat.tocsr().astype(np.float32)
    csr.eliminate_zeros()
    digest = None
    if cache:
        h = hashlib.blake2b(digest_size=16)
        h.update(np.asarray(csr.shape, np.int64).tobytes())
        h.update(csr.indptr.tobytes())
        h.update(csr.indices.tobytes())
        h.update(csr.data.tobytes())
        digest = h.hexdigest()
        got = _PADDED_CACHE.get(digest)
        if got is not None:
            _PADDED_CACHE.move_to_end(digest)
            return got
    R, C = csr.shape
    lens = np.ediff1d(csr.indptr)
    L = max(int(lens.max()) if R else 0, 1)
    if R == 0 or csr.nnz == 0 or R * L >= 2**31:
        # degenerate shapes, or linear int32 indexing would overflow: the
        # original host construction
        idx = np.full((R, L), C, dtype=np.int32)
        val = np.zeros((R, L), dtype=np.float32)
        rows = np.repeat(np.arange(R), lens)
        offs = np.arange(csr.nnz) - np.repeat(csr.indptr[:-1], lens)
        idx[rows, offs] = csr.indices
        val[rows, offs] = csr.data
        out = PaddedCSR(jnp.asarray(idx), jnp.asarray(val))
    else:
        binary = bool(np.all(csr.data == 1.0))
        vals = np.zeros((0,), np.float32) if binary else csr.data
        idx, val = _padded_build(
            jnp.asarray(csr.indptr.astype(np.int32)),
            jnp.asarray(csr.indices.astype(np.int32)),
            jnp.asarray(vals),
            R=R, L=L, C=C, binary=binary,
        )
        out = PaddedCSR(idx, val)
    if cache:
        _PADDED_CACHE[digest] = out
        while len(_PADDED_CACHE) > _PADDED_CACHE_CAP:
            _PADDED_CACHE.popitem(last=False)
        try:
            mat._ganmf_padded_dev = ((mat.shape, mat.nnz, mat.dtype.str), out)
        except AttributeError:  # e.g. matrix types without a __dict__
            pass
    return out


@functools.partial(jax.jit, static_argnames=("n_cols", "chunk"))
def dense_bf16_from_padded(idx, val, n_cols: int, chunk: int):
    """Materialize the interaction matrix as dense bf16 [R, n_cols]
    (2 bytes/element — 7.4 GB at ML-20M where f32 is 14.8 GB). Exact when
    every stored value is bf16-representable (binary data always is).
    Built chunk-by-chunk from the padded-CSR planes; shared by the
    resident-A randomized SVD (models/puresvd.py) and the resident-A
    similarity Gram (ops/similarity.py)."""
    R = idx.shape[0]
    n_chunks = R // chunk

    def body(c, A):
        bi = jax.lax.dynamic_slice_in_dim(idx, c * chunk, chunk)
        bv = jax.lax.dynamic_slice_in_dim(val, c * chunk, chunk)
        D = jnp.zeros((chunk, n_cols + 1), jnp.float32)
        D = D.at[jnp.arange(chunk)[:, None], bi].add(bv)[:, :n_cols]
        return jax.lax.dynamic_update_slice(A, D.astype(jnp.bfloat16), (c * chunk, 0))

    return jax.lax.fori_loop(0, n_chunks, body, jnp.zeros((R, n_cols), jnp.bfloat16))


def padded_rows_dense(
    pc: PaddedCSR, uids: jnp.ndarray, n_cols: int, max_len: int = None
) -> jnp.ndarray:
    """Densify a batch of rows on device: gather the padded entries and
    scatter into a [B, n_cols] zeros block (sentinel column dropped).

    ``max_len`` crops the gathered planes to the first ``max_len`` slots —
    exact whenever every selected row has at most ``max_len`` stored
    entries (padded-CSR rows are left-justified, the tail is all
    sentinel). The scatter cost is O(B * L): at heavy-tailed shapes the
    global L is ~15x the mean row length, so a caller that blocks rows by
    length class (the evaluator does) drops nearly all of the
    sentinel-column scatter traffic, which collides on one column and
    serializes."""
    bi = jnp.take(pc.idx, uids, axis=0)  # [B, L]
    bv = jnp.take(pc.val, uids, axis=0)
    if max_len is not None and max_len < bi.shape[1]:
        bi = bi[:, :max_len]
        bv = bv[:, :max_len]
    B = bi.shape[0]
    out = jnp.zeros((B, n_cols + 1), bv.dtype)
    out = out.at[jnp.arange(B)[:, None], bi].add(bv)
    return out[:, :n_cols]


def padded_rows_mask(
    pc: PaddedCSR, uids: jnp.ndarray, n_cols: int, max_len: int = None
) -> jnp.ndarray:
    """Boolean seen-mask rows from the padded storage."""
    return padded_rows_dense(pc, uids, n_cols, max_len=max_len) != 0
