"""Recommender base classes.

The serving/eval contract follows the reference BaseRecommender
(Base/BaseRecommender.py:14-247): a recommender holds a CSR ``URM_train``,
produces a dense score block for a batch of users, and ``recommend()``
masks seen items, ranks and strips removed entries. Here the scoring path
is a device program (``score_device``), rankings use ``lax.top_k`` and the
dense URM is cached in HBM once per model.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sps

from ganmf_tpu.data.device import DeviceURM
from ganmf_tpu.utils.dataio import DataIO


def check_matrix(X, format: str = "csc", dtype=np.float32):
    """Format/dtype coercion (reference Base/Recommender_utils.py:13-45)."""
    if isinstance(X, np.ndarray):
        X = sps.csr_matrix(X, dtype=dtype)
        X.eliminate_zeros()
    converters = {
        "csc": sps.csc_matrix,
        "csr": sps.csr_matrix,
        "coo": sps.coo_matrix,
        "dok": sps.dok_matrix,
        "lil": sps.lil_matrix,
    }
    cls = converters[format]
    if not isinstance(X, cls):
        X = cls(X)
    return X.astype(dtype)


# padded-host-block size (elements) above which the sparse column prune
# runs on device instead (a single near-dense column makes the host pad
# quadratic — 124 s measured on a LastFM-scale walk matrix)
_DEVICE_PRUNE_THRESHOLD = 1 << 26

# bf16 planes the similarity-family scoring matmul splits its f32 operand
# into when the other operand is bf16-exact: 2 gives ~16 mantissa bits in
# two bf16 tensor-core products, 3 gives f32-grade in three. 0 disables
# splitting (always HIGHEST).
_SIM_MATMUL_PASSES = int(os.environ.get("GANMF_TPU_SIM_PASSES", "2"))

# Catalog size below which the split-plane path stays OFF: the planes are a
# different (equally valid) f32 rounding of the same real scores, so exact
# f64 ties — common in binary co-occurrence data — may resolve differently
# than the HIGHEST-precision matmul, breaking the bitwise
# recommend_fused == recommend serving contract the parity suite relies on.
# The split exists for catalog-sized contractions (ML-20M's [B, 26744] x
# [26744, 26744] eval matmul is the measured hotspot); the parity datasets
# (<= 17,632 items) keep the bitwise path.
_SIM_SPLIT_MIN_ITEMS = int(os.environ.get("GANMF_TPU_SIM_SPLIT_MIN_I", "20000"))


def _device_column_topk(W: sps.spmatrix, k: int) -> sps.csc_matrix:
    """Column-wise top-k over stored nonzeros (negatives kept) computed on
    device; only the [n, k] winners transfer to host."""
    import jax.numpy as jnp

    from ganmf_tpu.data.device import dense_from_sparse
    from ganmf_tpu.ops.topk import tiled_topk

    n = W.shape[1]
    A = dense_from_sparse(sps.csr_matrix(W))
    sent = jnp.where(A == 0, -jnp.inf, A)
    vals, idx = tiled_topk(sent.T, min(k, n))  # per column j: top rows
    vals = np.asarray(vals, np.float32)
    idx = np.asarray(idx)
    keep = np.isfinite(vals)
    counts = keep.sum(axis=1).astype(np.int64)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return sps.csc_matrix((vals[keep], idx[keep], indptr), shape=(n, n), dtype=np.float32)


def similarity_matrix_topk(item_weights, k: int = 100) -> sps.csc_matrix:
    """Column-wise top-K pruning of a square similarity matrix
    (reference Base/Recommender_utils.py:48-115). Accepts dense or sparse.

    Dense inputs take a vectorized argpartition path (the reference's
    per-column python loop is quadratic-with-python-overhead and dominated
    SLIM-BPR exports at LastFM scale)."""
    assert item_weights.shape[0] == item_weights.shape[1]
    n = item_weights.shape[1]
    k = min(k, n)

    # the per-column python loop on sparse input carries python overhead;
    # densifying wins up to mid-size item counts, and past that the prune
    # runs as one device top-k over the densified matrix
    if sps.issparse(item_weights) and n <= 8192:
        item_weights = np.asarray(item_weights.todense(), dtype=np.float32)
    elif sps.issparse(item_weights):
        # large sparse: scatter the CSC structure into a padded
        # [n, max_nnz] block with one vectorized write, then a single
        # argpartition — no per-column python loop
        W = check_matrix(item_weights, "csc", np.float32)
        nnz_per_col = np.diff(W.indptr).astype(np.int64)
        max_nnz = int(nnz_per_col.max()) if n else 0
        if max_nnz == 0:
            return sps.csc_matrix((n, n), dtype=np.float32)
        if n * max_nnz > _DEVICE_PRUNE_THRESHOLD:
            # a near-dense column would make the padded host block huge
            # (P3alpha-style walk matrices: one popular column ~ [n, n]);
            # run the selection on device and transfer only [n, k]
            return _device_column_topk(W, k)
        col_of = np.repeat(np.arange(n), nnz_per_col)
        slot = np.arange(W.nnz, dtype=np.int64) - np.repeat(W.indptr[:-1], nnz_per_col)
        # padding (and explicit stored zeros) get a -inf sentinel so the
        # top-k runs over the column's nonzeros only and keeps negative
        # weights, matching the reference's non_zero_data filter
        # (Recommender_utils.py:98-104)
        padded_v = np.full((n, max_nnz), -np.inf, np.float32)
        padded_r = np.zeros((n, max_nnz), np.int32)
        padded_v[col_of, slot] = W.data
        padded_v[padded_v == 0] = -np.inf
        padded_r[col_of, slot] = W.indices
        if max_nnz > k:
            top = np.argpartition(-padded_v, k - 1, axis=1)[:, :k]
            padded_v = np.take_along_axis(padded_v, top, axis=1)
            padded_r = np.take_along_axis(padded_r, top, axis=1)
        keep = np.isfinite(padded_v)
        counts = keep.sum(axis=1).astype(np.int64)
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        return sps.csc_matrix(
            (padded_v[keep], padded_r[keep], indptr), shape=(n, n), dtype=np.float32
        )

    if not sps.issparse(item_weights):
        A = np.asarray(item_weights, dtype=np.float32)
        # zeros -> -inf so selection runs over nonzeros only and negative
        # weights survive (reference Recommender_utils.py:98-104)
        A = np.where(A != 0, A, -np.inf)
        if k < n:
            top = np.argpartition(-A, k - 1, axis=0)[:k]  # [k, n] row ids per column
        else:
            top = np.broadcast_to(np.arange(n)[:, None], (n, n))
        vals = np.take_along_axis(A, top, axis=0)  # [k, n]
        keep = np.isfinite(vals)
        counts = keep.sum(axis=0)
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        data = vals.T[keep.T]
        rows = top.T[keep.T]
        return sps.csc_matrix((data, rows, indptr), shape=(n, n), dtype=np.float32)

    data, rows, indptr = [], [], [0]
    W = check_matrix(item_weights, "csc", np.float32)
    for col in range(n):
        s, e = W.indptr[col], W.indptr[col + 1]
        col_data = W.data[s:e]
        col_rows = W.indices[s:e]
        nz = col_data != 0
        col_data, col_rows = col_data[nz], col_rows[nz]
        if len(col_data) > k:
            top = np.argpartition(-col_data, k - 1)[:k]
            col_data, col_rows = col_data[top], col_rows[top]
        data.extend(col_data.tolist())
        rows.extend(col_rows.tolist())
        indptr.append(len(data))
    return sps.csc_matrix((data, rows, indptr), shape=(n, n), dtype=np.float32)


class Recommender:
    RECOMMENDER_NAME = "Recommender_Base_Class"

    def __init__(self, URM_train):
        self.URM_train = check_matrix(URM_train.copy(), "csr", dtype=np.float32)
        self.URM_train.eliminate_zeros()
        self.n_users, self.n_items = self.URM_train.shape

        self.filterTopPop = False
        self.filterTopPop_ItemsID = np.array([], dtype=np.int64)
        self.items_to_ignore_flag = False
        self.items_to_ignore_ID = np.array([], dtype=np.int64)

        self._cold_user_mask = np.ediff1d(self.URM_train.indptr) == 0
        self._durm: Optional[DeviceURM] = None

    # -- device caches ---------------------------------------------------------
    def device_urm(self) -> DeviceURM:
        if self._durm is None:
            self._durm = DeviceURM(self.URM_train)
        return self._durm

    def device_train_mask(self) -> jnp.ndarray:
        return self.device_urm().mask

    # Above this dense-URM size the [U, I] matrix stays off-device and
    # profile/seen rows are scatter-built per block from padded-CSR storage
    # (O(nnz) device memory). ML-20M's 138k x 26.7k dense URM is 14.8 GB.
    # Override with $GANMF_TPU_DENSE_URM_GB.
    _DENSE_URM_BYTE_LIMIT = int(float(os.environ.get("GANMF_TPU_DENSE_URM_GB", "6")) * (1 << 30))

    def _urm_streams(self) -> bool:
        """True when the URM is served from padded-CSR storage: either the
        model trained with urm_storage='csr', or the dense [U, I] matrix
        would not reasonably fit in HBM."""
        if getattr(self, "_stream_seen", False):
            return True
        return 4 * self.n_users * self.n_items > self._DENSE_URM_BYTE_LIMIT

    def _padded_urm(self):
        from ganmf_tpu.data.device import padded_csr_from_sparse

        if getattr(self, "_seen_padded", None) is None:
            self._seen_padded = padded_csr_from_sparse(self.URM_train)
        return self._seen_padded

    def device_seen_rows(self, uids: jnp.ndarray, max_len: int = None) -> jnp.ndarray:
        """[B, I] bool seen-mask rows for the given users. Default gathers
        from the dense [U, I] mask; streamed models (and any model whose
        dense URM would exceed the HBM budget) build the rows by scatter
        instead, keeping eval O(nnz) in HBM too. ``max_len`` (streamed path
        only) crops the scatter to a caller-guaranteed row-length bound —
        see data/device.padded_rows_dense."""
        if self._urm_streams():
            from ganmf_tpu.data.device import padded_rows_mask

            return padded_rows_mask(self._padded_urm(), uids, self.n_items, max_len=max_len)
        return jnp.take(self.device_train_mask(), uids, axis=0)

    def device_profile_rows(self, uids: jnp.ndarray, max_len: int = None) -> jnp.ndarray:
        """[B, I] f32 rating-profile rows; same streaming policy as
        device_seen_rows."""
        if self._urm_streams():
            from ganmf_tpu.data.device import padded_rows_dense

            return padded_rows_dense(self._padded_urm(), uids, self.n_items, max_len=max_len)
        return self.device_urm().rows(uids)

    def _urm_values_bf16_exact(self) -> bool:
        """True when every URM value is exactly representable in bfloat16
        (binary/implicit data always is; half-star ratings are too). Gates
        the split-plane similarity scoring matmul: with a bf16-exact left
        operand, per-term products against bf16 planes are exact."""
        if getattr(self, "_urm_bf16_exact", None) is None:
            import ml_dtypes

            d = self.URM_train.data
            self._urm_bf16_exact = bool(
                np.all(d == d.astype(ml_dtypes.bfloat16).astype(np.float32))
            )
        return self._urm_bf16_exact

    def _invalidate_device_cache(self):
        self._durm = None
        self._seen_padded = None
        self._serving_warmed = False

    # -- reference-compatible accessors ---------------------------------------
    def get_URM_train(self):
        return self.URM_train.copy()

    def set_URM_train(self, URM_train_new, **kwargs):
        assert self.URM_train.shape == URM_train_new.shape
        self.URM_train = check_matrix(URM_train_new.copy(), "csr", dtype=np.float32)
        self.URM_train.eliminate_zeros()
        self._cold_user_mask = np.ediff1d(self.URM_train.indptr) == 0
        self._invalidate_device_cache()

    def _get_cold_user_mask(self):
        return self._cold_user_mask

    def set_items_to_ignore(self, items_to_ignore):
        self.items_to_ignore_flag = True
        self.items_to_ignore_ID = np.array(items_to_ignore, dtype=np.int64)

    def reset_items_to_ignore(self):
        self.items_to_ignore_flag = False
        self.items_to_ignore_ID = np.array([], dtype=np.int64)

    def fit(self, *args, **kwargs):
        pass

    # -- scoring ---------------------------------------------------------------
    def _check_scoring_overridden(self):
        """Subclasses must override score_device or _compute_item_score; the
        base defaults delegate to each other, so an un-overridden pair would
        recurse forever. Raise a clear error instead (models that only
        override recommend(), e.g. PredefinedListRecommender, hit this)."""
        if (
            type(self).score_device is Recommender.score_device
            and type(self)._compute_item_score is Recommender._compute_item_score
        ):
            raise NotImplementedError(
                f"{type(self).__name__} overrides neither score_device nor "
                "_compute_item_score; score-based serving (recommend with "
                "scores / serve_all) is unavailable for it."
            )

    def score_device(self, user_ids: jnp.ndarray) -> jnp.ndarray:
        """[B, I] device scores for a batch of users. Subclasses override."""
        self._check_scoring_overridden()
        scores = self._compute_item_score(np.asarray(user_ids))
        return jnp.asarray(np.asarray(scores, dtype=np.float32))

    def _compute_item_score(self, user_id_array, items_to_compute=None) -> np.ndarray:
        """Numpy scoring path; default delegates to the device program."""
        self._check_scoring_overridden()
        uids = jnp.asarray(np.atleast_1d(user_id_array), dtype=jnp.int32)
        scores = np.asarray(self.score_device(uids), dtype=np.float32)
        if items_to_compute is not None:
            masked = np.full_like(scores, -np.inf)
            masked[:, items_to_compute] = scores[:, items_to_compute]
            scores = masked
        return scores

    # -- serving ---------------------------------------------------------------
    def recommend(
        self,
        user_id_array,
        cutoff: Optional[int] = None,
        remove_seen_flag: bool = True,
        items_to_compute=None,
        remove_top_pop_flag: bool = False,
        remove_CustomItems_flag: bool = False,
        return_scores: bool = False,
    ):
        """Ranked recommendation lists (reference BaseRecommender.py:155-247)."""
        if np.isscalar(user_id_array):
            user_id_array = np.atleast_1d(user_id_array)
            single_user = True
        else:
            user_id_array = np.asarray(user_id_array)
            single_user = False

        if cutoff is None:
            cutoff = self.URM_train.shape[1] - 1
        cutoff = min(cutoff, self.URM_train.shape[1])

        scores_batch = self._compute_item_score(user_id_array, items_to_compute=items_to_compute)
        # copy: device arrays surface as read-only numpy views
        scores_batch = np.array(scores_batch, dtype=np.float32)

        if remove_seen_flag:
            for idx, user_id in enumerate(user_id_array):
                seen = self.URM_train.indices[
                    self.URM_train.indptr[user_id] : self.URM_train.indptr[user_id + 1]
                ]
                scores_batch[idx, seen] = -np.inf

        if remove_top_pop_flag:
            scores_batch[:, self.filterTopPop_ItemsID] = -np.inf
        if remove_CustomItems_flag:
            scores_batch[:, self.items_to_ignore_ID] = -np.inf

        # rank on device: top_k == argpartition+argsort of the reference
        top_idx = np.asarray(jax.lax.top_k(jnp.asarray(scores_batch), cutoff)[1])
        ranking_list = []
        for idx in range(len(user_id_array)):
            row = top_idx[idx]
            finite = np.isfinite(scores_batch[idx, row])
            ranking_list.append(row[finite].tolist())

        if single_user:
            ranking_list = ranking_list[0]
        if return_scores:
            return ranking_list, scores_batch
        return ranking_list

    def recommend_fused(self, user_id_array, cutoff: int = 20, remove_seen_flag: bool = True):
        """Serving-scale ranking that keeps the [B, I] score block on device
        (ops/scoring.masked_topk_matmul): one fused matmul + seen-mask +
        top-K program, only the [B, k] winners reach the host. Identical
        lists to recommend() (same lowest-index tie resolution). Models
        without device-resident operands fall back to recommend()."""
        ops = getattr(self, "_fused_serving_operands", None)
        if ops is None:
            return self.recommend(user_id_array, cutoff=cutoff, remove_seen_flag=remove_seen_flag)
        user_id_array = np.atleast_1d(np.asarray(user_id_array))
        uids = jnp.asarray(user_id_array, dtype=jnp.int32)
        operands = ops(uids)
        if operands is None:  # W too large for HBM residency
            return self.recommend(user_id_array, cutoff=cutoff, remove_seen_flag=remove_seen_flag)
        rows, right = operands
        if remove_seen_flag:
            seen = self.device_seen_rows(uids)
        else:
            seen = jnp.zeros((len(user_id_array), self.n_items), bool)
        seen = self._fused_exclude_cold(uids, seen)
        from ganmf_tpu.ops.scoring import masked_topk_matmul

        pair_ids = jnp.zeros((len(user_id_array), 1), jnp.int32)  # probe unused
        vals, idx, _, _ = masked_topk_matmul(
            rows, right, seen, pair_ids, k=min(cutoff, self.n_items)
        )
        vals, idx = np.asarray(vals), np.asarray(idx)
        return [idx[b][np.isfinite(vals[b])].tolist() for b in range(len(user_id_array))]

    def _fused_exclude_cold(self, uids: jnp.ndarray, seen: jnp.ndarray) -> jnp.ndarray:
        """The fused paths' exclusion mask for a uid batch. Models whose
        ``score_device`` scores cold users -inf add them here; the default
        scores cold users like any other."""
        return seen

    def _serving_traceable(self) -> bool:
        """True when score_device/device_seen_rows are pure jnp programs of
        the uid batch (no host fallbacks), so serve_all can scan them."""
        return True

    def _serve_block(self, uids, k: int, remove_seen_flag: bool):
        """([B, k] vals, [B, k] idx) ranked block for serve_all; subclasses
        with fused scorers override (same ranking semantics required)."""
        scores = self.score_device(uids)
        if remove_seen_flag:
            scores = jnp.where(self.device_seen_rows(uids), -jnp.inf, scores)
        return jax.lax.top_k(scores, k)

    def serve_all(
        self,
        cutoff: int = 20,
        remove_seen_flag: bool = True,
        block: int = 2048,
        user_id_array=None,
    ):
        """Batch serving export: ranked top-``cutoff`` items for every user
        (or ``user_id_array``) as dense ``(item_ids [n, k] int32, scores
        [n, k] f32)`` arrays.

        The whole export runs as ONE device program — a ``lax.map`` over
        ``block``-sized uid batches of (gather rows -> score -> seen-mask ->
        ``lax.top_k``) — instead of ``recommend()``'s per-block dispatches
        and python list assembly, so the host pays a single dispatch round
        trip and reads back only the [n, k] winners.  Closed-over model
        operands (factors / W / dense URM) enter the scan as lifted consts,
        i.e. runtime inputs, never HLO constants.

        Slots that ``recommend()`` would strip (seen items when the user has
        fewer than k unseen, cold users) come back with ``-inf`` score;
        ``np.isfinite(scores[u])`` recovers the exact ``recommend()`` list.
        Models whose scoring currently needs a host fallback (similarity
        models with a beyond-HBM W) take the same math as an eager per-block
        loop.
        """
        uids_np = (
            np.arange(self.n_users, dtype=np.int64)
            if user_id_array is None
            else np.atleast_1d(np.asarray(user_id_array)).astype(np.int64)
        )
        n = len(uids_np)
        k = min(cutoff, self.n_items)
        if n == 0:
            return np.zeros((0, k), dtype=np.int32), np.zeros((0, k), dtype=np.float32)
        B = max(1, min(block, n))

        def one_block(uids):
            return self._serve_block(uids, k, remove_seen_flag)

        pad = (-n) % B
        padded = np.concatenate([uids_np, np.zeros(pad, dtype=np.int64)])
        blocks = jnp.asarray(padded.astype(np.int32)).reshape(-1, B)
        # eager warm call: lets models fill lazy device caches (score
        # matrices, penultimate activations, padded seen-rows) with concrete
        # arrays before the scan body traces over them. One dispatch per
        # model fit — skipped on repeat calls (flag drops with the caches).
        if not getattr(self, "_serving_warmed", False):
            warm = blocks[0][:1]
            _ = self.score_device(warm)
            _ = self.device_seen_rows(warm)
            self._serving_warmed = True
        if self._serving_traceable():
            vals, idx = jax.lax.map(one_block, blocks)
        else:
            outs = [one_block(b) for b in blocks]
            vals = jnp.stack([v for v, _ in outs])
            idx = jnp.stack([i for _, i in outs])
        vals, idx = jax.device_get((vals, idx))  # one host round trip
        vals = np.asarray(vals, dtype=np.float32).reshape(-1, k)[:n]
        idx = np.asarray(idx).reshape(-1, k)[:n].astype(np.int32)
        return idx, vals

    # -- persistence -------------------------------------------------------------
    def _save_dict(self):
        """Attributes persisted by saveModel; subclasses extend."""
        return {}

    def saveModel(self, folder_path, file_name=None):
        file_name = file_name or self.RECOMMENDER_NAME
        DataIO(folder_path).save_data(file_name, self._save_dict())

    def loadModel(self, folder_path, file_name=None):
        file_name = file_name or self.RECOMMENDER_NAME
        data = DataIO(folder_path).load_data(file_name)
        for name, value in data.items():
            setattr(self, name, value)
        return data


def compute_W_sparse_from_item_latent_factors(ITEM_factors: np.ndarray, topK: int = 100) -> sps.csr_matrix:
    """Item-item dot-product similarity from latent factors, top-K per
    column (reference Base/BaseMatrixFactorizationRecommender.py:17-70);
    the blockwise host matmul becomes one device matmul + lax.top_k."""
    from ganmf_tpu.ops.topk import tiled_topk

    V = jnp.asarray(np.asarray(ITEM_factors, dtype=np.float32))
    W = jnp.dot(V, V.T, precision=jax.lax.Precision.HIGHEST)
    k = min(topK, V.shape[0])
    vals, idx = tiled_topk(W.T, k)  # per column (rows of W^T)
    vals, idx = np.asarray(vals, np.float32), np.asarray(idx)
    keep = vals != 0.0
    counts = keep.sum(axis=1)
    indptr = np.zeros(V.shape[0] + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return sps.csc_matrix(
        (vals[keep], idx[keep], indptr), shape=(V.shape[0], V.shape[0]), dtype=np.float32
    ).tocsr()


class MatrixFactorizationRecommender(Recommender):
    """Dot-product scoring from USER_factors/ITEM_factors
    (reference Base/BaseMatrixFactorizationRecommender.py:94-143), with the
    optional cold-user fallbacks of set_URM_train (:150-200)."""

    RECOMMENDER_NAME = "BaseMatrixFactorizationRecommender"

    def __init__(self, URM_train):
        super().__init__(URM_train)
        self._USER_factors_store = None
        self._ITEM_factors_store = None
        self.use_bias = False
        # rating-prediction bias terms (reference
        # Base/BaseMatrixFactorizationRecommender.py:118-124 adds
        # ITEM_bias + GLOBAL_bias + USER_bias[u] to the dot-product scores
        # when use_bias): folded into augmented device factors so every
        # scoring path (dense, fused, serving, RMSE probes) gets them from
        # the same matmul
        self.USER_bias = None
        self.ITEM_bias = None
        self.GLOBAL_bias = 0.0
        self._device_factors = None
        self._cold_user_KNN_model_available = False
        self._ItemKNNRecommender = None
        self._warm_user_KNN_mask = None

    # Factor stores accept either host numpy arrays or device jax arrays.
    # Device-producing fits (PureSVD, IALS) assign device arrays and the
    # host copy materializes lazily on first read — evaluation never pays
    # the device->host factor transfer (which dominates fit time on
    # latency-bound links).
    @property
    def USER_factors(self) -> Optional[np.ndarray]:
        if isinstance(self._USER_factors_store, jax.Array):
            self._USER_factors_store = np.asarray(self._USER_factors_store)
        return self._USER_factors_store

    @USER_factors.setter
    def USER_factors(self, value):
        self._USER_factors_store = value
        self._device_factors = None

    @property
    def ITEM_factors(self) -> Optional[np.ndarray]:
        if isinstance(self._ITEM_factors_store, jax.Array):
            self._ITEM_factors_store = np.asarray(self._ITEM_factors_store)
        return self._ITEM_factors_store

    @ITEM_factors.setter
    def ITEM_factors(self, value):
        self._ITEM_factors_store = value
        self._device_factors = None

    def _factors_device(self):
        if self._device_factors is None:
            U, V = self._USER_factors_store, self._ITEM_factors_store
            if not isinstance(U, jax.Array):
                U = jnp.asarray(np.asarray(U, dtype=np.float32))
            if not isinstance(V, jax.Array):
                V = jnp.asarray(np.asarray(V, dtype=np.float32))
            if self.use_bias and self.USER_bias is not None:
                # fold [U | bU | 1] x [V | 1 | bV + g]^T so that
                # U'V'^T = UV^T + bU + bV + GLOBAL_bias — bitwise the
                # reference's biased score with no extra scoring pass
                bU = jnp.asarray(np.asarray(self.USER_bias, np.float32)).reshape(-1)
                bV = jnp.asarray(np.asarray(self.ITEM_bias, np.float32)).reshape(-1)
                g = jnp.float32(float(np.asarray(self.GLOBAL_bias).reshape(-1)[0])
                                if np.ndim(self.GLOBAL_bias) else float(self.GLOBAL_bias))
                U = jnp.concatenate(
                    [U, bU[:, None], jnp.ones((U.shape[0], 1), U.dtype)], axis=1)
                V = jnp.concatenate(
                    [V, jnp.ones((V.shape[0], 1), V.dtype), (bV + g)[:, None]], axis=1)
            self._device_factors = (U, V, jnp.asarray(self._cold_user_mask))
        return self._device_factors

    def _invalidate_device_cache(self):
        super()._invalidate_device_cache()
        self._device_factors = None

    def _serving_traceable(self) -> bool:
        if self._cold_user_KNN_model_available:
            return self._ItemKNNRecommender._serving_traceable()
        return True

    def score_device(self, user_ids: jnp.ndarray) -> jnp.ndarray:
        U, V, cold = self._factors_device()
        scores = jnp.dot(jnp.take(U, user_ids, axis=0), V.T, precision=jax.lax.Precision.HIGHEST)
        cold_batch = jnp.take(cold, user_ids)
        if self._cold_user_KNN_model_available:
            # cold-for-MF but warm-in-KNN users score through the estimated
            # item-item model (reference :166-178)
            knn_scores = self._ItemKNNRecommender.score_device(user_ids)
            warm_knn = jnp.take(jnp.asarray(self._warm_user_KNN_mask), user_ids)
            use_knn = cold_batch & warm_knn
            scores = jnp.where(use_knn[:, None], knn_scores, scores)
            cold_batch = cold_batch & ~warm_knn
        return jnp.where(cold_batch[:, None], -jnp.inf, scores)

    def set_URM_train(self, URM_train_new, estimate_model_for_cold_users=None, topK: int = 100, **kwargs):
        super().set_URM_train(URM_train_new)

        if estimate_model_for_cold_users == "itemKNN":
            from ganmf_tpu.models.itemknn import ItemKNNCustomSimilarityRecommender

            W_sparse = compute_W_sparse_from_item_latent_factors(self.ITEM_factors, topK=topK)
            self._ItemKNNRecommender = ItemKNNCustomSimilarityRecommender(self.URM_train)
            self._ItemKNNRecommender.fit(W_sparse, topK=topK)
            self._cold_user_KNN_model_available = True
            self._warm_user_KNN_mask = np.ediff1d(self.URM_train.indptr) > 0

        elif estimate_model_for_cold_users == "mean_item_factors":
            # USER_factors = URM . ITEM_factors / sqrt(profile length)
            profile_length = np.ediff1d(self.URM_train.indptr)
            sqrt_len = np.sqrt(np.maximum(profile_length, 1))
            self.USER_factors = np.asarray(self.URM_train.dot(self.ITEM_factors), dtype=np.float32)
            self.USER_factors /= sqrt_len[:, None]
            # estimated users are no longer cold for scoring purposes
            self._cold_user_mask = profile_length == 0
            self._invalidate_device_cache()

    def _fused_serving_operands(self, uids: jnp.ndarray, max_len: int = None):
        """(U[uids], V^T) for the fused ranking paths; None when cold users
        score through the item-KNN fallback, which only ``score_device``
        applies. ``max_len`` (a profile-length bound) does not apply to
        factor rows."""
        if self._cold_user_KNN_model_available:
            return None
        U, V, _ = self._factors_device()
        return jnp.take(U, uids, axis=0), V.T

    def _fused_exclude_cold(self, uids: jnp.ndarray, seen: jnp.ndarray) -> jnp.ndarray:
        # score_device scores cold users -inf on every item
        _, _, cold = self._factors_device()
        return seen | jnp.take(cold, uids)[:, None]

    def _save_dict(self):
        out = {
            "USER_factors": np.asarray(self.USER_factors),
            "ITEM_factors": np.asarray(self.ITEM_factors),
            "use_bias": bool(self.use_bias),
        }
        if self.use_bias and self.USER_bias is not None:
            # same artifact keys as the reference
            # (Base/BaseMatrixFactorizationRecommender.py:217-219)
            out["USER_bias"] = np.asarray(self.USER_bias)
            out["ITEM_bias"] = np.asarray(self.ITEM_bias)
            out["GLOBAL_bias"] = self.GLOBAL_bias
        return out


class ItemSimilarityRecommender(Recommender):
    """Scores = URM[u] @ W (reference Base/BaseSimilarityMatrixRecommender.py:73-92).

    The item-item W is kept dense in HBM when it fits (fast batched matmul);
    otherwise blocks fall back to host sparse products.
    """

    RECOMMENDER_NAME = "BaseItemSimilarityMatrixRecommender"
    _DENSE_W_BYTE_LIMIT = 4 << 30

    def __init__(self, URM_train):
        super().__init__(URM_train)
        self._W_sparse_store: Optional[sps.csr_matrix] = None
        self._device_w = None
        self._device_w_planes = None

    # W_sparse is a property so a device-built dense W (e.g. EASE-R's closed
    # form) can stay device-authoritative: scoring never needs the host copy,
    # which materializes lazily only when an artifact (saveModel, hybrid
    # composition) asks for it.
    @property
    def W_sparse(self) -> Optional[sps.csr_matrix]:
        if self._W_sparse_store is None and self._device_w is not None and self._device_w is not False:
            W = np.array(self._device_w)
            self._W_sparse_store = check_matrix(sps.csr_matrix(W), "csr", np.float32)
        return self._W_sparse_store

    @W_sparse.setter
    def W_sparse(self, value):
        self._W_sparse_store = value
        self._device_w = None

    def _adopt_device_w(self, W_dev: jnp.ndarray):
        """Make a device-resident dense [I, I] W authoritative."""
        self._W_sparse_store = None
        self._device_w = W_dev

    def _w_device(self):
        if self._device_w is None:
            n = self._W_sparse_store.shape[0]
            if 4 * n * n <= self._DENSE_W_BYTE_LIMIT:
                self._device_w = jnp.asarray(
                    np.asarray(self._W_sparse_store.todense(), dtype=np.float32)
                )
            else:
                self._device_w = False
        return self._device_w

    def _w_device_split(self):
        """Cached bf16 planes of the dense W for the split-plane scoring
        matmul (ops/scoring.split_bf16_planes); False when W does not
        fit in HBM or splitting is disabled."""
        if self._device_w_planes is None:
            W = self._w_device()
            if W is False or _SIM_MATMUL_PASSES <= 0:
                self._device_w_planes = False
            else:
                from ganmf_tpu.ops.scoring import split_bf16_planes

                self._device_w_planes = split_bf16_planes(W, _SIM_MATMUL_PASSES)
        return self._device_w_planes

    def _invalidate_device_cache(self):
        super()._invalidate_device_cache()
        if self._W_sparse_store is None and self._device_w is not None and self._device_w is not False:
            _ = self.W_sparse  # materialize the host copy before dropping device state
        self._device_w = None
        self._device_w_planes = None

    def _serving_traceable(self) -> bool:
        return self._w_device() is not False

    def score_device(self, user_ids: jnp.ndarray) -> jnp.ndarray:
        W = self._w_device()
        if W is False:
            profiles = self.URM_train[np.asarray(user_ids)]
            return jnp.asarray(profiles.dot(self.W_sparse).toarray().astype(np.float32))
        profiles = self.device_profile_rows(user_ids)
        return jnp.dot(profiles, W, precision=jax.lax.Precision.HIGHEST)

    def _fused_serving_operands(self, uids: jnp.ndarray, max_len: int = None):
        W = self._w_device()
        if W is False:
            return None
        rows = self.device_profile_rows(uids, max_len=max_len)
        if self._urm_values_bf16_exact() and self.n_items >= _SIM_SPLIT_MIN_ITEMS:
            planes = self._w_device_split()
            if planes is not False:
                return rows.astype(jnp.bfloat16), planes
        return rows, W

    def _save_dict(self):
        return {"W_sparse": check_matrix(self.W_sparse, "csr", np.float32)}


class UserSimilarityRecommender(Recommender):
    """Scores = W[u] @ URM (reference Base/BaseSimilarityMatrixRecommender.py:97-116).

    The user-user W is kept dense in HBM when it fits so block scoring is a
    single matmul over the resident URM; otherwise blocks fall back to
    host sparse products."""

    RECOMMENDER_NAME = "BaseUserSimilarityMatrixRecommender"
    _DENSE_W_BYTE_LIMIT = 4 << 30

    def __init__(self, URM_train):
        super().__init__(URM_train)
        self._W_sparse_store: Optional[sps.csr_matrix] = None
        self._device_w = None
        self._device_w_planes = None

    # same lazy device-authoritative design as ItemSimilarityRecommender:
    # a device-built dense W never round-trips to host unless an artifact
    # (saveModel, composition) reads the property
    @property
    def W_sparse(self) -> Optional[sps.csr_matrix]:
        if self._W_sparse_store is None and self._device_w is not None and self._device_w is not False:
            W = np.array(self._device_w)
            self._W_sparse_store = check_matrix(sps.csr_matrix(W), "csr", np.float32)
        return self._W_sparse_store

    @W_sparse.setter
    def W_sparse(self, value):
        self._W_sparse_store = value
        self._device_w = None

    def _adopt_device_w(self, W_dev: jnp.ndarray):
        """Make a device-resident dense [U, U] W authoritative."""
        self._W_sparse_store = None
        self._device_w = W_dev

    def _w_device(self):
        if self._device_w is None:
            n = self._W_sparse_store.shape[0]
            if 4 * n * n <= self._DENSE_W_BYTE_LIMIT:
                from ganmf_tpu.data.device import dense_from_sparse

                self._device_w = dense_from_sparse(sps.csr_matrix(self._W_sparse_store))
            else:
                self._device_w = False
        return self._device_w

    def _w_device_split(self):
        """Cached bf16 planes of the dense user-user W (the split operand
        here is W: the URM right operand is the bf16-exact one)."""
        if getattr(self, "_device_w_planes", None) is None:
            W = self._w_device()
            if W is False or _SIM_MATMUL_PASSES <= 0:
                self._device_w_planes = False
            else:
                from ganmf_tpu.ops.scoring import split_bf16_planes

                self._device_w_planes = split_bf16_planes(W, _SIM_MATMUL_PASSES)
        return self._device_w_planes

    def _invalidate_device_cache(self):
        super()._invalidate_device_cache()
        if self._W_sparse_store is None and self._device_w is not None and self._device_w is not False:
            _ = self.W_sparse  # materialize the host copy before dropping device state
        self._device_w = None
        self._device_w_planes = None

    def _serving_traceable(self) -> bool:
        return self._w_device() is not False

    def score_device(self, user_ids: jnp.ndarray) -> jnp.ndarray:
        W = self._w_device()
        if W is False:
            weights = self.W_sparse[np.asarray(user_ids)]
            return jnp.asarray(weights.dot(self.URM_train).toarray().astype(np.float32))
        rows = jnp.take(W, user_ids, axis=0)  # [B, U]
        return jnp.dot(rows, self.device_urm().dense, precision=jax.lax.Precision.HIGHEST)

    def _fused_serving_operands(self, uids: jnp.ndarray, max_len: int = None):
        # max_len is a profile-length bound; user-based rows are W[u], so it
        # does not apply here (accepted for signature parity with the
        # item-based variant the evaluator threads block crops through)
        W = self._w_device()
        if W is False:
            return None
        if self._urm_values_bf16_exact() and self.n_items >= _SIM_SPLIT_MIN_ITEMS:
            planes = self._w_device_split()
            if planes is not False:
                rows = tuple(jnp.take(p, uids, axis=0) for p in planes)
                return rows, self.device_urm().dense.astype(jnp.bfloat16)
        return jnp.take(W, uids, axis=0), self.device_urm().dense

    def _save_dict(self):
        return {"W_sparse": check_matrix(self.W_sparse, "csr", np.float32)}
