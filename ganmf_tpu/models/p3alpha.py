"""Graph-based random-walk recommenders P3alpha and RP3beta.

The reference computes W = (Piu^a)(Pui^a) in 200-column host blocks with
per-row argsort top-K (GraphBased/P3alphaRecommender.py:52-141). Here the
walk product is one dense matmul over device-resident transition matrices
and top-K uses lax.top_k per row, then the reference's final column-wise
top-K prune is applied.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sps

from ganmf_tpu.data.device import dense_from_sparse
from ganmf_tpu.models.base import ItemSimilarityRecommender, check_matrix, similarity_matrix_topk


def l1_normalize_rows(X) -> sps.csr_matrix:
    """Each row of a sparse matrix divided by its l1 norm; empty rows stay
    empty. The norm is summed and the division taken in float64, then
    stored in X's dtype (sklearn.preprocessing.normalize(norm="l1")
    semantics)."""
    X = sps.csr_matrix(X, copy=True)
    rows = np.repeat(np.arange(X.shape[0]), np.diff(X.indptr))
    norms = np.bincount(rows, weights=np.abs(X.data.astype(np.float64)),
                        minlength=X.shape[0])
    norms[norms == 0.0] = 1.0
    X.data = (X.data / norms[rows]).astype(X.dtype)
    return X


@functools.partial(jax.jit, static_argnames=("topk", "l1_normalize"))
def _walk_topk_pruned(Piu: jnp.ndarray, Pui: jnp.ndarray, col_scale: jnp.ndarray,
                      topk: int, l1_normalize: bool):
    """W = Piu @ Pui with zeroed diagonal, column scaling (RP3beta's
    popularity^-beta; ones for P3alpha), row-wise top-K, optional L1 row
    normalization, then the final column-wise top-K — all on device. Only
    the [I, topk] per-column winners leave the chip; the host column prune
    this replaces took minutes at LastFM scale (314 s measured) while the
    device walk runs in under a second."""
    from ganmf_tpu.ops.topk import tiled_topk

    hi = jax.lax.Precision.HIGHEST
    n = Piu.shape[0]
    W = jnp.dot(Piu, Pui, precision=hi)  # [I, I]
    W = W * col_scale[None, :]
    W = jnp.where(jnp.eye(n, dtype=bool), 0.0, W)
    rows = jnp.arange(n)
    sent = jnp.where(W != 0, W, -jnp.inf)
    v, ix = tiled_topk(sent, topk)  # row-wise (reference's per-block argsort)
    v = jnp.where(jnp.isfinite(v), v, 0.0)
    S1 = jnp.zeros_like(W).at[rows[:, None], ix].set(v)
    if l1_normalize:
        s = jnp.sum(jnp.abs(S1), axis=1, keepdims=True)
        S1 = jnp.where(s > 0, S1 / jnp.maximum(s, 1e-30), S1)
    sent1 = jnp.where(S1 != 0, S1, -jnp.inf)
    cv, cix = tiled_topk(sent1.T, topk)  # column-wise (similarityMatrixTopK)
    cv = jnp.where(jnp.isfinite(cv), cv, 0.0)
    return cv, cix


def _cols_topk_to_csr(vals: np.ndarray, idx: np.ndarray, n: int) -> sps.csr_matrix:
    """CSR from per-column [n, k] top-K candidates (CSC assembly)."""
    keep = vals != 0.0
    counts = keep.sum(axis=1)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    W = sps.csc_matrix((vals[keep], idx[keep], indptr), shape=(n, n), dtype=np.float32)
    return W.tocsr()


class _WalkRecommender(ItemSimilarityRecommender):
    def _finish_w(self, cv, cix):
        """Adopt the pruned walk matrix: device-resident dense W when it
        fits HBM (no readback), host CSR otherwise."""
        n = self.n_items
        if 4 * n * n <= self._DENSE_W_BYTE_LIMIT:
            from ganmf_tpu.ops.topk import scatter_col_topk_dense

            self._adopt_device_w(scatter_col_topk_dense(cv, cix))
        else:
            W = _cols_topk_to_csr(np.asarray(cv, np.float32), np.asarray(cix), n)
            self.W_sparse = check_matrix(W, "csr")


class P3alphaRecommender(_WalkRecommender):
    RECOMMENDER_NAME = "P3alphaRecommender"

    def fit(self, topK: int = 100, alpha: float = 1.0, min_rating: float = 0, implicit: bool = False,
            normalize_similarity: bool = False):
        self.topK = topK
        self.alpha = alpha
        self.min_rating = min_rating
        self.implicit = implicit
        self.normalize_similarity = normalize_similarity

        if min_rating > 0:
            self.URM_train.data[self.URM_train.data < min_rating] = 0
            self.URM_train.eliminate_zeros()
            if implicit:
                self.URM_train.data = np.ones(self.URM_train.data.size, dtype=np.float32)
            self._invalidate_device_cache()

        Pui = l1_normalize_rows(self.URM_train)
        X_bool = self.URM_train.transpose(copy=True)
        X_bool.data = np.ones(X_bool.data.size, np.float32)
        Piu = l1_normalize_rows(X_bool)

        if alpha != 1.0:
            Pui = Pui.power(alpha)
            Piu = Piu.power(alpha)

        cv, cix = _walk_topk_pruned(
            dense_from_sparse(sps.csr_matrix(Piu, dtype=np.float32)),
            dense_from_sparse(sps.csr_matrix(Pui, dtype=np.float32)),
            jnp.ones((self.n_items,), jnp.float32),
            topk=min(topK, self.n_items) if topK else self.n_items,
            l1_normalize=bool(normalize_similarity),
        )
        self._finish_w(cv, cix)


class RP3betaRecommender(_WalkRecommender):
    """RP3beta: P3alpha with the walk matrix divided by item popularity^beta
    (reference GraphBased/RP3betaRecommender.py)."""

    RECOMMENDER_NAME = "RP3betaRecommender"

    def fit(self, alpha: float = 1.0, beta: float = 0.6, min_rating: float = 0, topK: int = 100,
            implicit: bool = False, normalize_similarity: bool = True):
        self.alpha = alpha
        self.beta = beta
        self.min_rating = min_rating
        self.topK = topK
        self.implicit = implicit
        self.normalize_similarity = normalize_similarity

        if min_rating > 0:
            self.URM_train.data[self.URM_train.data < min_rating] = 0
            self.URM_train.eliminate_zeros()
            if implicit:
                self.URM_train.data = np.ones(self.URM_train.data.size, dtype=np.float32)
            self._invalidate_device_cache()

        Pui = l1_normalize_rows(self.URM_train)
        X_bool = self.URM_train.transpose(copy=True)
        X_bool.data = np.ones(X_bool.data.size, np.float32)
        degree = np.zeros(self.n_items, dtype=np.float32)
        nonzero = np.asarray(X_bool.sum(axis=1)).ravel() > 0
        degree[nonzero] = np.power(np.asarray(X_bool.sum(axis=1)).ravel()[nonzero], -beta)
        Piu = l1_normalize_rows(X_bool)

        if alpha != 1.0:
            Pui = Pui.power(alpha)
            Piu = Piu.power(alpha)

        # column j of the walk matrix is scaled by degree[j]^(-beta) BEFORE
        # the top-K selection (the reference scales inside the block loop,
        # RP3betaRecommender.py, so selection sees the scaled values)
        cv, cix = _walk_topk_pruned(
            dense_from_sparse(sps.csr_matrix(Piu, dtype=np.float32)),
            dense_from_sparse(sps.csr_matrix(Pui, dtype=np.float32)),
            jnp.asarray(degree),
            topk=min(topK, self.n_items) if topK else self.n_items,
            l1_normalize=bool(normalize_similarity),
        )
        self._finish_w(cv, cix)
