"""KNN collaborative-filtering recommenders.

ItemKNN (reference KNN/ItemKNNCFRecommender.py:18-54): optional BM25/TF-IDF
reweighting, then item-item similarity built on the device
(ops/similarity.py). UserKNN is the
user-side analogue (reference KNN/UserKNNCFRecommender.py). ItemKNN with a
caller-provided W covers ItemKNNCustomSimilarity, and a similarity-hybrid
combinator matches ItemKNNSimilarityHybridRecommender.
"""

from __future__ import annotations

import numpy as np

from ganmf_tpu.models.base import ItemSimilarityRecommender, UserSimilarityRecommender, check_matrix, similarity_matrix_topk
from ganmf_tpu.ops.similarity import compute_similarity
from ganmf_tpu.utils.weighting import TF_IDF, okapi_BM_25

FEATURE_WEIGHTING_VALUES = ["BM25", "TF-IDF", "none"]


class ItemKNNCFRecommender(ItemSimilarityRecommender):
    RECOMMENDER_NAME = "ItemKNNCFRecommender"

    def fit(
        self,
        topK: int = 50,
        shrink: float = 100,
        similarity: str = "cosine",
        normalize: bool = True,
        feature_weighting: str = "none",
        **similarity_args,
    ):
        self.topK = topK
        self.shrink = shrink
        if feature_weighting not in FEATURE_WEIGHTING_VALUES:
            raise ValueError(f"feature_weighting must be one of {FEATURE_WEIGHTING_VALUES}")

        if feature_weighting == "BM25":
            self.URM_train = check_matrix(okapi_BM_25(self.URM_train.T.astype(np.float32)).T, "csr")
            self._invalidate_device_cache()
        elif feature_weighting == "TF-IDF":
            self.URM_train = check_matrix(TF_IDF(self.URM_train.T.astype(np.float32)).T, "csr")
            self._invalidate_device_cache()

        n = self.n_items
        if similarity_args.get("mesh_plan") is None and 4 * n * n <= self._DENSE_W_BYTE_LIMIT:
            # device-authoritative W: the [I, topK] winners never leave the
            # chip; host CSR materializes lazily on saveModel/composition
            self._adopt_device_w(
                compute_similarity(
                    self.URM_train, similarity=similarity, topK=topK, shrink=shrink,
                    normalize=normalize, export="device", **similarity_args,
                )
            )
        else:
            self.W_sparse = check_matrix(
                compute_similarity(
                    self.URM_train, similarity=similarity, topK=topK, shrink=shrink,
                    normalize=normalize, **similarity_args,
                ),
                "csr",
            )


class UserKNNCFRecommender(UserSimilarityRecommender):
    RECOMMENDER_NAME = "UserKNNCFRecommender"

    def fit(
        self,
        topK: int = 50,
        shrink: float = 100,
        similarity: str = "cosine",
        normalize: bool = True,
        feature_weighting: str = "none",
        **similarity_args,
    ):
        self.topK = topK
        self.shrink = shrink
        if feature_weighting not in FEATURE_WEIGHTING_VALUES:
            raise ValueError(f"feature_weighting must be one of {FEATURE_WEIGHTING_VALUES}")

        urm = self.URM_train
        if feature_weighting == "BM25":
            urm = check_matrix(okapi_BM_25(urm.astype(np.float32)), "csr")
        elif feature_weighting == "TF-IDF":
            urm = check_matrix(TF_IDF(urm.astype(np.float32)), "csr")

        # user-user similarity = column similarity of URM^T
        n = self.n_users
        if similarity_args.get("mesh_plan") is None and 4 * n * n <= self._DENSE_W_BYTE_LIMIT:
            self._adopt_device_w(
                compute_similarity(
                    urm.T.tocsr(), similarity=similarity, topK=topK, shrink=shrink,
                    normalize=normalize, export="device", **similarity_args,
                )
            )
        else:
            self.W_sparse = check_matrix(
                compute_similarity(
                    urm.T.tocsr(), similarity=similarity, topK=topK, shrink=shrink,
                    normalize=normalize, **similarity_args,
                ),
                "csr",
            )


class ItemKNNCBFRecommender(ItemSimilarityRecommender):
    """Content-based item KNN (reference KNN/ItemKNNCBFRecommender.py:17-52).

    Takes an ICM [n_items, n_features] alongside the URM; the item-item W is
    the column similarity of ICM^T (items as columns), with optional
    BM25/TF-IDF reweighting applied to the ICM rows exactly as the reference
    does (ItemKNNCBFRecommender.py:39-45). Scoring is the usual URM[u] @ W
    item-similarity path — content only enters through W.
    """

    RECOMMENDER_NAME = "ItemKNNCBFRecommender"

    def __init__(self, ICM, URM_train):
        super().__init__(URM_train)
        ICM = check_matrix(ICM, "csr")
        if ICM.shape[0] != self.n_items:
            raise ValueError(
                f"ICM has {ICM.shape[0]} rows but URM_train has {self.n_items} items"
            )
        self.ICM = ICM.copy()

    def fit(
        self,
        topK: int = 50,
        shrink: float = 100,
        similarity: str = "cosine",
        normalize: bool = True,
        feature_weighting: str = "none",
        **similarity_args,
    ):
        self.topK = topK
        self.shrink = shrink
        if feature_weighting not in FEATURE_WEIGHTING_VALUES:
            raise ValueError(f"feature_weighting must be one of {FEATURE_WEIGHTING_VALUES}")

        if feature_weighting == "BM25":
            self.ICM = check_matrix(okapi_BM_25(self.ICM.astype(np.float32)), "csr")
        elif feature_weighting == "TF-IDF":
            self.ICM = check_matrix(TF_IDF(self.ICM.astype(np.float32)), "csr")

        # similarity between items = columns of ICM^T ([F, I])
        icm_t = self.ICM.T.tocsr()
        n = self.n_items
        if similarity_args.get("mesh_plan") is None and 4 * n * n <= self._DENSE_W_BYTE_LIMIT:
            self._adopt_device_w(
                compute_similarity(
                    icm_t, similarity=similarity, topK=topK, shrink=shrink,
                    normalize=normalize, export="device", **similarity_args,
                )
            )
        else:
            self.W_sparse = check_matrix(
                compute_similarity(
                    icm_t, similarity=similarity, topK=topK, shrink=shrink,
                    normalize=normalize, **similarity_args,
                ),
                "csr",
            )


class ItemKNNCustomSimilarityRecommender(ItemSimilarityRecommender):
    """Scores with a caller-provided item-item similarity
    (reference KNN/ItemKNNCustomSimilarityRecommender.py)."""

    RECOMMENDER_NAME = "ItemKNNCustomSimilarityRecommender"

    def fit(self, W_sparse, selectTopK: bool = False, topK: int = 100):
        if selectTopK:
            W_sparse = similarity_matrix_topk(W_sparse, k=topK)
        self.W_sparse = check_matrix(W_sparse, "csr")


class ItemKNNSimilarityHybridRecommender(ItemSimilarityRecommender):
    """alpha * W1 + (1 - alpha) * W2
    (reference KNN/ItemKNNSimilarityHybridRecommender.py)."""

    RECOMMENDER_NAME = "ItemKNNSimilarityHybridRecommender"

    def __init__(self, URM_train, Similarity_1, Similarity_2):
        super().__init__(URM_train)
        if Similarity_1.shape != Similarity_2.shape:
            raise ValueError("Similarity matrices have different shapes")
        self.Similarity_1 = check_matrix(Similarity_1.copy(), "csr")
        self.Similarity_2 = check_matrix(Similarity_2.copy(), "csr")

    def fit(self, topK: int = 100, alpha: float = 0.5):
        self.topK = topK
        self.alpha = alpha
        W = self.Similarity_1 * alpha + self.Similarity_2 * (1 - alpha)
        self.W_sparse = check_matrix(similarity_matrix_topk(W, k=topK), "csr")
