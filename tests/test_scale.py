"""Streamed (beyond-HBM) path equivalence: every component that switches
representation above the dense-URM budget must produce the same numbers as
the dense path on a small matrix where both run.

These guards came out of the ML-20M scale proof (VERDICT r3 #1): the
evaluator's dense test matrix, similarity Gram builds, PureSVD and
profile-row gathers all assumed a dense [U, I] on device.
"""

import numpy as np
import pytest
import scipy.sparse as sps

from ganmf_tpu.eval import EvaluatorHoldout
from ganmf_tpu.models import ItemKNNCFRecommender, PureSVDRecommender
from ganmf_tpu.ops import similarity as simmod


def _rand_urm(u=60, i=40, density=0.15, seed=0, binary=False):
    rng = np.random.RandomState(seed)
    m = (rng.rand(u, i) < density).astype(np.float32)
    if not binary:
        m *= rng.randint(1, 6, size=(u, i)).astype(np.float32)
    m[0] = 0  # a cold user
    csr = sps.csr_matrix(m)
    csr.eliminate_zeros()
    return csr


@pytest.mark.parametrize("similarity", ["cosine", "jaccard", "asymmetric", "euclidean"])
def test_streamed_gram_matches_dense(monkeypatch, similarity):
    urm = _rand_urm()
    dense = simmod.compute_similarity(urm, similarity=similarity, topK=10, shrink=1.0)
    monkeypatch.setattr(simmod, "_DENSE_A_BYTE_LIMIT", 1)  # force streaming
    # the CPU reports no memory limit; size the gate as on an 80 GB device
    monkeypatch.setattr(simmod, "_device_memory_bytes", lambda: 80 << 30)
    streamed = simmod.compute_similarity(urm, similarity=similarity, topK=10, shrink=1.0)
    np.testing.assert_allclose(dense.toarray(), streamed.toarray(), rtol=2e-5, atol=2e-6)


def test_resident_gram_matches_streamed_and_dense(monkeypatch):
    # binary data in the streamed regime takes the resident-bf16 Gram
    # (no per-chunk scatter); starving the HBM gate falls back to the
    # scatter-streamed bf16 Gram. Same chunking, dtype and accumulation
    # order => bitwise-equal pruned W.
    urm = _rand_urm(seed=5, binary=True)
    dense = simmod.compute_similarity(urm, similarity="cosine", topK=10, shrink=1.0)
    monkeypatch.setattr(simmod, "_DENSE_A_BYTE_LIMIT", 1)  # force streaming
    # the CPU reports no memory limit; size the gate as on an 80 GB device
    monkeypatch.setattr(simmod, "_device_memory_bytes", lambda: 80 << 30)
    resident = simmod.compute_similarity(urm, similarity="cosine", topK=10, shrink=1.0)
    monkeypatch.setattr(simmod, "_device_memory_bytes", lambda: 1)  # starve the resident gate
    streamed = simmod.compute_similarity(urm, similarity="cosine", topK=10, shrink=1.0)
    np.testing.assert_array_equal(resident.toarray(), streamed.toarray())
    np.testing.assert_allclose(dense.toarray(), resident.toarray(), rtol=2e-5, atol=2e-6)


def test_device_memory_bytes_reads_the_device_limit(monkeypatch):
    """Slab sizing reads the device's own allocation limit, and a device
    that reports none (the CPU) is an error, not a guessed default."""
    import jax

    with pytest.raises(RuntimeError, match="reports no memory limit"):
        simmod._device_memory_bytes()

    class _Dev:
        platform, device_kind = "gpu", "fake"

        def memory_stats(self):
            return {"bytes_limit": 60 << 30, "bytes_in_use": 0}

    monkeypatch.setattr(jax, "devices", lambda *a: [_Dev()])
    assert simmod._device_memory_bytes() == 60 << 30


def test_streamed_gram_row_weights(monkeypatch):
    urm = _rand_urm(seed=3)
    rw = np.random.RandomState(1).rand(urm.shape[0]).astype(np.float32) + 0.5
    dense = simmod.compute_similarity(urm, similarity="cosine", topK=12, row_weights=rw)
    monkeypatch.setattr(simmod, "_DENSE_A_BYTE_LIMIT", 1)
    streamed = simmod.compute_similarity(urm, similarity="cosine", topK=12, row_weights=rw)
    np.testing.assert_allclose(dense.toarray(), streamed.toarray(), rtol=2e-5, atol=2e-6)


def test_puresvd_streamed_matches_dense(monkeypatch):
    from ganmf_tpu.models import puresvd as puresvd_mod

    urm = _rand_urm(u=70, i=30, seed=5)
    m_dense = PureSVDRecommender(urm)
    m_dense.fit(num_factors=8, random_seed=7)
    scores_dense = np.asarray(m_dense.score_device(np.arange(10)))

    m_str = PureSVDRecommender(urm)
    monkeypatch.setattr(type(m_str), "_DENSE_URM_BYTE_LIMIT", 1)
    monkeypatch.setattr(puresvd_mod, "_RESIDENT_BF16_LIMIT", 0)  # pin streamed
    assert m_str._urm_streams()
    m_str.fit(num_factors=8, random_seed=7)
    scores_str = np.asarray(m_str.score_device(np.arange(10)))
    # same RNG key, same range-finder: factors agree to float tolerance
    np.testing.assert_allclose(scores_dense, scores_str, rtol=5e-4, atol=5e-5)


def test_puresvd_resident_bf16_matches_dense(monkeypatch):
    """The resident-bf16 randomized SVD (beyond-f32-HBM fast path) finds
    the same rank-k model as the dense f32 program: the bf16 rounding of
    the power iterate only perturbs the oversampled subspace, and the
    split-plane final projection recovers ~16-bit-accurate factors. The
    receipt is the reconstruction quality, not bitwise factors: both
    rank-k approximations must be near the f64 optimum."""
    from ganmf_tpu.models import puresvd as puresvd_mod

    urm = _rand_urm(u=96, i=40, density=0.3, seed=9)
    A = urm.toarray().astype(np.float64)
    k = 8

    m_dense = PureSVDRecommender(urm)
    m_dense.fit(num_factors=k, random_seed=7)
    r_dense = np.asarray(m_dense.USER_factors) @ np.asarray(m_dense.ITEM_factors).T

    m_res = PureSVDRecommender(urm)
    monkeypatch.setattr(type(m_res), "_DENSE_URM_BYTE_LIMIT", 1)
    assert m_res._urm_streams()
    assert m_res._urm_values_bf16_exact()  # integer ratings are bf16-exact
    m_res.fit(num_factors=k, random_seed=7)
    r_res = np.asarray(m_res.USER_factors) @ np.asarray(m_res.ITEM_factors).T

    # optimal rank-k error from the exact SVD
    s = np.linalg.svd(A, compute_uv=False)
    opt = np.sqrt((s[k:] ** 2).sum())
    err_dense = np.linalg.norm(A - r_dense)
    err_res = np.linalg.norm(A - r_res)
    assert err_res <= err_dense * (1 + 1e-3), (err_res, err_dense, opt)
    # and the two models agree pointwise to bf16-subspace tolerance
    np.testing.assert_allclose(r_res, r_dense, rtol=0, atol=5e-3 * np.abs(r_dense).max())


def test_streamed_profile_rows_eval_equivalence(monkeypatch):
    """Full evaluator run of a similarity model with the URM forced into
    padded-CSR streaming equals the dense-URM run."""
    train = _rand_urm(u=50, i=36, seed=11)
    test = _rand_urm(u=50, i=36, seed=12)

    knn = ItemKNNCFRecommender(train)
    knn.fit(topK=8, shrink=0.5, similarity="cosine")
    ev = EvaluatorHoldout(test, cutoff_list=[5, 10])
    res_dense, _ = ev.evaluateRecommender(knn)

    knn2 = ItemKNNCFRecommender(train)
    monkeypatch.setattr(type(knn2), "_DENSE_URM_BYTE_LIMIT", 1, raising=False)
    assert knn2._urm_streams()
    knn2.fit(topK=8, shrink=0.5, similarity="cosine")
    ev2 = EvaluatorHoldout(test, cutoff_list=[5, 10])
    res_str, _ = ev2.evaluateRecommender(knn2)

    for c in (5, 10):
        for metric in ("MAP", "NDCG", "PRECISION", "RECALL", "RMSE"):
            a, b = res_dense[c][metric], res_str[c][metric]
            assert a == pytest.approx(b, rel=1e-5, abs=1e-7), (c, metric, a, b)


def test_ials_flat_csr_matches_padded_and_dense(monkeypatch):
    """Head-heavy orientations (ML-20M: top item has ~100k raters) switch
    the streamed IALS storage from padded-CSR (O(rows * max_row_nnz)) to
    flat CSR (exactly O(nnz)). All three storages must produce bitwise
    identical factors."""
    import numpy as np

    from ganmf_tpu.models import IALSRecommender
    from ganmf_tpu.models import ials as ialsmod
    from tests.conftest import random_urm

    urm = random_urm(50, 30, density=0.3, seed=2)
    cfg = dict(epochs=3, num_factors=8, alpha=2.0, reg=1e-2)
    dense = IALSRecommender(urm); dense.fit(**cfg)
    padded = IALSRecommender(urm); padded.fit(urm_storage="csr", **cfg)
    monkeypatch.setattr(ialsmod, "_PAD_PLANE_BYTE_LIMIT", 1)
    flat = IALSRecommender(urm); flat.fit(urm_storage="csr", **cfg)

    assert flat._store_users[0] == "flat" and flat._store_items[0] == "flat"
    assert padded._store_users[0] == "padded"
    np.testing.assert_array_equal(flat.USER_factors, padded.USER_factors)
    np.testing.assert_array_equal(flat.ITEM_factors, padded.ITEM_factors)
    np.testing.assert_allclose(flat.USER_factors, dense.USER_factors, atol=1e-6)
