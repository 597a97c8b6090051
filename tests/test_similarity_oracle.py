"""Element-wise similarity-kernel checks against the reference formulas
(Compute_Similarity_Python.py:209-383, Compute_Similarity_Euclidean.py)."""

import numpy as np
import pytest

from ganmf_tpu.ops.similarity import compute_similarity
from tests.conftest import random_urm


@pytest.fixture(scope="module")
def data():
    urm = random_urm(60, 50, density=0.25, seed=12, implicit=False)
    # add a couple of cold items (all-zero columns) to exercise NaN handling
    dense = np.asarray(urm.todense())
    dense[:, 7] = 0
    dense[:, 23] = 0
    import scipy.sparse as sps

    return sps.csr_matrix(dense)


def _dense_W(urm, **kwargs):
    return np.asarray(compute_similarity(urm, topK=urm.shape[1], **kwargs).todense())


def test_tversky_formula_and_forced_unnormalized(data):
    """normalize=True must be overridden for the binary family
    (reference constructor :77-87)."""
    A = (np.asarray(data.todense()) != 0).astype(np.float64)
    ss2 = A.sum(axis=0)
    ta, tb, shrink = 0.7, 1.4, 5
    got = _dense_W(data, similarity="tversky", shrink=shrink, normalize=True,
                   tversky_alpha=ta, tversky_beta=tb)
    G = A.T @ A
    np.fill_diagonal(G, 0.0)
    den = G + (ss2[None, :] - G) * ta + (ss2[:, None] - G) * tb + shrink + 1e-6
    expected = G / den
    np.fill_diagonal(expected, 0.0)
    np.testing.assert_allclose(got, expected, atol=1e-5)


def test_jaccard_and_dice(data):
    A = (np.asarray(data.todense()) != 0).astype(np.float64)
    ss2 = A.sum(axis=0)
    G = A.T @ A
    np.fill_diagonal(G, 0.0)
    expected_j = G / (ss2[:, None] + ss2[None, :] - G + 1e-6)
    expected_d = G / (ss2[:, None] + ss2[None, :] + 1e-6)
    np.fill_diagonal(expected_j, 0.0)
    np.fill_diagonal(expected_d, 0.0)
    np.testing.assert_allclose(_dense_W(data, similarity="jaccard", shrink=0, normalize=True), expected_j, atol=1e-5)
    np.testing.assert_allclose(_dense_W(data, similarity="dice", shrink=0, normalize=True), expected_d, atol=1e-5)


def test_asymmetric_orientation(data):
    A = np.asarray(data.todense(), np.float64)
    alpha = 0.8
    ss = np.sqrt((A**2).sum(axis=0))
    G = A.T @ A
    np.fill_diagonal(G, 0.0)
    # alpha weights the target column j (Compute_Similarity_Python.py:248-312)
    den = np.power(ss, 2 * (1 - alpha))[:, None] * np.power(ss, 2 * alpha)[None, :] + 1e-6
    expected = G / den
    np.fill_diagonal(expected, 0.0)
    got = _dense_W(data, similarity="asymmetric", shrink=0, normalize=True, asymmetric_alpha=alpha)
    np.testing.assert_allclose(got, expected, atol=1e-4)


def test_euclidean_no_nans_with_cold_items(data):
    got = _dense_W(data, similarity="euclidean", shrink=2, normalize=True,
                   similarity_from_distance_mode="exp")
    assert np.isfinite(got).all()
    # cold columns still produce rankings without poisoning others
    A = np.asarray(data.todense(), np.float64)
    ss2 = (A**2).sum(axis=0)
    warm = np.where(ss2 > 0)[0][:5]
    ss = np.sqrt(ss2)
    for j in warm:
        d = ss2 + ss2[j] - 2 * (A.T @ A[:, j])
        d[j] = 0.0
        with np.errstate(divide="ignore", invalid="ignore"):
            d = d / (ss[j] * ss)
        d = np.sqrt(np.maximum(d, 0))
        s = 1.0 / (np.exp(d) + 2 + 1e-9)
        s[j] = 0.0
        s[~np.isfinite(s)] = 0.0
        warm_rows = ss2 > 0
        # tolerance covers the deliberate ~1e-6 relative tie-break jitter
        np.testing.assert_allclose(got[warm_rows, j], s[warm_rows], rtol=1e-4)


def test_pearson_and_adjusted_run(data):
    for sim in ("pearson", "adjusted"):
        W = _dense_W(data, similarity=sim, shrink=1, normalize=True)
        assert np.isfinite(W).all()
        assert np.all(np.diag(W) == 0)


def test_device_export_equals_csr_export(data):
    """export='device' must be value-identical to the host CSR assembly
    (same top-K winners, exact zeros dropped on conversion either way)."""
    import scipy.sparse as sps

    for sim in ("cosine", "jaccard", "euclidean"):
        csr = compute_similarity(data, similarity=sim, topK=11, shrink=0.5)
        dev = compute_similarity(data, similarity=sim, topK=11, shrink=0.5, export="device")
        back = sps.csr_matrix(np.asarray(dev))
        assert back.nnz == csr.nnz, sim
        assert np.array_equal(back.indices, csr.indices), sim
        np.testing.assert_array_equal(back.toarray(), csr.toarray(), err_msg=sim)


def test_device_export_rejects_bad_args(data):
    with pytest.raises(ValueError):
        compute_similarity(data, topK=5, export="parquet")


def test_bf16_gram_exact_on_binary():
    """Binary data takes the one-pass bf16 Gram (similarity.py bf16_ok):
    0/1 are exact in bf16 and the accumulator is f32, so the Gram — and
    therefore the pruned W — must be bitwise identical to the f32-HIGHEST
    build (device check: scripts/bf16_gram_receipt.py)."""
    import os

    import jax.numpy as jnp

    from ganmf_tpu.data.device import padded_csr_from_sparse
    from ganmf_tpu.ops.similarity import _gram_streamed

    urm = random_urm(64, 48, density=0.3, seed=3, implicit=True)
    pc = padded_csr_from_sparse(urm)
    w = jnp.ones((urm.shape[0],), jnp.float32)
    G_hi = _gram_streamed(pc.idx, pc.val, w, n_cols=48, chunk=16,
                          use_row_weights=False, bf16_ok=False)
    G_bf = _gram_streamed(pc.idx, pc.val, w, n_cols=48, chunk=16,
                          use_row_weights=False, bf16_ok=True)
    assert bool(jnp.array_equal(G_hi, G_bf))

    for sim in ("cosine", "jaccard"):
        ws = []
        for flag in ("0", "1"):
            os.environ["GANMF_TPU_BF16_GRAM"] = flag
            try:
                ws.append(compute_similarity(urm, similarity=sim, topK=7))
            finally:
                os.environ.pop("GANMF_TPU_BF16_GRAM", None)
        assert (ws[0] != ws[1]).nnz == 0, sim


def test_padded_csr_device_build_matches_host():
    """The device-built padded planes (data.device._padded_build) must equal
    the host construction for general (non-binary) and binary matrices."""
    import jax.numpy as jnp

    from ganmf_tpu.data.device import PaddedCSR, padded_csr_from_sparse

    for implicit in (True, False):
        urm = random_urm(37, 29, density=0.2, seed=11, implicit=implicit)
        csr = urm.tocsr().astype(np.float32)
        R, C = csr.shape
        lens = np.ediff1d(csr.indptr)
        L = max(int(lens.max()), 1)
        idx = np.full((R, L), C, dtype=np.int32)
        val = np.zeros((R, L), np.float32)
        rows = np.repeat(np.arange(R), lens)
        offs = np.arange(csr.nnz) - np.repeat(csr.indptr[:-1], lens)
        idx[rows, offs] = csr.indices
        val[rows, offs] = csr.data
        got = padded_csr_from_sparse(urm)
        assert isinstance(got, PaddedCSR)
        assert np.array_equal(np.asarray(got.idx), idx), implicit
        assert np.array_equal(np.asarray(got.val), val), implicit


def test_padded_csr_content_cache():
    """Equal-content matrices (every model .copy()s its URM) must share one
    cached plane set; different content must not."""
    from ganmf_tpu.data import device as devmod

    devmod._PADDED_CACHE.clear()
    urm = random_urm(23, 17, density=0.25, seed=7, implicit=True)
    a = padded_csr_from_sparse_fresh(urm)
    b = padded_csr_from_sparse_fresh(urm.copy())
    assert a.idx is b.idx and a.val is b.val  # digest hit, same device arrays
    other = urm.copy()
    other.data = other.data * 2.0
    c = padded_csr_from_sparse_fresh(other)
    assert c.val is not a.val
    assert not np.array_equal(np.asarray(c.val), np.asarray(a.val))
    # cache=False bypasses both lookup and store
    d = devmod.padded_csr_from_sparse(urm, cache=False)
    assert d.idx is not a.idx
    assert np.array_equal(np.asarray(d.idx), np.asarray(a.idx))


def padded_csr_from_sparse_fresh(m):
    from ganmf_tpu.data.device import padded_csr_from_sparse

    return padded_csr_from_sparse(m)


def test_colblocked_streamed_equals_dense(monkeypatch):
    """Forcing the column-blocked streamed build (tiny Gram budget) must
    reproduce the dense single-shot build to f32 round-off. The Gram itself
    is bitwise exact for binary data (test_bf16_gram_exact_on_binary); the
    final division can differ by 1 ULP across program shapes (XLA fuses it
    differently), so the pruned W is compared with a round-off tolerance."""
    from ganmf_tpu.ops import similarity as simmod

    binary = random_urm(48, 40, density=0.25, seed=5, implicit=True)
    explicit = random_urm(48, 40, density=0.25, seed=6, implicit=False)
    cases = [(binary, s) for s in ("cosine", "jaccard", "euclidean")]
    cases += [(explicit, s) for s in ("cosine", "asymmetric")]
    expected = [compute_similarity(m, similarity=s, topK=9, shrink=0.5) for m, s in cases]

    monkeypatch.setattr(simmod, "_DENSE_A_BYTE_LIMIT", 1)  # force streamed
    monkeypatch.setattr(simmod, "_GRAM_BYTE_LIMIT", 4 * 40 * 16)  # force col blocks
    # the CPU reports no memory limit; size slabs as on an 80 GB device
    monkeypatch.setattr(simmod, "_device_memory_bytes", lambda: 80 << 30)
    for (m, s), exp in zip(cases, expected):
        got = compute_similarity(m, similarity=s, topK=9, shrink=0.5)
        assert got.nnz == exp.nnz, s
        np.testing.assert_allclose(got.toarray(), exp.toarray(), rtol=1e-5, atol=1e-6,
                                   err_msg=s)
    with pytest.raises(ValueError):
        compute_similarity(binary, similarity="cosine", topK=9, export="device")


def test_colblocked_int8_matches_dense(monkeypatch):
    """Binary data in the column-blocked build keeps A resident as dense
    int8 and reads it per slab (int8 x int8 -> int32, exact for 0/1): the
    pruned W must match the dense single-shot build to f32 round-off, and
    disabling the int8 budget must route through the bf16 slab path with
    identical output."""
    from ganmf_tpu.ops import similarity as simmod

    binary = random_urm(48, 40, density=0.25, seed=9, implicit=True)
    expected = {s: compute_similarity(binary, similarity=s, topK=9, shrink=0.5)
                for s in ("cosine", "jaccard")}

    monkeypatch.setattr(simmod, "_DENSE_A_BYTE_LIMIT", 1)  # force streamed
    monkeypatch.setattr(simmod, "_GRAM_BYTE_LIMIT", 4 * 40 * 16)  # force col blocks
    # the CPU reports no memory limit; size slabs as on an 80 GB device
    monkeypatch.setattr(simmod, "_device_memory_bytes", lambda: 80 << 30)
    for s, exp in expected.items():
        got_int8 = compute_similarity(binary, similarity=s, topK=9, shrink=0.5)
        monkeypatch.setattr(simmod, "_INT8_A_BYTE_LIMIT", 0)
        got_bf16 = compute_similarity(binary, similarity=s, topK=9, shrink=0.5)
        monkeypatch.setattr(simmod, "_INT8_A_BYTE_LIMIT", 1 << 40)
        assert (got_int8 != got_bf16).nnz == 0, s  # same Gram -> same W
        np.testing.assert_allclose(got_int8.toarray(), exp.toarray(),
                                   rtol=1e-5, atol=1e-6, err_msg=s)
