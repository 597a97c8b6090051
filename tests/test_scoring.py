import numpy as np
import pytest

import jax.numpy as jnp

from ganmf_tpu.ops.scoring import masked_topk_matmul


@pytest.mark.parametrize("I", [64, 96])
def test_masked_topk_matches_dense(I):
    """The MF route (U_b x V^T through the fused XLA program) ranks and
    probes exactly like a dense numpy scoring of the same factors."""
    rng = np.random.RandomState(0)
    B, K, k, P = 8, 16, 5, 3
    U = rng.randn(B, K).astype(np.float32)
    V = rng.randn(I, K).astype(np.float32)
    mask = rng.rand(B, I) < 0.2
    pair_ids = rng.randint(0, I, (B, P)).astype(np.int32)

    vals, idx, ps, pf = masked_topk_matmul(
        jnp.asarray(U), jnp.asarray(V).T, jnp.asarray(mask), jnp.asarray(pair_ids), k=k
    )
    scores = U.astype(np.float64) @ V.T.astype(np.float64)
    scores[mask] = -np.inf
    ref_idx = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    np.testing.assert_allclose(
        np.asarray(vals), np.take_along_axis(scores, ref_idx, axis=1), rtol=1e-5, atol=1e-5
    )
    np.testing.assert_array_equal(np.asarray(idx), ref_idx)
    probe = np.take_along_axis(scores, pair_ids, axis=1)
    fin = np.isfinite(probe)
    np.testing.assert_array_equal(np.asarray(pf) > 0, fin)
    np.testing.assert_allclose(np.asarray(ps), np.where(fin, probe, 0.0), rtol=1e-5, atol=1e-5)


def test_recommend_fused_matches_recommend(urm_pair):
    from ganmf_tpu.models import PureSVDRecommender

    train, _ = urm_pair
    model = PureSVDRecommender(train)
    model.fit(num_factors=6)
    users = np.arange(10)
    regular = model.recommend(users, cutoff=7, remove_seen_flag=True)
    fused = model.recommend_fused(users, cutoff=7, remove_seen_flag=True)
    assert fused == regular


def test_recommend_fused_mf_cold_users_and_unmasked(urm_pair):
    """Cold users get empty lists from both routes (score_device scores
    them -inf), with and without the seen mask."""
    from ganmf_tpu.models import PureSVDRecommender

    train, _ = urm_pair
    train = train.tolil()
    train[3] = 0
    train[7] = 0
    train = train.tocsr()
    train.eliminate_zeros()
    model = PureSVDRecommender(train)
    model.fit(num_factors=6)
    users = np.arange(12)
    for flag in (True, False):
        fused = model.recommend_fused(users, cutoff=7, remove_seen_flag=flag)
        assert fused == model.recommend(users, cutoff=7, remove_seen_flag=flag)
        assert fused[3] == [] and fused[7] == []


def test_recommend_fused_similarity_matches_recommend(urm_pair):
    """The similarity-family device serving path returns identical lists to
    the reference-shaped recommend() (same scores, same tie resolution);
    models without device operands fall back to recommend()."""
    import numpy as np

    from ganmf_tpu.models import ItemKNNCFRecommender, TopPop
    from ganmf_tpu.models.itemknn import UserKNNCFRecommender

    train, _ = urm_pair
    users = np.arange(train.shape[0])

    for model in (ItemKNNCFRecommender(train), UserKNNCFRecommender(train)):
        model.fit(topK=9, shrink=0)
        ref = model.recommend(users, cutoff=7, remove_seen_flag=True)
        fused = model.recommend_fused(users, cutoff=7, remove_seen_flag=True)
        assert fused == ref, type(model).__name__

    tp = TopPop(train)
    tp.fit()
    assert tp.recommend_fused(users[:5], cutoff=7) == tp.recommend(users[:5], cutoff=7)


def test_split_plane_serving_gate(urm_pair, monkeypatch):
    """The split-bf16-plane scoring path only engages above the catalog-size
    gate (base._SIM_SPLIT_MIN_ITEMS): it is a different — equally valid —
    f32 rounding of the same real scores, so exact f64 ties (common in
    binary co-occurrence data) may rank differently than HIGHEST. Below the
    gate the operands stay f32 (bitwise contract with recommend()); above
    it they are bf16 planes, and any list divergence vs recommend() must be
    an exact tie in f64 arithmetic."""
    import jax.numpy as jnp

    from ganmf_tpu.models import base as base_mod
    from ganmf_tpu.models.itemknn import ItemKNNCFRecommender, UserKNNCFRecommender

    train, _ = urm_pair
    users = np.arange(train.shape[0])
    for cls in (ItemKNNCFRecommender, UserKNNCFRecommender):
        model = cls(train)
        model.fit(topK=9, shrink=0)
        uids = jnp.arange(8)

        monkeypatch.setattr(base_mod, "_SIM_SPLIT_MIN_ITEMS", 10**9)
        rows, right = model._fused_serving_operands(uids)
        assert not isinstance(rows, tuple) and not isinstance(right, tuple)

        monkeypatch.setattr(base_mod, "_SIM_SPLIT_MIN_ITEMS", 0)
        model._device_w_planes = None
        rows, right = model._fused_serving_operands(uids)
        assert isinstance(rows, tuple) or isinstance(right, tuple)

        ref = model.recommend(users, cutoff=7, remove_seen_flag=True)
        fused = model.recommend_fused(users, cutoff=7, remove_seen_flag=True)
        if fused != ref:
            # every divergence must be a permutation of exactly-tied scores
            W64 = np.asarray(model.W_sparse.todense(), dtype=np.float64)
            A64 = np.asarray(train.todense(), dtype=np.float64)
            s64 = W64 @ A64 if cls is UserKNNCFRecommender else A64 @ W64
            for u, (lf, lr) in enumerate(zip(fused, ref)):
                if lf != lr:
                    assert sorted(np.round(s64[u, lf], 12)) == sorted(np.round(s64[u, lr], 12)), u


def test_masked_topk_matmul_mask_from_rows(urm_pair):
    """mask_from_rows derives the exclusion from the left operand (the
    user profile) — identical output to an explicit seen mask."""
    import jax.numpy as jnp

    rng = np.random.RandomState(11)
    B, I, P, k = 16, 120, 6, 10
    rows = (rng.rand(B, I) < 0.2).astype(np.float32)
    W = rng.randn(I, I).astype(np.float32)
    pair_ids = rng.randint(0, I, (B, P)).astype(np.int32)
    rows_j, W_j = jnp.asarray(rows), jnp.asarray(W)
    pid = jnp.asarray(pair_ids)
    seen = jnp.asarray(rows != 0)

    ref = masked_topk_matmul(rows_j, W_j, seen, pid, k=k)
    got = masked_topk_matmul(rows_j, W_j, None, pid, k=k, mask_from_rows=True)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_padded_rows_dense_crop_exact():
    """max_len crops are exact whenever every selected row's nnz fits: the
    padded planes are left-justified with an all-sentinel tail."""
    import jax.numpy as jnp
    import scipy.sparse as sps

    from ganmf_tpu.data.device import padded_csr_from_sparse, padded_rows_dense, padded_rows_mask

    rng = np.random.RandomState(3)
    m = sps.random(40, 60, density=0.1, random_state=rng, format="csr", dtype=np.float32)
    # one heavy row forces a wide global plane
    m[0, :50] = 1.0
    m = sps.csr_matrix(m)
    pc = padded_csr_from_sparse(m)
    lens = np.diff(m.indptr)
    light = np.where(lens <= 8)[0][:10]
    uids = jnp.asarray(light, dtype=jnp.int32)
    full = padded_rows_dense(pc, uids, m.shape[1])
    crop = padded_rows_dense(pc, uids, m.shape[1], max_len=8)
    np.testing.assert_array_equal(np.asarray(full), np.asarray(crop))
    np.testing.assert_array_equal(
        np.asarray(padded_rows_mask(pc, uids, m.shape[1], max_len=8)),
        np.asarray(full != 0),
    )


def test_eval_length_ordered_blocks_match_dense(urm_pair, monkeypatch):
    """Length-ordered cropped blocks + mask_from_rows + split-plane scoring
    give the same metrics as the pre-optimization path (forced single uncropped
    ordering via a tiny block size and the gate pinned high/low)."""
    from ganmf_tpu.eval import EvaluatorHoldout
    from ganmf_tpu.models import base as base_mod
    from ganmf_tpu.models.itemknn import ItemKNNCFRecommender

    train, test = urm_pair
    ev = EvaluatorHoldout(test, cutoff_list=[5, 10])

    m = ItemKNNCFRecommender(train)
    m.fit(topK=12, shrink=0)

    monkeypatch.setattr(base_mod, "_SIM_SPLIT_MIN_ITEMS", 10**9)
    ref, _ = ev.evaluateRecommender(m)

    monkeypatch.setattr(base_mod, "_SIM_SPLIT_MIN_ITEMS", 0)
    m._device_w_planes = None
    got, _ = ev.evaluateRecommender(m)

    for c in ref:
        for metric in ("MAP", "NDCG", "PRECISION", "RECALL", "RMSE"):
            assert got[c][metric] == pytest.approx(ref[c][metric], abs=2e-5), (c, metric)
