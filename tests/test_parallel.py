"""Multi-chip tests on the virtual 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sps
import pytest

from ganmf_tpu.ops.topk import sharded_topk
from ganmf_tpu.parallel import init_distributed, make_distributed_ganmf_step, make_mesh


def test_mesh_shapes():
    plan = make_mesh(n_data=4, n_model=2)
    assert plan.n_data == 4 and plan.n_model == 2
    assert plan.n_slices == 1 and plan.n_user_shards == 4


def test_mesh_with_slices():
    """2x2x2 (slice, data, model) plan: user tensors shard over slice+data."""
    plan = make_mesh(n_data=2, n_model=2, n_slices=2)
    assert plan.n_slices == 2 and plan.n_data == 2 and plan.n_model == 2
    assert plan.n_user_shards == 4
    assert plan.user_axes == ("slice", "data")
    x = jax.device_put(jnp.arange(32.0).reshape(8, 4), plan.urm)
    # 8 rows over 4 user shards, 4 cols over 2 model shards -> 2x2 per device
    assert x.addressable_shards[0].data.shape == (2, 2)

    # the distributed GANMF step compiles and runs on the 3D mesh
    from ganmf_tpu.parallel import init_distributed, make_distributed_ganmf_step

    params, d_state, g_state = init_distributed(0, 16, 8, 4, 8, plan)
    rng = np.random.RandomState(0)
    urm = jax.device_put(jnp.asarray((rng.rand(16, 8) < 0.3).astype(np.float32)), plan.urm)
    uids = jax.device_put(jnp.arange(4, dtype=jnp.int32), plan.batch)
    w = jax.device_put(jnp.ones((4,), jnp.float32), plan.batch)
    step = make_distributed_ganmf_step(plan, 1.0, 0.1, 0.0, 0.0)
    _, _, _, dloss, gloss = step(
        params, d_state, g_state, urm, uids, w, jnp.float32(1e-3), jnp.float32(1e-3)
    )
    assert np.isfinite(float(dloss)) and np.isfinite(float(gloss))


def test_comm_initialize_noop_and_facade():
    from ganmf_tpu.parallel import comm

    comm.initialize()  # single-process: must be a silent no-op
    assert not comm.is_initialized()
    assert comm.process_count() == 1 and comm.process_index() == 0

    plan = make_mesh(n_data=4, n_model=2)
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    def body(x):
        return comm.psum(x, "data")

    y = shard_map(body, mesh=plan.mesh, in_specs=P("data"), out_specs=P("data"))(
        jnp.ones((8,), jnp.float32)
    )
    np.testing.assert_allclose(np.asarray(y), 4.0)


class _RandomScorer:
    """Minimal recommender exposing the evaluator's device interface."""

    def __init__(self, train, seed=0):
        self._train = train
        rng = np.random.RandomState(seed)
        self._scores = jnp.asarray(rng.randn(*train.shape).astype(np.float32))
        self._mask = jnp.asarray(np.asarray(train.todense()) > 0)

    def get_URM_train(self):
        return self._train

    def score_device(self, uids):
        return jnp.take(self._scores, uids, axis=0)

    def device_train_mask(self):
        return self._mask


def test_sharded_evaluator_matches_single(urm_pair):
    """EvaluatorHoldout(mesh_plan=...) == the single-device evaluator."""
    from ganmf_tpu.eval import EvaluatorHoldout

    train, test = urm_pair  # 50 users x 80 items; 80 % 2 == 0
    model = _RandomScorer(train)
    base, _ = EvaluatorHoldout(test, [5, 20]).evaluateRecommender(model)

    for kwargs in (dict(n_data=4, n_model=2), dict(n_data=2, n_model=2, n_slices=2)):
        plan = make_mesh(**kwargs)
        sharded, _ = EvaluatorHoldout(test, [5, 20], mesh_plan=plan).evaluateRecommender(model)
        for c in (5, 20):
            for metric, value in base[c].items():
                assert sharded[c][metric] == pytest.approx(value, rel=1e-5, abs=1e-7), (
                    c,
                    metric,
                    kwargs,
                )


def test_sharded_topk_matches_dense():
    plan = make_mesh(n_data=1, n_model=8)
    rng = np.random.RandomState(0)
    scores = rng.randn(6, 64).astype(np.float32)
    scores_dev = jax.device_put(jnp.asarray(scores), plan.named(None, "model"))
    vals, idx = sharded_topk(scores_dev, 5, plan)
    ref_idx = np.argsort(-scores, axis=1)[:, :5]
    np.testing.assert_array_equal(np.asarray(idx), ref_idx)
    np.testing.assert_allclose(np.asarray(vals), np.take_along_axis(scores, ref_idx, axis=1))


def test_distributed_ganmf_step_runs_and_reduces():
    plan = make_mesh(n_data=4, n_model=2)
    n_users, n_items, K, E, B = 32, 16, 4, 8, 8

    params, d_state, g_state = init_distributed(0, n_users, n_items, K, E, plan)
    rng = np.random.RandomState(0)
    urm = jax.device_put(
        jnp.asarray((rng.rand(n_users, n_items) < 0.3).astype(np.float32)), plan.urm
    )
    uids = jax.device_put(jnp.arange(B, dtype=jnp.int32), plan.batch)
    w = jax.device_put(jnp.ones((B,), jnp.float32), plan.batch)

    step = make_distributed_ganmf_step(plan, m=1.0, recon_coefficient=0.1, d_reg=0.0, g_reg=0.0)
    p0_item = np.asarray(params.item_emb)
    params, d_state, g_state, dloss, gloss = step(
        params, d_state, g_state, urm, uids, w, jnp.float32(1e-3), jnp.float32(1e-3)
    )
    assert np.isfinite(float(dloss)) and np.isfinite(float(gloss))
    # generator actually moved
    assert not np.allclose(np.asarray(params.item_emb), p0_item)
    # shardings preserved on outputs
    assert params.user_emb.sharding.spec == plan.user_rows.spec


@pytest.mark.parametrize("plan_kwargs", [dict(n_data=2, n_model=2), dict(n_data=2, n_model=2, n_slices=2)])
def test_distributed_step_matches_single_device(plan_kwargs):
    """The sharded step computes the same math as an unsharded one, on both
    the 2-axis (data, model) and the 3-axis (slice, data, model) mesh."""
    plan = make_mesh(**plan_kwargs)
    single = make_mesh(n_data=1, n_model=1)
    n_users, n_items, K, E, B = 16, 12, 3, 6, 4

    rng = np.random.RandomState(1)
    urm_np = (rng.rand(n_users, n_items) < 0.4).astype(np.float32)
    uids_np = np.arange(B, dtype=np.int32)
    w_np = np.ones((B,), np.float32)

    outs = []
    for p in (plan, single):
        params, d_state, g_state = init_distributed(7, n_users, n_items, K, E, p)
        step = make_distributed_ganmf_step(p, 1.0, 0.2, 1e-4, 1e-4)
        params, _, _, dloss, gloss = step(
            params, d_state, g_state,
            jax.device_put(jnp.asarray(urm_np), p.urm),
            jax.device_put(jnp.asarray(uids_np), p.batch),
            jax.device_put(jnp.asarray(w_np), p.batch),
            jnp.float32(1e-3), jnp.float32(1e-3),
        )
        outs.append((float(dloss), float(gloss), np.asarray(params.user_emb)))

    assert outs[0][0] == pytest.approx(outs[1][0], rel=1e-5)
    assert outs[0][1] == pytest.approx(outs[1][1], rel=1e-5)
    np.testing.assert_allclose(outs[0][2], outs[1][2], rtol=1e-4, atol=1e-6)


def test_ganmf_fit_on_mesh(urm_pair):
    """Full GANMF.fit with a mesh plan: same API, SPMD epochs."""
    from ganmf_tpu.models import GANMF
    from ganmf_tpu.eval import EvaluatorHoldout

    train, test = urm_pair
    plan = make_mesh(n_data=2, n_model=2)
    model = GANMF(train, mode="user", seed=42)
    model.fit(num_factors=8, emb_dim=16, epochs=3, batch_size=16, mesh_plan=plan)
    results, _ = EvaluatorHoldout(test, [5]).evaluateRecommender(model)
    assert np.isfinite(results[5]["MAP"])

    # numerically equivalent to the single-device fit
    single = GANMF(train, mode="user", seed=42)
    single.fit(num_factors=8, emb_dim=16, epochs=3, batch_size=16)
    np.testing.assert_allclose(
        np.asarray(model.params.user_emb), np.asarray(single.params.user_emb), rtol=2e-4, atol=2e-6
    )

    # and the full fit on the 3-axis (slice, data, model) mesh — the
    # multi-host outer-axis plan of parallel/mesh.py — matches the same trajectory
    sliced = GANMF(train, mode="user", seed=42)
    sliced.fit(num_factors=8, emb_dim=16, epochs=3, batch_size=16,
               mesh_plan=make_mesh(n_data=2, n_model=2, n_slices=2))
    np.testing.assert_allclose(
        np.asarray(sliced.params.user_emb), np.asarray(single.params.user_emb), rtol=2e-4, atol=2e-6
    )


@pytest.mark.parametrize("model_name", ["DisGANMF", "CFGAN", "CAAE", "IALS", "SLIM", "MFBPR"])
def test_trainer_mesh_plan_matches_single(urm_pair, model_name):
    """fit(mesh_plan=...) reproduces the single-device training math for
    every adversarial trainer, IALS, SLIM-BPR and MF-SGD (SURVEY §2.9)."""
    train, test = urm_pair
    plan = make_mesh(n_data=2, n_model=2)

    def build_and_fit(mesh_plan):
        if model_name == "DisGANMF":
            from ganmf_tpu.models import DisGANMF

            m = DisGANMF(train, mode="user", seed=5)
            m.fit(num_factors=4, d_layers=1, d_nodes=8, epochs=2, batch_size=16,
                  mesh_plan=mesh_plan)
            return np.asarray(m.params.user_emb)
        if model_name == "CFGAN":
            from ganmf_tpu.models import CFGAN

            m = CFGAN(train, mode="user", seed=5)
            m.fit(d_nodes=8, g_nodes=8, scheme="ZP", zr_ratio=0.3, zp_ratio=0.3,
                  zr_coefficient=0.1, epochs=2, d_batch_size=16, g_batch_size=16,
                  mesh_plan=mesh_plan)
            return np.asarray(m.params.G.ws[0])
        if model_name == "CAAE":
            from ganmf_tpu.models import CAAE

            m = CAAE(train, seed=5)
            m.fit(epochs=2, g_units=8, num_factors=4, d_bsize=64, m_batch=8,
                  mesh_plan=mesh_plan)
            return np.asarray(m.params.G.ws[0])
        if model_name == "SLIM":
            from ganmf_tpu.models import SLIM_BPR

            m = SLIM_BPR(train)
            m.fit(epochs=2, topK=10, learning_rate=0.05, mesh_plan=mesh_plan)
            return m.W_sparse.toarray()
        if model_name == "MFBPR":
            from ganmf_tpu.models import MatrixFactorization_BPR

            m = MatrixFactorization_BPR(train)
            m.fit(epochs=2, num_factors=4, batch_size=32, mesh_plan=mesh_plan)
            return np.asarray(m.USER_factors)
        from ganmf_tpu.models import IALSRecommender

        m = IALSRecommender(train)
        m.fit(epochs=2, num_factors=4, mesh_plan=mesh_plan)
        return np.asarray(m._U_dev)

    sharded = build_and_fit(plan)
    single = build_and_fit(None)
    np.testing.assert_allclose(sharded, single, rtol=2e-4, atol=2e-6)


def test_ganmf_csr_storage_composes_with_mesh(urm_pair):
    """urm_storage='csr' + mesh_plan (VERDICT r2 #4): the user-axis-sharded
    padded-CSR fit equals the dense single-device fit."""
    from ganmf_tpu.models import GANMF

    train, test = urm_pair
    plan = make_mesh(n_data=2, n_model=2)

    dense = GANMF(train, mode="user", seed=11)
    dense.fit(num_factors=4, emb_dim=8, epochs=3, batch_size=16)
    streamed = GANMF(train, mode="user", seed=11)
    streamed.fit(num_factors=4, emb_dim=8, epochs=3, batch_size=16,
                 urm_storage="csr", mesh_plan=plan)

    for got, want in zip(
        jax.tree_util.tree_leaves(streamed.params), jax.tree_util.tree_leaves(dense.params)
    ):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=2e-4, atol=2e-6)


def test_ials_csr_storage_matches_dense(urm_pair):
    """IALS urm_storage='csr' (streamed confidence blocks) == dense fit,
    single-device and on a mesh (VERDICT r2 #4 second-trainer extension)."""
    from ganmf_tpu.models import IALSRecommender

    train, test = urm_pair
    base = IALSRecommender(train)
    base.fit(epochs=3, num_factors=4, confidence_scaling="log", alpha=2.0)

    for plan in (None, make_mesh(n_data=2, n_model=2)):
        m = IALSRecommender(train)
        m.fit(epochs=3, num_factors=4, confidence_scaling="log", alpha=2.0,
              urm_storage="csr", mesh_plan=plan)
        np.testing.assert_allclose(
            np.asarray(m._U_dev), np.asarray(base._U_dev), rtol=2e-4, atol=2e-6
        )
        np.testing.assert_allclose(
            np.asarray(m._V_dev), np.asarray(base._V_dev), rtol=2e-4, atol=2e-6
        )


def test_ials_flat_csr_composes_with_mesh(monkeypatch):
    """Flat-CSR IALS x mesh (VERDICT r4 #3): rows shard over the mesh's row
    axes as stacked per-shard flat-CSR slices; results are bitwise the
    single-device flat fit on 2-axis and 3-axis meshes."""
    from ganmf_tpu.models import IALSRecommender
    from ganmf_tpu.models import ials as ials_mod

    monkeypatch.setattr(ials_mod, "_PAD_PLANE_BYTE_LIMIT", 1)  # force flat
    rng = np.random.RandomState(0)
    urm = sps.csr_matrix((rng.rand(64, 48) < 0.2).astype(np.float32))
    cfg = dict(epochs=3, num_factors=4, confidence_scaling="log", alpha=2.0,
               urm_storage="csr")

    single = IALSRecommender(urm)
    single.fit(**cfg)
    assert single._store_users[0] == "flat"

    for plan in (make_mesh(n_data=2, n_model=2),
                 make_mesh(n_data=2, n_model=2, n_slices=2)):
        m = IALSRecommender(urm)
        m.fit(mesh_plan=plan, **cfg)
        assert m._store_users[0] == "flat_sharded"
        assert m._store_items[0] == "flat_sharded"
        np.testing.assert_array_equal(np.asarray(m._U_dev), np.asarray(single._U_dev))
        np.testing.assert_array_equal(np.asarray(m._V_dev), np.asarray(single._V_dev))


def test_mf_sgd_csr_storage_composes_with_mesh(urm_pair):
    """MF-BPR urm_storage='csr' + mesh_plan: the user-axis-sharded padded-CSR
    fit equals the dense single-device fit (last streamable trainer from the
    round-2 roadmap; CAAE/SLIM-BPR are principled exclusions — ROADMAP.md)."""
    from ganmf_tpu.models import MatrixFactorization_BPR

    train, _ = urm_pair
    kwargs = dict(epochs=2, num_factors=4, batch_size=32)

    dense = MatrixFactorization_BPR(train)
    dense.fit(**kwargs)
    streamed = MatrixFactorization_BPR(train)
    streamed.fit(urm_storage="csr", mesh_plan=make_mesh(n_data=2, n_model=2), **kwargs)

    np.testing.assert_allclose(
        streamed.USER_factors, dense.USER_factors, rtol=2e-4, atol=2e-6
    )
    np.testing.assert_allclose(
        streamed.ITEM_factors, dense.ITEM_factors, rtol=2e-4, atol=2e-6
    )


def _assert_same_sparse(got, base):
    """Same sparsity pattern, values equal up to blockwise-matmul float
    jitter (the sharded Gram accumulates in a different order)."""
    assert ((got != 0).toarray() == (base != 0).toarray()).all()
    np.testing.assert_allclose(got.toarray(), base.toarray(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("similarity", ["cosine", "tversky", "euclidean"])
def test_sharded_similarity_build_matches_single(urm_pair, similarity):
    """compute_similarity(mesh_plan=...) shards the [I, I] build over the
    model axis and reproduces the single-device CSR (VERDICT r2 #6)."""
    from ganmf_tpu.ops.similarity import compute_similarity

    train, _ = urm_pair
    base = compute_similarity(train, similarity=similarity, topK=10, shrink=1.0)
    for n_model in (8, 5):  # both divide the 80-item catalog evenly
        plan = make_mesh(n_data=1, n_model=n_model)
        got = compute_similarity(
            train, similarity=similarity, topK=10, shrink=1.0, mesh_plan=plan
        )
        _assert_same_sparse(got, base)


def test_sharded_similarity_build_with_padding(urm_pair):
    """Shard count that does not divide the catalog exercises the
    zero-padded target columns."""
    from ganmf_tpu.ops.similarity import compute_similarity

    train, _ = urm_pair
    base = compute_similarity(train, similarity="cosine", topK=10, shrink=0.5)
    plan = make_mesh(n_data=1, n_model=7)  # 80 = 7 * 11 + 3 -> padded
    got = compute_similarity(train, similarity="cosine", topK=10, shrink=0.5, mesh_plan=plan)
    _assert_same_sparse(got, base)


def test_sharded_similarity_negative_values_with_padding():
    """Pearson mean-centering of RATED data produces negative similarities;
    padded candidate columns must rank below them (-inf mask), not above
    (0.0), or the sharded build silently drops real negative neighbours."""
    import scipy.sparse as sps

    from ganmf_tpu.ops.similarity import compute_similarity

    rng = np.random.RandomState(3)
    dense = (rng.rand(40, 80) < 0.3) * rng.randint(1, 6, (40, 80))
    train = sps.csr_matrix(dense.astype(np.float32))
    # topK near the catalog size so the per-column selection reaches down
    # into the negative similarities where the padded candidates compete
    base = compute_similarity(train, similarity="pearson", topK=79, shrink=0.0)
    assert (base.data < 0).any()  # the scenario is actually exercised
    plan = make_mesh(n_data=1, n_model=7)  # 80 cols -> 4 padded candidates
    got = compute_similarity(train, similarity="pearson", topK=79, shrink=0.0, mesh_plan=plan)
    _assert_same_sparse(got, base)


def test_itemknn_and_easer_fit_on_mesh(urm_pair):
    """End-to-end: ItemKNN-cosine and EASE-R fits accept mesh_plan and match
    the single-device models."""
    from ganmf_tpu.models import ItemKNNCFRecommender
    from ganmf_tpu.models.extras import EASE_R_Recommender

    train, test = urm_pair
    plan = make_mesh(n_data=1, n_model=8)

    base = ItemKNNCFRecommender(train)
    base.fit(topK=10, shrink=10.0, similarity="cosine")
    sharded = ItemKNNCFRecommender(train)
    sharded.fit(topK=10, shrink=10.0, similarity="cosine", mesh_plan=plan)
    _assert_same_sparse(sharded.W_sparse, base.W_sparse)

    be = EASE_R_Recommender(train)
    be.fit(topK=10, l2_norm=50.0)
    se = EASE_R_Recommender(train)
    se.fit(topK=10, l2_norm=50.0, mesh_plan=plan)
    np.testing.assert_allclose(
        se.W_sparse.toarray(), be.W_sparse.toarray(), rtol=1e-4, atol=1e-6
    )


def test_sharded_evaluator_with_diversity_matches_single(urm_pair):
    """The device diversity metric composes with a mesh plan (GSPMD handles
    the sharded gather/top-k) and equals the single-device result."""
    import scipy.sparse as sps

    from ganmf_tpu.eval import EvaluatorHoldout

    train, test = urm_pair
    rng = np.random.RandomState(4)
    M = sps.csr_matrix(rng.rand(train.shape[1], train.shape[1]).astype(np.float32))
    model = _RandomScorer(train)
    base, _ = EvaluatorHoldout(test, [5], diversity_object=M).evaluateRecommender(model)

    plan = make_mesh(n_data=4, n_model=2)
    sharded, _ = EvaluatorHoldout(
        test, [5], diversity_object=M, mesh_plan=plan
    ).evaluateRecommender(model)
    assert sharded[5]["DIVERSITY_SIMILARITY"] == pytest.approx(
        base[5]["DIVERSITY_SIMILARITY"], rel=1e-5
    )


def test_distributed_cholesky_and_solves():
    """ops/distchol: the column-distributed blocked Cholesky and the
    forward/backward substitutions reproduce the dense single-device
    factor/solve (no [n, n] buffer replicated)."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from ganmf_tpu.ops import distchol
    from ganmf_tpu.parallel.mesh import MODEL_AXIS

    plan = make_mesh(n_data=1, n_model=8)
    n, w = 64, 4  # W = 8 per shard, 2 panels per shard
    rng = np.random.RandomState(0)
    M = rng.randn(n, n).astype(np.float32)
    G = M @ M.T + n * np.eye(n, dtype=np.float32)
    R = rng.randn(n, 5).astype(np.float32)

    def local(Gfull, Rfull):
        me = jax.lax.axis_index(MODEL_AXIS)
        Gl = jax.lax.dynamic_slice(Gfull, (0, me * (n // 8)), (n, n // 8))
        Ll = distchol._cholesky_local(Gl, w=w, axis=MODEL_AXIS)
        Y = distchol._solve_lower_local(Ll, Rfull, w=w, axis=MODEL_AXIS)
        X = distchol._solve_upper_local(Ll, Y, w=w, axis=MODEL_AXIS)
        return Ll, X

    Ll, X = shard_map(
        local, mesh=plan.mesh,
        in_specs=(P(None, None), P(None, None)),
        out_specs=(P(None, MODEL_AXIS), P(None, None)),
        check_vma=False,
    )(jnp.asarray(G), jnp.asarray(R))

    L_ref = np.linalg.cholesky(G)
    np.testing.assert_allclose(np.asarray(Ll), L_ref, rtol=2e-4, atol=2e-4)
    X_ref = np.linalg.solve(G, R)
    np.testing.assert_allclose(np.asarray(X), X_ref, rtol=2e-3, atol=2e-4)


def test_easer_mesh_with_padding():
    """Catalog size that does not divide n_shards * panel exercises the
    padded rows/columns of the distributed EASE-R build (the lambda*I
    padding block must factor independently and never reach the top-K)."""
    import scipy.sparse as sps

    from ganmf_tpu.models.extras import EASE_R_Recommender

    rng = np.random.RandomState(11)
    train = sps.csr_matrix((rng.rand(40, 70) < 0.25).astype(np.float32))
    plan = make_mesh(n_data=1, n_model=8)  # 70 -> padded to 72

    be = EASE_R_Recommender(train)
    be.fit(topK=10, l2_norm=50.0)
    se = EASE_R_Recommender(train)
    se.fit(topK=10, l2_norm=50.0, mesh_plan=plan)
    np.testing.assert_allclose(
        se.W_sparse.toarray(), be.W_sparse.toarray(), rtol=1e-4, atol=1e-6
    )


def test_cfgan_csr_storage_composes_with_mesh(urm_pair):
    """CFGAN urm_storage='csr' + mesh_plan: the user-axis-sharded padded-CSR
    fit equals the dense single-device fit on an unmasked config (masked
    configs use a different per-user mask RNG stream by construction)."""
    from ganmf_tpu.models import CFGAN

    train, test = urm_pair
    plan = make_mesh(n_data=2, n_model=2)
    kwargs = dict(d_nodes=8, g_nodes=8, scheme="ZR", zr_ratio=0.0,
                  zr_coefficient=0.0, epochs=3, d_batch_size=16, g_batch_size=16,
                  allow_worse=None, freq=None)

    dense = CFGAN(train, mode="user", seed=11)
    dense.fit(**kwargs)
    streamed = CFGAN(train, mode="user", seed=11)
    streamed.fit(urm_storage="csr", mesh_plan=plan, **kwargs)

    for got, want in zip(
        jax.tree_util.tree_leaves(streamed.params), jax.tree_util.tree_leaves(dense.params)
    ):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=2e-4, atol=2e-6)
