"""Aux subsystem tests: logging, checkpointing, significance, analysis."""

import json
import os

import jax
import numpy as np
import pytest

from ganmf_tpu.eval.significance import KFoldResultRepository, compute_k_fold_significance
from ganmf_tpu.utils.analysis import cosine_sim, describe_urm, gini
from ganmf_tpu.utils.checkpoint import TrainCheckpointer
from ganmf_tpu.utils.logging import MetricsLogger, read_jsonl
from ganmf_tpu.utils.timing import seconds_to_biggest_unit
from tests.conftest import random_urm


def test_metrics_logger_jsonl(tmp_path):
    path = str(tmp_path / "run.jsonl")
    logger = MetricsLogger(path, run_name="test")
    logger.log_epoch(1, d_loss=0.5, g_loss=0.2)
    logger.log_eval(1, {5: {"MAP": 0.1, "NDCG": 0.2}})
    records = read_jsonl(path)
    assert records[0]["event"] == "epoch" and records[0]["d_loss"] == 0.5
    assert records[1]["MAP@5"] == 0.1


def test_train_checkpointer_roundtrip(tmp_path):
    import jax.numpy as jnp

    ckpt = TrainCheckpointer(str(tmp_path / "ckpt"), every_n_epochs=2)
    state = {"w": jnp.arange(6.0).reshape(2, 3), "step": jnp.asarray(3)}
    assert not ckpt.maybe_save(1, state)
    assert ckpt.maybe_save(2, state)
    assert ckpt.latest_epoch() == 2
    restored = ckpt.restore(2, state)
    np.testing.assert_allclose(np.asarray(restored["w"]), np.asarray(state["w"]))


def test_significance_tests():
    rng = np.random.RandomState(0)
    repo_a, repo_b = KFoldResultRepository(10), KFoldResultRepository(10)
    for f in range(10):
        repo_a.set_results_in_fold(f, {"MAP": 0.30 + rng.randn() * 0.001, "NDCG": 0.5})
        repo_b.set_results_in_fold(f, {"MAP": 0.20 + rng.randn() * 0.001, "NDCG": 0.5})
    res = repo_a.run_significance_test(repo_b, metrics=["MAP"])
    assert res["MAP"]["significant"]
    assert res["MAP"]["mean_diff"] == pytest.approx(0.1, abs=0.01)

    allpairs = compute_k_fold_significance([repo_a, repo_b], metrics=["MAP"])
    assert (0, 1) in allpairs


def test_gini_and_describe():
    uniform = np.ones(100)
    assert gini(uniform) == pytest.approx(0.0, abs=1e-3)
    skewed = np.zeros(100)
    skewed[0] = 100
    assert gini(skewed) > 0.9

    urm = random_urm(30, 20, 0.2)
    stats = describe_urm(urm, "synth")
    assert stats["n_users"] == 30 and stats["interactions"] == urm.nnz


def test_cosine_sim_diag():
    m = np.random.RandomState(0).rand(5, 8)
    sim = cosine_sim(m)
    np.testing.assert_allclose(np.diag(sim), 1.0, atol=1e-6)


def test_seconds_to_biggest_unit():
    assert seconds_to_biggest_unit(30) == (30, "sec")
    v, u = seconds_to_biggest_unit(90)
    assert u == "min" and v == pytest.approx(1.5)
    v, u = seconds_to_biggest_unit(7200)
    assert u == "hour" and v == pytest.approx(2.0)


def test_gan_logger_and_checkpoint_hooks(tmp_path, urm_pair):
    from ganmf_tpu.models import GANMF

    train, _ = urm_pair
    model = GANMF(train, seed=0)
    model.metrics_logger = MetricsLogger(str(tmp_path / "m.jsonl"))
    model.checkpointer = TrainCheckpointer(str(tmp_path / "ck"), every_n_epochs=2)
    model.fit(num_factors=4, emb_dim=8, epochs=4, batch_size=16)
    records = read_jsonl(str(tmp_path / "m.jsonl"))
    assert sum(r["event"] == "epoch" for r in records) == 4
    assert model.checkpointer.latest_epoch() == 4


def test_ganmf_crash_resume(tmp_path, urm_pair):
    """Interrupted fit resumes from the checkpointed epoch with identical
    final state to an uninterrupted run of the same schedule."""
    import jax
    from ganmf_tpu.models import GANMF

    train, _ = urm_pair
    kwargs = dict(num_factors=4, emb_dim=8, epochs=6, batch_size=16)

    full = GANMF(train, seed=3)
    full.fit(**kwargs)

    # run 1: checkpoint every 2 epochs, stop after epoch 4 via exception
    m = GANMF(train, seed=3)
    m.checkpointer = TrainCheckpointer(str(tmp_path / "ck"), every_n_epochs=2)
    orig_loop = m._run_training_loop

    def cut_short(*args, **kw):
        epoch_fn = args[8]

        def wrapped(epoch):
            if epoch > 4:
                raise KeyboardInterrupt
            epoch_fn(epoch)

        return orig_loop(*args[:8], wrapped, **kw)

    m._run_training_loop = cut_short
    with pytest.raises(KeyboardInterrupt):
        m.fit(**kwargs)
    assert m.checkpointer.latest_epoch() == 4

    # run 2: fresh model resumes from epoch 5
    m2 = GANMF(train, seed=3)
    m2.checkpointer = TrainCheckpointer(str(tmp_path / "ck"), every_n_epochs=2)
    m2.fit(**kwargs)
    assert np.isfinite(np.asarray(m2.params.user_emb)).all()
    # resumed run trains epochs 5..6 only; shapes and scoring work
    scores = m2._compute_item_score(np.arange(3))
    assert np.isfinite(scores).all()
    # the shuffle stream is fast-forwarded on resume, so the resumed run
    # reproduces the uninterrupted run's final state (ADVICE r1)
    np.testing.assert_allclose(
        np.asarray(m2.params.user_emb), np.asarray(full.params.user_emb), rtol=1e-6, atol=1e-7
    )
    # loss histories carry over: 4 restored epochs + 2 new ones
    assert len(m2.train_d_loss) == 6 and len(m2.train_g_loss) == 6
    np.testing.assert_allclose(
        [float(v) for v in m2.train_d_loss],
        [float(v) for v in full.train_d_loss],
        rtol=1e-5,
    )


def test_similarity_matrix_topk_keeps_negatives():
    """Top-K selection runs over stored nonzeros only: negative weights are
    kept and explicit/implicit zeros never outrank them (ADVICE r1 medium;
    reference Recommender_utils.py non_zero_data filter)."""
    import scipy.sparse as sps

    from ganmf_tpu.models.base import similarity_matrix_topk

    col = np.zeros((6, 6), dtype=np.float32)
    col[0, 0], col[1, 0], col[2, 0] = 1.0, -0.5, -0.8
    for W in (col, sps.csc_matrix(col)):
        out = similarity_matrix_topk(W, k=5).toarray()
        np.testing.assert_allclose(out[:3, 0], [1.0, -0.5, -0.8])
        assert out[3:, 0].sum() == 0.0

    # large-sparse padded path (forced by a big n with tiny nnz)
    n = 9000
    big = sps.lil_matrix((n, n), dtype=np.float32)
    big[0, 0], big[1, 0], big[2, 0] = 1.0, -0.5, -0.8
    out = similarity_matrix_topk(sps.csc_matrix(big), k=5).tocsc()
    np.testing.assert_allclose(out[:3, 0].toarray().ravel(), [1.0, -0.5, -0.8])

    # k smaller than the nonzero count: keep the k largest by value
    out = similarity_matrix_topk(col, k=2).toarray()
    np.testing.assert_allclose(sorted(out[:3, 0]), [-0.5, 0.0, 1.0])


def test_slim_zero_non_topk_keeps_negatives():
    from ganmf_tpu.models.slim_bpr import SLIM_BPR

    A = np.zeros((4, 4), dtype=np.float32)
    A[0, :3] = [1.0, -0.5, -0.8]
    out = SLIM_BPR._zero_non_topk(A, k=3, axis=1)
    np.testing.assert_allclose(out[0, :3], [1.0, -0.5, -0.8])
    out2 = SLIM_BPR._zero_non_topk(A, k=2, axis=1)
    np.testing.assert_allclose(out2[0, :3], [1.0, -0.5, 0.0])


def test_debug_mode_surfaces_nan(urm_pair, monkeypatch):
    """GANMF_TPU_DEBUG=1 recompiles the epoch programs under checkify: a NaN
    born inside the jitted epoch raises instead of silently propagating
    (SURVEY §5.2 rebuild note)."""
    import jax.numpy as jnp

    from ganmf_tpu.models import GANMF

    train, _ = urm_pair
    kwargs = dict(num_factors=4, emb_dim=8, epochs=1, batch_size=16)

    # poisoned learning rate drives params to NaN inside the scan
    monkeypatch.delenv("GANMF_TPU_DEBUG", raising=False)
    m = GANMF(train, seed=3)
    m.fit(d_lr=float("nan"), **kwargs)  # silent propagation without debug
    assert not np.isfinite(np.asarray(m.params.enc_w)).all()

    monkeypatch.setenv("GANMF_TPU_DEBUG", "1")
    m2 = GANMF(train, seed=3)
    with pytest.raises(Exception) as exc_info:
        m2.fit(d_lr=float("nan"), **kwargs)
    assert "nan" in str(exc_info.value).lower()

    # healthy training passes the checks
    m3 = GANMF(train, seed=3)
    m3.fit(**kwargs)
    assert np.isfinite(np.asarray(m3.params.user_emb)).all()


@pytest.mark.parametrize("model_name", ["DisGANMF", "CFGAN", "CAAE"])
def test_gan_crash_resume_all_trainers(tmp_path, urm_pair, model_name):
    """DisGANMF/CFGAN/CAAE resume from a mid-run checkpoint and reproduce the
    uninterrupted run's final state (GANMF covered above)."""
    from ganmf_tpu.models import CAAE, CFGAN, DisGANMF

    train, _ = urm_pair
    if model_name == "DisGANMF":
        cls, kwargs = DisGANMF, dict(num_factors=4, d_nodes=8, epochs=6, batch_size=16)
    elif model_name == "CFGAN":
        cls, kwargs = CFGAN, dict(
            d_nodes=8, g_nodes=8, scheme="ZR", zr_ratio=0.3, zr_coefficient=0.1,
            d_batch_size=16, g_batch_size=16, epochs=6,
        )
    else:
        cls, kwargs = CAAE, dict(
            num_factors=4, g_units=8, d_bsize=64, m_batch=8, epochs=6,
        )

    full = cls(train, seed=3)
    full.fit(**kwargs)

    m = cls(train, seed=3)
    m.checkpointer = TrainCheckpointer(str(tmp_path / "ck"), every_n_epochs=2)
    orig_loop = m._run_training_loop

    def cut_short(*args, **kw):
        epoch_fn = args[8]

        def wrapped(epoch):
            if epoch > 4:
                raise KeyboardInterrupt
            epoch_fn(epoch)

        return orig_loop(*args[:8], wrapped, **kw)

    m._run_training_loop = cut_short
    with pytest.raises(KeyboardInterrupt):
        m.fit(**kwargs)
    assert m.checkpointer.latest_epoch() == 4

    m2 = cls(train, seed=3)
    m2.checkpointer = TrainCheckpointer(str(tmp_path / "ck"), every_n_epochs=2)
    m2.fit(**kwargs)

    for got, want in zip(
        jax.tree_util.tree_leaves(m2.params), jax.tree_util.tree_leaves(full.params)
    ):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("model_name", ["IALS", "SLIM_BPR", "MF_BPR"])
def test_baseline_crash_resume(tmp_path, urm_pair, model_name):
    """The early-stopping baselines resume training state from a checkpoint
    and reproduce the uninterrupted run."""
    from ganmf_tpu.models import IALSRecommender, SLIM_BPR
    from ganmf_tpu.models.mf_sgd import MatrixFactorization_BPR

    train, _ = urm_pair
    if model_name == "IALS":
        cls, kwargs = IALSRecommender, dict(num_factors=4, alpha=5.0, epochs=6)
        leaves = lambda m: [np.asarray(m._U_dev), np.asarray(m._V_dev)]
    elif model_name == "SLIM_BPR":
        cls, kwargs = SLIM_BPR, dict(topK=5, learning_rate=0.05, epochs=6)
        leaves = lambda m: [np.asarray(m._state.W)]
    else:
        cls, kwargs = MatrixFactorization_BPR, dict(
            num_factors=4, learning_rate=0.05, batch_size=32, epochs=6
        )
        leaves = lambda m: [np.asarray(m._state.U), np.asarray(m._state.V)]

    full = cls(train)
    full.fit(**kwargs)

    m = cls(train)
    m.checkpointer = TrainCheckpointer(str(tmp_path / "ck"), every_n_epochs=2)
    orig = m._run_epoch

    def cut_short(num_epoch):
        if num_epoch >= 4:
            raise KeyboardInterrupt
        orig(num_epoch)

    m._run_epoch = cut_short
    with pytest.raises(KeyboardInterrupt):
        m.fit(**kwargs)
    assert m.checkpointer.latest_epoch() == 4

    m2 = cls(train)
    m2.checkpointer = TrainCheckpointer(str(tmp_path / "ck"), every_n_epochs=2)
    m2.fit(**kwargs)
    for got, want in zip(leaves(m2), leaves(full)):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_slim_device_prune_matches_host():
    """_prune_topk_device == the host _get_w_sparse double prune (same
    nonzero-filtered, negative-keeping selection semantics)."""
    import jax.numpy as jnp
    import scipy.sparse as sps
    from ganmf_tpu.models.slim_bpr import SLIM_BPR, _prune_topk_device

    rng = np.random.RandomState(5)
    n = 40
    W = rng.randn(n, n).astype(np.float32)
    W[rng.rand(n, n) < 0.6] = 0.0  # sparse-ish with negatives

    urm = sps.csr_matrix((rng.rand(12, n) < 0.3).astype(np.float32))
    m = SLIM_BPR(urm)
    m.topK, m.symmetric = 7, True

    want = m._get_w_sparse(W.copy())
    S2, cv, cix = _prune_topk_device(jnp.asarray(W), 7, True)
    got = m._w_sparse_from_topk(cv, cix)
    np.testing.assert_allclose(got.toarray(), want.toarray(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(S2), want.toarray(), rtol=1e-6, atol=1e-7)


def test_similarity_matrix_topk_device_branch_matches_host():
    """_device_column_topk (the large-sparse device branch) equals the
    host padded-argpartition path on untied data."""
    import scipy.sparse as sps
    from ganmf_tpu.models import base as base_mod

    rng = np.random.RandomState(9)
    n = 50
    W = rng.randn(n, n).astype(np.float32)
    W[rng.rand(n, n) < 0.5] = 0.0
    Wsp = sps.csc_matrix(W)

    want = base_mod.similarity_matrix_topk(Wsp.copy(), k=7).toarray()
    got = base_mod._device_column_topk(Wsp, 7).toarray()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_perf_report_plausibility_guard():
    """The perf harness must flag timings that imply running above the
    card's published peak (a measurement fault), and must refuse a card
    missing from its peak table rather than assume one."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "perf_report", os.path.join(os.path.dirname(__file__), "..", "scripts", "perf_report.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    with pytest.raises(KeyError, match="no published peaks"):
        mod.peaks()  # the CPU test device has no entry
    mod.peaks = lambda: mod.PEAKS["NVIDIA H100 80GB HBM3"]

    name = "GANMF[1M] steady epoch (K=250, b=64, bf16)"
    assert not mod.plausible(name, 0.00198)  # ~576 TFLOP/s > the 495 TFLOP/s TF32 peak
    assert mod.plausible(name, 0.0199)
    # bandwidth-bound rows are checked against the device-memory peak
    assert not mod.plausible("CAAE[1M] steady epoch", 1e-5)
    assert mod.plausible("CAAE[1M] steady epoch", 0.22)
    # unknown rows pass through
    assert mod.plausible("some-new-bench", 1e-9)


def test_smallest_k_mask_matches_rank_table():
    """smallest_k_mask must be BITWISE identical to the rank-table
    construction it replaced (argsort-of-argsort < k), including on tied
    keys — the CFGAN/CAAE parity rows were validated against the rank
    table's exact selection."""
    import jax
    import jax.numpy as jnp

    from ganmf_tpu.ops.topk import smallest_k_mask

    key = jax.random.PRNGKey(7)
    # low-resolution keys force many ties, some straddling the boundary
    keys = jnp.round(jax.random.uniform(key, (64, 97)) * 8.0)
    inter = jax.random.uniform(jax.random.PRNGKey(8), (64, 97)) < 0.3
    keys = jnp.where(inter, jnp.inf, keys)
    for ratio in (0.0, 0.3, 1.0):
        k = (jnp.sum(~inter, axis=1) * ratio).astype(jnp.int32)
        ref = jnp.argsort(jnp.argsort(keys, axis=1), axis=1) < k[:, None]
        got = smallest_k_mask(keys, k)
        assert bool(jnp.all(ref == got)), f"mismatch at ratio={ratio}"
    # exact-k property on untied rows
    k = (jnp.sum(~inter, axis=1) * 0.5).astype(jnp.int32)
    untied = jnp.where(inter, jnp.inf, jax.random.uniform(key, (64, 97)))
    got = smallest_k_mask(untied, k)
    assert bool(jnp.all(jnp.sum(got, axis=1) == k))


def test_scatter_col_topk_dense():
    """Dense device export of per-column top-K candidates matches the host
    CSC assembly cell for cell, including negative values and dropped
    exact zeros."""
    import jax.numpy as jnp

    from ganmf_tpu.ops.topk import scatter_col_topk_dense, tiled_topk

    rng = np.random.RandomState(3)
    W = rng.randn(37, 37).astype(np.float32)
    W[rng.rand(37, 37) < 0.4] = 0.0
    vals, idx = tiled_topk(jnp.asarray(W.T), 5)  # per column: top rows
    dense = np.asarray(scatter_col_topk_dense(vals, idx))

    expected = np.zeros_like(W)
    v, ix = np.asarray(vals), np.asarray(idx)
    for j in range(37):
        expected[ix[j], j] = v[j]
    np.testing.assert_array_equal(dense, expected)
