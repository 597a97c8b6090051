"""The program runs on any JAX backend it is given: no TPU-only code, no
scikit-learn on the model/eval/run path, a compile cache inside the
checkout, and a chip smoke run whose phases work at tiny sizes here."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sps

REPO = Path(__file__).resolve().parents[1]


def _env(**extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    env.update(extra)
    return env


@pytest.mark.parametrize("value", [None, "/some/cache", ""])
def test_compilation_cache_dir(monkeypatch, value):
    import ganmf_tpu

    if value is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert ganmf_tpu.compilation_cache_dir() == str(REPO / ".jax_cache")
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", value)
        assert ganmf_tpu.compilation_cache_dir() == (value or None)


def test_jax_cache_is_gitignored():
    lines = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in lines


def _sources():
    files = [REPO / "bench.py", REPO / "chip_smoke.py"]
    for d in ("ganmf_tpu", "scripts"):
        files += sorted((REPO / d).rglob("*.py"))
    return files


_TPU_ONLY = [
    re.compile(r"pallas\.tpu|pltpu"),
    re.compile(r"\binterpret\s*="),
    re.compile(r"""["']tpu["']"""),
]


def test_no_tpu_only_code():
    hits = []
    for f in _sources():
        for n, line in enumerate(f.read_text().splitlines(), 1):
            if any(p.search(line) for p in _TPU_ONLY):
                hits.append(f"{f.relative_to(REPO)}:{n}: {line.strip()}")
    assert not hits, "\n".join(hits)


_BLOCK_SKLEARN = """
import sys
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name == "sklearn" or name.startswith("sklearn."):
            raise ImportError("scikit-learn is blocked: " + name)
sys.meta_path.insert(0, _Block())
import {module}
assert not any(m.split(".")[0] == "sklearn" for m in sys.modules)
"""


@pytest.mark.parametrize("module", ["ganmf_tpu.models", "ganmf_tpu.eval", "ganmf_tpu.cli.run_best"])
def test_imports_without_sklearn(module):
    proc = subprocess.run([sys.executable, "-c", _BLOCK_SKLEARN.format(module=module)],
                          env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]


def test_p3alpha_l1_normalize_rows_matches_numpy():
    from ganmf_tpu.models.p3alpha import l1_normalize_rows

    rng = np.random.RandomState(4)
    dense = (rng.rand(30, 20) < 0.3) * rng.randn(30, 20)
    dense[5] = 0.0  # an empty row stays empty
    X = sps.csr_matrix(dense.astype(np.float32))
    got = l1_normalize_rows(X)
    d64 = X.toarray().astype(np.float64)
    norms = np.abs(d64).sum(axis=1, keepdims=True)
    ref = (d64 / np.where(norms == 0, 1.0, norms)).astype(np.float32)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.toarray(), ref)
    assert X.toarray()[0].any() and X is not got  # input left untouched


# -- chip_smoke phases at tiny sizes -------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, str(REPO))
    import chip_smoke

    return chip_smoke


@pytest.fixture(scope="module")
def tiny_split(smoke):
    return smoke.ml1m_standin(n_users=48, n_items=64, density=0.25, seed=0)


TINY_GANMF = dict(num_factors=4, emb_dim=8, batch_size=16, m=10, d_lr=1e-4,
                  g_lr=1.65e-4, d_reg=1e-4, recon_coefficient=0.01)


def test_chip_smoke_ganmf_phase(smoke, tiny_split):
    train, test = tiny_split
    out = smoke.phase_ganmf(train, test, params=TINY_GANMF, epochs=2)
    assert len(out["epoch_s"]) == 2 and out["steady_epoch_s"] > 0
    assert 0.0 <= out["MAP@20"] <= 1.0
    assert out["epoch_memory"]["argument_size_in_bytes"] > 0


def test_chip_smoke_step_phase(smoke, tiny_split):
    import jax

    cpu = jax.devices("cpu")[0]
    out = smoke.phase_ganmf_step(tiny_split[0], cpu, cpu, params=TINY_GANMF)
    for name in ("highest", "default"):
        assert max(out[name]["max_rel_err"].values()) == 0.0


def test_chip_smoke_puresvd_phase(smoke, tiny_split):
    import jax

    cpu = jax.devices("cpu")[0]
    train, test = tiny_split
    out = smoke.phase_puresvd(train, test, cpu, cpu, num_factors=6, n_serve=16, timed_passes=1)
    assert out["metric_gap_fused_vs_plain"] <= 1e-5
    assert out["ranked_positions_differing_gpu_vs_cpu"] == 0
    assert out["fused_block_shape"][1] == train.shape[1]


def test_chip_smoke_mask_phase(smoke, tiny_split):
    out = smoke.phase_masks(tiny_split[0], stream_shape=(8, 256))
    assert out["mask_shape"] == list(tiny_split[0].shape)
    assert out["draw_share_of_epoch"] > 0


def test_chip_smoke_ranking_gap_tolerates_only_ties(smoke):
    s = np.array([[3.0, 2.0, 2.0, 1.0]])
    assert smoke._ranking_gap([[0, 1, 2]], [[0, 2, 1]], s) == (2, 0.0)
    with pytest.raises(smoke.CheckFailed):
        smoke._ranking_gap([[0, 1]], [[0, 3]], s)


def test_chip_smoke_refuses_cpu():
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], env=_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "needs an NVIDIA GPU" in proc.stderr


# -- trace reduction ------------------------------------------------------------

def test_busy_ns_unions_intervals():
    from ganmf_tpu.utils.profiling import busy_ns

    assert busy_ns([]) == 0
    assert busy_ns([(0, 10), (5, 10), (30, 5), (31, 1)]) == 20
    assert busy_ns([(30, 5), (0, 40)]) == 40


def test_trace_breakdown_reads_a_trace(tmp_path):
    import glob

    import jax
    import jax.numpy as jnp

    from ganmf_tpu.utils.profiling import trace_breakdown

    with jax.profiler.trace(str(tmp_path)):
        x = jnp.ones((64, 64))
        jax.block_until_ready(x @ x)
    path = glob.glob(str(tmp_path / "**" / "*.xplane.pb"), recursive=True)[0]
    lines = trace_breakdown(path, plane_prefix="/host:")
    assert lines
    for v in lines.values():
        assert 0 <= v["busy_ns"] <= v["span_ns"] and v["events"] >= 1
    assert trace_breakdown(path, plane_prefix="/device:GPU") == {}
