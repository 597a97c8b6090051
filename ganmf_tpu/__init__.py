"""ganmf-tpu: a JAX/XLA recommender-systems framework.

A from-scratch rebuild of the capabilities of the GANMF research framework
(SAC'22, "GAN-based Matrix Factorization for Recommender Systems"): four
adversarial collaborative-filtering recommenders (GANMF, DisGANMF, CFGAN,
CAAE), the classical baselines (TopPop, PureSVD, IALS, SLIM-BPR, ItemKNN,
P3alpha, ...), a holdout top-K ranking evaluator with ~20 metrics, a dataset
pipeline (ingest / reindex / k-core / per-user split), a Bayesian
hyperparameter search harness, and artifact-compatible experiment CLIs.

Design principles (accelerator-first, not a port):
  * The user-item matrix lives dense in device memory; training epochs are
    single jitted ``lax.scan`` programs (no per-step host round trips).
  * Scoring and evaluation are vectorized device programs built around
    ``lax.top_k``; metrics are computed on device and reduced once.
  * Multi-device scaling goes through ``jax.sharding.Mesh`` + collectives
    (see :mod:`ganmf_tpu.parallel`), never through host-side loops.
"""

__version__ = "0.1.0"

import os as _os


def compilation_cache_dir():
    """Where the persistent compilation cache lives: $JAX_COMPILATION_CACHE_DIR
    when it is set (the empty string disables the cache: None), otherwise
    the fixed ``.jax_cache`` directory of the checkout that holds this
    package. The path is part of the cache key, so it never depends on a
    temporary name, a pid or the time."""
    cache_dir = _os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if cache_dir is not None:
        return cache_dir or None
    checkout = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
    return _os.path.join(checkout, ".jax_cache")


def _enable_compilation_cache() -> None:
    """Point JAX at the persistent on-disk compilation cache.

    The reference use-case is 50-trial x 54-config hyperparameter sweeps
    (reference RecSysExp.py:417, get_best_params.sh) where each trial is a
    fresh process: without a persistent cache every process re-pays the
    XLA compile of every program it runs.
    """
    cache_dir = compilation_cache_dir()
    if cache_dir is None:
        return  # explicit opt-out
    import jax

    jax.config.update("jax_compilation_cache_dir", cache_dir)
    # Cache every compilation that takes measurable time; the default
    # 1 s floor skips most of the small per-model programs whose
    # aggregate compile cost dominates harness wall time.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


_enable_compilation_cache()

from ganmf_tpu.utils.seeding import set_seed  # noqa: F401
