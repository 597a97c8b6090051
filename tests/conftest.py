import os

# Tests run on a virtual 8-device CPU mesh: multi-device sharding code
# paths are exercised without an accelerator. jax may already be imported
# with another platform chosen, so the env var alone can be too late —
# override through jax.config before any backend initializes.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest
import scipy.sparse as sps


def random_urm(n_users=40, n_items=60, density=0.2, seed=7, implicit=True):
    rng = np.random.RandomState(seed)
    mat = (rng.rand(n_users, n_items) < density).astype(np.float32)
    if not implicit:
        mat *= rng.randint(1, 6, size=mat.shape).astype(np.float32)
    return sps.csr_matrix(mat)


@pytest.fixture
def urm_pair():
    """Train/test split of a random URM with every user warm in both."""
    rng = np.random.RandomState(3)
    n_users, n_items = 50, 80
    full = (rng.rand(n_users, n_items) < 0.25).astype(np.float32)
    # ensure every user has >= 4 interactions
    for u in range(n_users):
        while full[u].sum() < 4:
            full[u, rng.randint(n_items)] = 1.0
    test_mask = np.zeros_like(full)
    for u in range(n_users):
        items = np.where(full[u] > 0)[0]
        picked = rng.choice(items, size=max(1, len(items) // 5), replace=False)
        test_mask[u, picked] = 1.0
    train = full * (1 - test_mask)
    test = full * test_mask
    return sps.csr_matrix(train), sps.csr_matrix(test)
