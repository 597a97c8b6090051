"""``smallest_k_mask`` must match the stable rank-table selection bitwise,
including tied, negative and +inf keys and widths that are no multiple of
any tile."""

import jax
import jax.numpy as jnp

from ganmf_tpu.ops.topk import smallest_k_mask


def _rank_table(keys, k):
    return jnp.argsort(jnp.argsort(keys, axis=1), axis=1) < k[:, None]


def test_smallest_k_mask_matches_rank_table_with_ties():
    key = jax.random.PRNGKey(7)
    # low-resolution keys force many ties, some straddling the boundary
    keys = jnp.round(jax.random.uniform(key, (48, 97)) * 8.0)
    inter = jax.random.uniform(jax.random.PRNGKey(8), (48, 97)) < 0.3
    keys = jnp.where(inter, jnp.inf, keys)
    for ratio in (0.0, 0.3, 1.0):
        k = (jnp.sum(~inter, axis=1) * ratio).astype(jnp.int32)
        ref = _rank_table(keys, k)
        got = smallest_k_mask(keys, k)
        assert bool(jnp.all(ref == got)), f"mismatch at ratio={ratio}"


def test_smallest_k_mask_negative_keys_and_odd_shape():
    # negative keys exercise the sign branch of the monotone bitcast; 5 rows
    # by 97 columns is no multiple of any block
    keys = -jnp.abs(jax.random.normal(jax.random.PRNGKey(9), (5, 97)))
    inter = jax.random.uniform(jax.random.PRNGKey(10), (5, 97)) < 0.2
    keys = jnp.where(inter, jnp.inf, keys)
    k = (jnp.sum(~inter, axis=1) * 0.4).astype(jnp.int32)
    ref = _rank_table(keys, k)
    got = smallest_k_mask(keys, k)
    assert bool(jnp.all(ref == got))
    assert bool(jnp.all(jnp.sum(got, axis=1) == k))
