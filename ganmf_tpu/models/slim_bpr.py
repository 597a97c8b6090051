"""SLIM-BPR: item-item similarity learned with BPR sampling.

The reference trains one sample at a time in Cython over pointer-chasing
sparse structures (SLIM_BPR/Cython/SLIM_BPR_Cython_Epoch.pyx:198-370,
custom Sparse_Matrix_Tree_CSR / Triangular_Matrix storage). Device redesign:
the item-item W lives dense in device memory, each epoch draws n_users (u, i+, j-)
triples on device and processes them in vectorized chunks under one jitted
lax.scan — gathers of W rows, a masked row-dot for x_uij, sigmoid gradient,
AdaGrad/RMSprop/Adam per-item caches and scatter-add row updates (mirrored
to columns for the symmetric variant, reproducing the reference's shared
triangular cells). Chunked batching introduces bounded gradient staleness
within a chunk; sampling distributions match the reference.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sps

from ganmf_tpu.models.base import ItemSimilarityRecommender, check_matrix, similarity_matrix_topk
from ganmf_tpu.models.early_stopping import IncrementalTrainingEarlyStopping


class _OptState(NamedTuple):
    W: jnp.ndarray  # [I, I]
    cache: jnp.ndarray  # adagrad/rmsprop second-moment per item [I]
    m1: jnp.ndarray  # adam first moment per item [I]
    m2: jnp.ndarray  # adam second moment per item [I]
    beta1_t: jnp.ndarray  # adam bias-correction powers (scalars)
    beta2_t: jnp.ndarray


def _draw_triples(urm, warm_users, profile_pad, profile_len, key, shape):
    """(u, i+, j-) BPR samples of the given leading shape, all drawn from
    the epoch-constant tables in one vectorized pass."""
    n_items = urm.shape[1]
    k_u, k_p, k_n = jax.random.split(key, 3)
    u = jnp.take(warm_users, jax.random.randint(k_u, shape, 0, warm_users.shape[0]))
    lens = jnp.take(profile_len, u)
    pos_slot = jax.random.randint(k_p, shape, 0, jnp.iinfo(jnp.int32).max) % lens
    i = profile_pad[u, pos_slot]
    # negative sampling: draw 8 uniform candidates, take the first unseen
    cand = jax.random.randint(k_n, shape + (8,), 0, n_items)
    seen = urm[u[..., None], cand] != 0
    first_ok = jnp.argmax(jnp.where(seen, 0, 1), axis=-1)  # 0 if all seen
    j = jnp.take_along_axis(cand, first_ok[..., None], axis=-1)[..., 0]
    return u, i, j


@functools.partial(
    jax.jit,
    static_argnames=("n_chunks", "chunk", "sgd_mode", "symmetric", "presample"),
)
def _bpr_epoch(
    state: _OptState,
    urm: jnp.ndarray,  # [U, I] dense 0/1 mask
    warm_users: jnp.ndarray,  # [W] user ids with 1 <= profile < I
    profile_pad: jnp.ndarray,  # [U, Lmax] item ids padded with 0
    profile_len: jnp.ndarray,  # [U]
    key,
    learning_rate: float,
    li_reg: float,
    lj_reg: float,
    gamma: float,
    beta_1: float,
    beta_2: float,
    n_chunks: int,
    chunk: int,
    sgd_mode: str,
    symmetric: bool,
    presample: bool = False,
):
    n_items = urm.shape[1]

    def body(state: _OptState, xs):
        if presample:
            u, i, j = xs
        else:
            u, i, j = _draw_triples(urm, warm_users, profile_pad, profile_len, xs, (chunk,))

        P = jnp.take(urm, u, axis=0)  # [C, I] seen mask
        if symmetric:
            # the reference's triangular storage receives only row-oriented
            # writes; the shared cell {a, b} therefore reads as
            # W[a, b] + W[b, a] (SLIM_BPR_Cython_Epoch.pyx:1234+).
            # Column selection is a one-hot matmul W @ S, which streams W
            # once instead of gathering columns through a transpose of W,
            # and is bitwise-exact under HIGHEST precision (each output
            # sums exactly one x*1.0 product; max |diff| = 0.0 against
            # the gather).
            ij = jnp.concatenate([i, j])
            S = (ij[None, :] == jax.lax.broadcasted_iota(jnp.int32, (state.W.shape[0], 1), 0)).astype(state.W.dtype)
            cols = jnp.dot(state.W, S, precision=jax.lax.Precision.HIGHEST).T  # [2C, I]
            Wi = jnp.take(state.W, i, axis=0) + cols[: i.shape[0]]
            Wj = jnp.take(state.W, j, axis=0) + cols[i.shape[0]:]
        else:
            Wi = jnp.take(state.W, i, axis=0)
            Wj = jnp.take(state.W, j, axis=0)
        x_uij = jnp.sum((Wi - Wj) * P, axis=1)
        g = 1.0 / (1.0 + jnp.exp(x_uij))  # [C]

        if sgd_mode == "adagrad":
            cache = state.cache.at[i].add(g**2).at[j].add(g**2)
            g_upd = g / (jnp.sqrt(jnp.take(cache, i)) + 1e-8)
            new_cache, m1, m2, b1t, b2t = cache, state.m1, state.m2, state.beta1_t, state.beta2_t
        elif sgd_mode == "rmsprop":
            cache = state.cache * 1.0  # decay applied only at touched items, as in the reference
            cache = cache.at[i].set(jnp.take(cache, i) * gamma + (1 - gamma) * g**2)
            cache = cache.at[j].set(jnp.take(cache, j) * gamma + (1 - gamma) * g**2)
            g_upd = g / (jnp.sqrt(jnp.take(cache, i)) + 1e-8)
            new_cache, m1, m2, b1t, b2t = cache, state.m1, state.m2, state.beta1_t, state.beta2_t
        elif sgd_mode == "adam":
            m1 = state.m1.at[i].set(jnp.take(state.m1, i) * beta_1 + (1 - beta_1) * g)
            m2 = state.m2.at[i].set(jnp.take(state.m2, i) * beta_2 + (1 - beta_2) * g**2)
            m1 = m1.at[j].set(jnp.take(m1, j) * beta_1 + (1 - beta_1) * g)
            m2 = m2.at[j].set(jnp.take(m2, j) * beta_2 + (1 - beta_2) * g**2)
            mom1 = jnp.take(m1, i) / (1 - state.beta1_t)
            mom2 = jnp.take(m2, i) / (1 - state.beta2_t)
            g_upd = mom1 / (jnp.sqrt(mom2) + 1e-8)
            new_cache = state.cache
            b1t = state.beta1_t * beta_1**chunk
            b2t = state.beta2_t * beta_2**chunk
        else:  # plain sgd
            g_upd = g
            new_cache, m1, m2, b1t, b2t = state.cache, state.m1, state.m2, state.beta1_t, state.beta2_t

        # updates over the user's seen items, skipping the updated row's item;
        # all writes are row-oriented (symmetric reads handle the mirroring)
        not_i = P * (1 - jax.nn.one_hot(i, n_items, dtype=P.dtype))
        not_j = P * (1 - jax.nn.one_hot(j, n_items, dtype=P.dtype))
        delta_i = learning_rate * (g_upd[:, None] - li_reg * Wi) * not_i
        delta_j = -learning_rate * (g_upd[:, None] - lj_reg * Wj) * not_j

        W = state.W.at[i].add(delta_i).at[j].add(delta_j)
        return _OptState(W, new_cache, m1, m2, b1t, b2t), None

    if presample:
        # the sampling tables are epoch-constant, so ALL (u, i+, j-)
        # triples are drawn in one vectorized pass outside the serialized
        # scan (the transform that sped up CAAE's D phase)
        xs = _draw_triples(
            urm, warm_users, profile_pad, profile_len, key, (n_chunks, chunk)
        )
    else:
        xs = jax.random.split(key, n_chunks)
    state, _ = jax.lax.scan(body, state, xs)
    return state


@functools.partial(jax.jit, static_argnames=("k", "symmetric"))
def _prune_topk_device(W: jnp.ndarray, k: int, symmetric: bool):
    """The reference's double top-K prune (row-wise in get_S, column-wise in
    the wrapper) computed on device. Exact zeros are excluded with -inf
    sentinels so negative weights survive (Recommender_utils.py:98-104).
    Returns the pruned dense matrix (for device scoring) plus per-column
    [I, k] candidates so the host CSR costs an [I, k] transfer instead of
    pulling the full [I, I] matrix (~1.2 GB at LastFM scale)."""
    from ganmf_tpu.ops.topk import tiled_topk

    n = W.shape[0]
    S = W + W.T if symmetric else W
    S = jnp.where(jnp.eye(n, dtype=bool), 0.0, S)
    k = min(k, n)
    rows = jnp.arange(n)
    sent = jnp.where(S != 0, S, -jnp.inf)
    v, ix = tiled_topk(sent, k)  # row-wise
    v = jnp.where(jnp.isfinite(v), v, 0.0)
    S1 = jnp.zeros_like(S).at[rows[:, None], ix].set(v)
    sent1 = jnp.where(S1 != 0, S1, -jnp.inf)
    cv, cix = tiled_topk(sent1.T, k)  # column-wise
    cv = jnp.where(jnp.isfinite(cv), cv, 0.0)
    S2 = jnp.zeros_like(S).at[cix, rows[:, None]].set(cv)
    return S2, cv, cix


class SLIM_BPR(ItemSimilarityRecommender, IncrementalTrainingEarlyStopping):
    RECOMMENDER_NAME = "SLIM_BPR_Recommender"

    def fit(
        self,
        epochs: int = 300,
        positive_threshold: float = 1,
        train_with_sparse_weights: bool = None,  # accepted for API parity; dense HBM W is always used
        symmetric: bool = True,
        random_seed: int = 1234,
        lambda_i: float = 0.0,
        lambda_j: float = 0.0,
        learning_rate: float = 1e-4,
        topK: int = 200,
        sgd_mode: str = "adagrad",
        gamma: float = 0.995,
        beta_1: float = 0.9,
        beta_2: float = 0.999,
        chunk_size: int = 64,
        mesh_plan=None,
        presample: bool = False,
        **earlystopping_kwargs,
    ):
        self._presample = bool(presample)
        self.symmetric = symmetric
        self.topK = topK
        self.sgd_mode = sgd_mode
        self.learning_rate = learning_rate
        self.lambda_i = lambda_i
        self.lambda_j = lambda_j
        self.gamma = gamma
        self.beta_1 = beta_1
        self.beta_2 = beta_2
        self._chunk = int(chunk_size)

        urm_mask = self.URM_train.copy()
        if positive_threshold is not None:
            urm_mask.data = (urm_mask.data >= positive_threshold).astype(np.float32)
            urm_mask.eliminate_zeros()

        lens = np.ediff1d(urm_mask.indptr)
        warm = np.where((lens > 0) & (lens < self.n_items))[0].astype(np.int32)
        lmax = int(lens.max()) if len(lens) else 1
        pad = np.zeros((self.n_users, lmax), dtype=np.int32)
        for u in range(self.n_users):
            s, e = urm_mask.indptr[u], urm_mask.indptr[u + 1]
            pad[u, : e - s] = urm_mask.indices[s:e]

        self._urm_dev = jnp.asarray(np.asarray(urm_mask.todense(), dtype=np.float32))
        self._warm_dev = jnp.asarray(warm)
        self._pad_dev = jnp.asarray(pad)
        self._len_dev = jnp.asarray(np.maximum(lens, 1).astype(np.int32))

        I = self.n_items
        self._state = _OptState(
            W=jnp.zeros((I, I), jnp.float32),
            cache=jnp.zeros((I,), jnp.float32),
            m1=jnp.zeros((I,), jnp.float32),
            m2=jnp.zeros((I,), jnp.float32),
            beta1_t=jnp.asarray(1.0 - (1.0 - beta_1)),  # = beta_1, as in the reference init
            beta2_t=jnp.asarray(1.0 - (1.0 - beta_2)),
        )
        self._key = jax.random.PRNGKey(random_seed)
        # one reference epoch = n_users samples (+1 partial batch, pyx:201)
        self._n_chunks = max(1, int(np.ceil(self.n_users / self._chunk)))

        if mesh_plan is not None:
            # model-parallel memory: the dense [I, I] W (the HBM wall at
            # large catalogs — 1.2 GB f32 at LastFM) row-shards over the
            # mesh model axis, the URM over (data, model); the same jitted
            # epoch runs SPMD with GSPMD-inserted gathers/scatters, so the
            # trajectory is bit-identical to single-device
            self._urm_dev = mesh_plan.put(self._urm_dev, mesh_plan.urm)
            self._pad_dev = jax.device_put(self._pad_dev, mesh_plan.user_rows)
            self._state = self._state._replace(
                W=jax.device_put(self._state.W, mesh_plan.item_rows),
                cache=jax.device_put(self._state.cache, mesh_plan.item_rows),
                m1=jax.device_put(self._state.m1, mesh_plan.item_rows),
                m2=jax.device_put(self._state.m2, mesh_plan.item_rows),
            )

        self._train_with_early_stopping(epochs, algorithm_name=self.RECOMMENDER_NAME, **earlystopping_kwargs)
        S2, cv, cix = _prune_topk_device(jnp.asarray(self._S_best), int(self.topK), bool(self.symmetric))
        self.W_sparse = self._w_sparse_from_topk(cv, cix)
        self._durm = None
        self._device_w = S2  # same pruned matrix, already resident for scoring

    # -- epoch hooks ---------------------------------------------------------
    def _run_epoch(self, num_epoch):
        self._key, sub = jax.random.split(self._key)
        self._state = _bpr_epoch(
            self._state,
            self._urm_dev,
            self._warm_dev,
            self._pad_dev,
            self._len_dev,
            sub,
            learning_rate=self.learning_rate,
            li_reg=self.lambda_i,
            lj_reg=self.lambda_j,
            gamma=self.gamma,
            beta_1=self.beta_1,
            beta_2=self.beta_2,
            n_chunks=self._n_chunks,
            chunk=self._chunk,
            sgd_mode=self.sgd_mode,
            symmetric=self.symmetric,
            presample=self._presample,
        )

    @staticmethod
    def _zero_non_topk(A: np.ndarray, k: int, axis: int) -> np.ndarray:
        """Keep only the top-k *nonzero* entries along `axis`, zeroing the
        rest. Zeros are excluded from the selection (with a -inf key) so
        negative weights within the top-k survive, matching the reference's
        similarityMatrixTopK nonzero filter (Recommender_utils.py:98-104)
        that the dense get_S path routes through (SLIM_BPR_Cython_Epoch.pyx
        :404)."""
        n = A.shape[axis]
        if k >= n:
            return A
        key = np.where(A != 0, A, -np.inf)
        top = np.argpartition(-key, k - 1, axis=axis)
        drop = np.take(top, np.arange(k, n), axis=axis)
        out = A.copy()
        np.put_along_axis(out, drop, 0.0, axis=axis)
        return out

    def _get_w_sparse(self, S: np.ndarray):
        S = np.asarray(S, dtype=np.float32).copy()
        if self.symmetric:
            S = S + S.T  # materialize the shared triangular cells
        np.fill_diagonal(S, 0.0)
        # the reference prunes twice: row-wise top-K inside get_S
        # (SLIM_BPR_Cython_Epoch.pyx:1380-1412 / :404 dense path) and then
        # column-wise top-K again in the wrapper
        # (SLIM_BPR_Cython.py get_S_incremental_and_set_W)
        S = self._zero_non_topk(S, self.topK, axis=1)
        S = self._zero_non_topk(S, self.topK, axis=0)
        return check_matrix(sps.csr_matrix(S), "csr")

    # -- crash resume (optimizer state + sampling key) --------------------------
    def _checkpoint_state(self):
        return {"state": self._state, "key": self._key}

    def _restore_checkpoint_state(self, state):
        from ganmf_tpu.utils.checkpoint import coerce_pytree

        self._state = coerce_pytree(self._state, state["state"])
        self._key = jnp.asarray(state["key"])

    def _w_sparse_from_topk(self, cv, cix) -> sps.csr_matrix:
        """Host CSR from the device prune's per-column [I, k] candidates."""
        n = self.n_items
        vals = np.asarray(cv, dtype=np.float32)
        idx = np.asarray(cix)
        keep = vals != 0.0
        counts = keep.sum(axis=1)
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        W = sps.csc_matrix((vals[keep], idx[keep], indptr), shape=(n, n), dtype=np.float32)
        return check_matrix(W, "csr")

    def _prepare_model_for_validation(self):
        # validation scores straight from the device-pruned dense W — no
        # [I, I] host transfer per validation round
        S2, _, _ = _prune_topk_device(self._state.W, int(self.topK), bool(self.symmetric))
        self._adopt_device_w(S2)

    def _update_best_model(self):
        self._S_best = self._state.W  # device-resident snapshot


# reference-compatible alias (SLIM_BPR/Cython/SLIM_BPR_Cython.py:50)
SLIM_BPR_Cython = SLIM_BPR
