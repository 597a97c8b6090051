"""SGD matrix-factorization trainers: BPR-MF, FunkSVD, AsySVD.

Device equivalents of the reference's Cython MF epochs
(MatrixFactorization/Cython/MatrixFactorization_Cython_Epoch.pyx:29-910 and
the wrappers in MatrixFactorization_Cython.py:172-330): per-epoch sampled
SGD updates over user/item factor tables with optional AdaGrad scaling,
re-phrased as chunked vectorized updates under one jitted lax.scan (same
redesign as ganmf_tpu.models.slim_bpr).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ganmf_tpu.models.base import MatrixFactorizationRecommender
from ganmf_tpu.models.early_stopping import IncrementalTrainingEarlyStopping


class _MFState(NamedTuple):
    U: jnp.ndarray  # [n_users, K]
    V: jnp.ndarray  # [n_items, K]
    bU: jnp.ndarray  # [n_users]
    bV: jnp.ndarray  # [n_items]
    bG: jnp.ndarray  # [1] global bias (reference pyx:179 GLOBAL_bias)
    cacheU: jnp.ndarray
    cacheV: jnp.ndarray


def _reject_seen(profile_pad, u, cand):
    """First candidate per sample not present in user u's padded index row
    (the streamed-storage seen test: membership over the O(max_nnz) row
    instead of a gather from the dense [U, I] matrix)."""
    rows = jnp.take(profile_pad, u, axis=0)  # [..., L]
    seen = jnp.any(rows[..., None, :] == cand[..., :, None], axis=-1)
    first_ok = jnp.argmax(jnp.where(seen, 0, 1), axis=-1)
    return jnp.take_along_axis(cand, first_ok[..., None], axis=-1)[..., 0]


def _draw_samples(urm, val_pad, warm_users, profile_pad, profile_len, n_items,
                  key, shape, with_neg):
    """(u, i, r_ui[, j-]) SGD samples of the given leading shape, drawn from
    the epoch-constant tables in one vectorized pass. With ``urm=None``
    (streamed padded-CSR storage) the rating is read from the padded value
    table at the drawn slot and the negative-sample rejection test is a
    membership check against the padded index row — both produce the exact
    values the dense reads would, so the two storages share one trajectory."""
    k_u, k_p, k_n = jax.random.split(key, 3)
    u = jnp.take(warm_users, jax.random.randint(k_u, shape, 0, warm_users.shape[0]))
    lens = jnp.take(profile_len, u)
    slot = jax.random.randint(k_p, shape, 0, jnp.iinfo(jnp.int32).max) % lens
    i = profile_pad[u, slot]
    r_ui = val_pad[u, slot] if urm is None else urm[u, i]
    if not with_neg:
        return u, i, r_ui, jnp.zeros_like(u)
    cand = jax.random.randint(k_n, shape + (8,), 0, n_items)
    if urm is not None:
        seen = urm[u[..., None], cand] != 0
        first_ok = jnp.argmax(jnp.where(seen, 0, 1), axis=-1)
        j = jnp.take_along_axis(cand, first_ok[..., None], axis=-1)[..., 0]
    elif len(shape) == 2:
        # presampled: the [n_chunks, chunk, 8, L] membership compare would
        # not fit HBM in one pass — map it over the chunk axis
        j = jax.lax.map(lambda ab: _reject_seen(profile_pad, ab[0], ab[1]), (u, cand))
    else:
        j = _reject_seen(profile_pad, u, cand)
    return u, i, r_ui, j


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_items", "n_chunks", "chunk", "algorithm", "use_adagrad", "use_bias", "presample",
    ),
)
def _mf_epoch(
    state: _MFState,
    urm,  # [U, I] dense ratings, or None for streamed padded-CSR storage
    val_pad: jnp.ndarray,  # [U, L] padded rating values (read when urm is None)
    warm_users: jnp.ndarray,
    profile_pad: jnp.ndarray,
    profile_len: jnp.ndarray,
    key,
    learning_rate: float,
    user_reg: float,
    item_reg: float,
    bias_reg: float,
    n_items: int,
    n_chunks: int,
    chunk: int,
    algorithm: str,
    use_adagrad: bool,
    use_bias: bool,
    presample: bool = False,
):
    def body(state: _MFState, xs):
        if presample:
            u, i, r_ui, j = xs
        else:
            u, i, r_ui, j = _draw_samples(
                urm, val_pad, warm_users, profile_pad, profile_len, n_items,
                xs, (chunk,), with_neg=algorithm == "bpr",
            )

        Uu = jnp.take(state.U, u, axis=0)  # [C, K]
        Vi = jnp.take(state.V, i, axis=0)

        if algorithm == "bpr":
            Vj = jnp.take(state.V, j, axis=0)
            x_uij = jnp.sum(Uu * (Vi - Vj), axis=1)
            g = 1.0 / (1.0 + jnp.exp(x_uij))  # sigmoid gradient
            dU = g[:, None] * (Vi - Vj) - user_reg * Uu
            dVi = g[:, None] * Uu - item_reg * Vi
            dVj = -g[:, None] * Uu - item_reg * Vj
        else:  # funk_svd / asy_svd: pointwise squared error on observed cells
            pred = jnp.sum(Uu * Vi, axis=1)
            if use_bias:
                pred = pred + state.bG[0] + jnp.take(state.bU, u) + jnp.take(state.bV, i)
            err = r_ui - pred
            dU = err[:, None] * Vi - user_reg * Uu
            dVi = err[:, None] * Uu - item_reg * Vi
            dVj = None

        if use_adagrad:
            cu = state.cacheU.at[u].add(jnp.mean(dU**2, axis=1))
            cv = state.cacheV.at[i].add(jnp.mean(dVi**2, axis=1))
            scale_u = 1.0 / (jnp.sqrt(jnp.take(cu, u)) + 1e-8)
            scale_v = 1.0 / (jnp.sqrt(jnp.take(cv, i)) + 1e-8)
        else:
            cu, cv = state.cacheU, state.cacheV
            scale_u = scale_v = jnp.ones((chunk,))

        U = state.U.at[u].add(learning_rate * scale_u[:, None] * dU)
        V = state.V.at[i].add(learning_rate * scale_v[:, None] * dVi)
        bU, bV, bG = state.bU, state.bV, state.bG
        if algorithm == "bpr":
            V = V.at[j].add(learning_rate * scale_v[:, None] * dVj)
        elif use_bias:
            err = r_ui - (jnp.sum(Uu * Vi, axis=1) + state.bG[0]
                          + jnp.take(state.bU, u) + jnp.take(state.bV, i))
            bU = bU.at[u].add(learning_rate * (err - bias_reg * jnp.take(state.bU, u)))
            bV = bV.at[i].add(learning_rate * (err - bias_reg * jnp.take(state.bV, i)))
            # batched analogue of the reference's per-sample global-bias
            # update (pyx:341,:347). Every sample touches the global bias, so
            # the duplicate-sum semantics used for bU/bV would scale the step
            # by the whole chunk (lr * chunk * err — divergent); the chunk
            # MEAN gradient is the batch-SGD step for a parameter shared by
            # every sample in the batch.
            bG = bG + learning_rate * jnp.mean(err - bias_reg * state.bG[0])

        return _MFState(U, V, bU, bV, bG, cu, cv), None

    if presample:
        # epoch-constant sampling tables: draw every chunk's samples in one
        # vectorized pass outside the serialized scan
        xs = _draw_samples(
            urm, val_pad, warm_users, profile_pad, profile_len, n_items,
            key, (n_chunks, chunk), with_neg=algorithm == "bpr",
        )
    else:
        xs = jax.random.split(key, n_chunks)
    state, _ = jax.lax.scan(body, state, xs)
    return state


class _MFSGDBase(MatrixFactorizationRecommender, IncrementalTrainingEarlyStopping):
    ALGORITHM = "funk_svd"

    def fit(
        self,
        epochs: int = 300,
        num_factors: int = 10,
        learning_rate: float = 0.001,
        use_bias: bool = True,
        user_reg: float = 0.0,
        item_reg: float = 0.0,
        bias_reg: float = 0.0,
        sgd_mode: str = "adagrad",
        init_std: float = 0.1,
        random_seed: int = 1234,
        batch_size: int = 256,
        samples_per_epoch: int = None,
        mesh_plan=None,
        presample: bool = True,
        urm_storage: str = "dense",
        **earlystopping_kwargs,
    ):
        # presample=True (default): every chunk's (u, i, r[, j]) samples are
        # drawn from the epoch-constant tables in one vectorized pass outside
        # the serialized scan (not yet measured on the GPU against in-scan
        # sampling). There are no reference parity rows for the MF-SGD family (the root
        # harness never invokes MatrixFactorization_Cython, SURVEY §2.3), so
        # changing the default RNG stream order is safe; pass False for the
        # in-scan stream. SLIM-BPR keeps presample=False because its parity
        # rows are stream-sensitive.
        if urm_storage not in ("dense", "csr"):
            raise ValueError(f"urm_storage must be 'dense' or 'csr', got {urm_storage!r}")
        # use_bias defaults True for the rating-prediction models and is
        # forced off for BPR, exactly the reference wrappers
        # (MatrixFactorization_Cython.py:39 fit default, :184 BPR override)
        self._use_bias = False if self.ALGORITHM == "bpr" else bool(use_bias)
        self._presample = bool(presample)
        rng = np.random.RandomState(random_seed)
        K = int(num_factors)
        self.num_factors = K

        urm = self.URM_train
        lens = np.ediff1d(urm.indptr)
        warm = np.where(lens > 0)[0].astype(np.int32)

        from ganmf_tpu.data.device import padded_csr_from_sparse

        # padded-CSR tables back sampling for both storages; with
        # urm_storage="csr" they are the ONLY per-user state (O(U * max_nnz)
        # instead of the O(U * I) dense matrix — same beyond-HBM storage as
        # GANMF/DisGANMF/CFGAN/IALS, and trajectory-identical to dense mode
        # because the rating is the padded value at the drawn slot and the
        # negative-rejection test is an exact membership check)
        pc = padded_csr_from_sparse(urm)
        self._urm_dev = None if urm_storage == "csr" else self.device_urm().dense
        self._warm = jnp.asarray(warm)
        self._pad = pc.idx
        self._val = pc.val
        self._lens = jnp.asarray(np.maximum(lens, 1).astype(np.int32))

        self._state = _MFState(
            U=jnp.asarray(rng.normal(0, init_std, (self.n_users, K)).astype(np.float32)),
            V=jnp.asarray(rng.normal(0, init_std, (self.n_items, K)).astype(np.float32)),
            bU=jnp.zeros((self.n_users,), jnp.float32),
            bV=jnp.zeros((self.n_items,), jnp.float32),
            bG=jnp.zeros((1,), jnp.float32),
            cacheU=jnp.zeros((self.n_users,), jnp.float32),
            cacheV=jnp.zeros((self.n_items,), jnp.float32),
        )
        if mesh_plan is not None:
            # the dense [U, I] URM (the big buffer) shards over the mesh;
            # factor tables shard by their major axis; the same jitted epoch
            # runs SPMD via GSPMD — trajectory identical to single-device
            if self._urm_dev is not None:
                self._urm_dev = mesh_plan.put(self._urm_dev, mesh_plan.urm)
            self._pad = jax.device_put(self._pad, mesh_plan.user_rows)
            self._val = jax.device_put(self._val, mesh_plan.user_rows)
            self._state = self._state._replace(
                U=jax.device_put(self._state.U, mesh_plan.user_rows),
                bU=jax.device_put(self._state.bU, mesh_plan.user_rows),
                cacheU=jax.device_put(self._state.cacheU, mesh_plan.user_rows),
                V=jax.device_put(self._state.V, mesh_plan.item_rows),
                bV=jax.device_put(self._state.bV, mesh_plan.item_rows),
                cacheV=jax.device_put(self._state.cacheV, mesh_plan.item_rows),
            )

        self._key = jax.random.PRNGKey(random_seed)
        self._chunk = int(batch_size)
        n_samples = samples_per_epoch or max(self.n_users, urm.nnz // 4)
        self._n_chunks = max(1, int(np.ceil(n_samples / self._chunk)))
        self._lr = float(learning_rate)
        self._regs = (float(user_reg), float(item_reg), float(bias_reg))
        self._use_adagrad = sgd_mode == "adagrad"

        self._update_best_model()
        self._train_with_early_stopping(epochs, algorithm_name=self.RECOMMENDER_NAME, **earlystopping_kwargs)
        self.USER_factors = self.USER_factors_best
        self.ITEM_factors = self.ITEM_factors_best
        self._export_biases(self._bias_best)
        self._invalidate_device_cache()

    def _run_epoch(self, num_epoch):
        self._key, sub = jax.random.split(self._key)
        self._state = _mf_epoch(
            self._state, self._urm_dev, self._val, self._warm, self._pad, self._lens, sub,
            self._lr, *self._regs,
            n_items=self.n_items, n_chunks=self._n_chunks, chunk=self._chunk,
            algorithm=self.ALGORITHM, use_adagrad=self._use_adagrad, use_bias=self._use_bias,
            presample=self._presample,
        )

    # -- crash resume (optimizer state + sampling key) --------------------------
    def _checkpoint_state(self):
        return {"state": self._state, "key": self._key}

    def _restore_checkpoint_state(self, state):
        from ganmf_tpu.utils.checkpoint import coerce_pytree

        self._state = coerce_pytree(self._state, state["state"])
        self._key = jnp.asarray(state["key"])

    def _export_biases(self, triple):
        """Publish (bU, bV, bG) for scoring (folded into the device factors
        by MatrixFactorizationRecommender._factors_device), or mark the
        model biasless."""
        if self._use_bias and triple is not None:
            self.USER_bias, self.ITEM_bias, self.GLOBAL_bias = triple
            self.use_bias = True
        else:
            self.USER_bias = self.ITEM_bias = None
            self.GLOBAL_bias = 0.0
            self.use_bias = False
        self._device_factors = None

    def _prepare_model_for_validation(self):
        self.USER_factors = np.asarray(self._state.U)
        self.ITEM_factors = np.asarray(self._state.V)
        self._export_biases(
            (np.asarray(self._state.bU), np.asarray(self._state.bV),
             float(self._state.bG[0])))
        self._invalidate_device_cache()

    def _update_best_model(self):
        if hasattr(self, "_state"):
            self.USER_factors_best = np.asarray(self._state.U)
            self.ITEM_factors_best = np.asarray(self._state.V)
            self._bias_best = (
                np.asarray(self._state.bU), np.asarray(self._state.bV),
                float(self._state.bG[0]))
        else:
            self.USER_factors_best = self.USER_factors
            self.ITEM_factors_best = self.ITEM_factors
            self._bias_best = None


class MatrixFactorization_BPR(_MFSGDBase):
    """BPR-MF (reference MatrixFactorization_Cython.py:172)."""

    RECOMMENDER_NAME = "MF_BPR_Recommender"
    ALGORITHM = "bpr"


class MatrixFactorization_FunkSVD(_MFSGDBase):
    """FunkSVD pointwise MF (reference MatrixFactorization_Cython.py:193)."""

    RECOMMENDER_NAME = "MF_FunkSVD_Recommender"
    ALGORITHM = "funk_svd"


class MatrixFactorization_AsySVD(_MFSGDBase):
    """AsySVD with biases (reference MatrixFactorization_Cython.py:220)."""

    RECOMMENDER_NAME = "MF_AsySVD_Recommender"
    ALGORITHM = "asy_svd"
