"""IRGAN: adversarial matrix factorization with dynamic negative sampling.

Completes the reference's vestigial kernel (GANRec/Cython/IRGAN_Cython.pyx:43
— present in the repo but unreachable: its ``fit`` samples negatives and
discards them, IRGAN_Cython.pyx:78-80, and no wrapper exists at the reference
root). The pieces it does define fix the intended design, which this module
implements in full, as device programs:

- dual MF scorers (generator + discriminator), each ``u @ V.T + item_bias``
  (IRGAN_Cython.pyx:183-203 — a triple host loop there; one matmul here);
- dynamic negative sampling: per positive interaction, draw ``DNS_K``
  unobserved candidates with probability proportional to the generator's
  current scores and keep the highest-scoring one
  (``dynamic_negative_sample``, IRGAN_Cython.pyx:83-109 — a per-user host
  loop building an inverse-CDF over unobserved columns; here one
  ``jax.random.categorical`` over seen-masked logits per chunk);
- pairwise sigmoid SGD updates on (u, i, j) triples
  (``dns_update_step``, IRGAN_Cython.pyx:111-180);
- an adversarial phase in the spirit of IRGAN (Wang et al., SIGIR'17, the
  paper the kernel names): D trains to rank true positives above
  generator-sampled negatives; G trains by policy gradient (REINFORCE over
  its full temperature-softmax item distribution) with D's pairwise
  advantage as the reward.

Reference quirks documented, not copied:
- the reference regularizer is *added* to the ascent direction
  (``+ 2*reg*w``, IRGAN_Cython.pyx:151-155), i.e. anti-regularization; this
  module applies proper weight decay (``- reg*w``);
- the reference CDF samples proportional to *raw* scores
  (cython_utils.pyx:227-236), undefined for negative scores (and the factors
  are init'd uniform(-delta, delta)); this module samples from the
  temperature-softmax of the scores, which is well-defined and is what the
  IRGAN paper specifies.

Every per-epoch phase is one jitted ``lax.scan`` over interaction chunks.
Seen-item masks are built per chunk by scattering the padded-CSR index rows
(O(chunk * max_nnz)), so nothing O(U * I) is ever resident beyond the
[chunk, I] score blocks.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ganmf_tpu.models.base import MatrixFactorizationRecommender
from ganmf_tpu.models.early_stopping import IncrementalTrainingEarlyStopping

# plain float, NOT a jnp scalar: a module-level jnp constant would
# initialize the XLA backend at import time, which breaks
# jax.distributed.initialize in multi-process runtimes
_NEG_INF = -1e30


class _IRGANState(NamedTuple):
    Gu: jnp.ndarray  # generator user factors [U, K]
    Gv: jnp.ndarray  # generator item factors [I, K]
    Gb: jnp.ndarray  # generator item bias    [I]
    Du: jnp.ndarray  # discriminator user factors [U, K]
    Dv: jnp.ndarray  # discriminator item factors [I, K]
    Db: jnp.ndarray  # discriminator item bias    [I]


def _masked_logits(Uf, Vf, b, u, pad_rows, n_items, temperature):
    """Generator sampling logits for a user chunk: scores / temperature with
    the user's observed items masked to -inf. [C, I]"""
    scores = jnp.dot(jnp.take(Uf, u, axis=0), Vf.T) + b[None, :]
    rows = jnp.take(pad_rows, u, axis=0)  # [C, L], padded with n_items
    C = u.shape[0]
    seen = jnp.zeros((C, n_items + 1), jnp.bool_)
    seen = seen.at[jnp.arange(C)[:, None], rows].set(True)[:, :n_items]
    return jnp.where(seen, _NEG_INF, scores / temperature), scores


def _pairwise_update(Uf, Vf, b, u, i, j, lr, reg):
    """Ascent on log sigmoid(x_uij) with weight decay, x_uij =
    u.(v_i - v_j) + b_i - b_j — the dns_update_step direction
    (IRGAN_Cython.pyx:134-178) with the regularizer sign corrected."""
    Uu = jnp.take(Uf, u, axis=0)
    Vi = jnp.take(Vf, i, axis=0)
    Vj = jnp.take(Vf, j, axis=0)
    x = jnp.sum(Uu * (Vi - Vj), axis=1) + jnp.take(b, i) - jnp.take(b, j)
    g = jax.nn.sigmoid(-x)  # d/dx log sigmoid(x)
    Uf = Uf.at[u].add(lr * (g[:, None] * (Vi - Vj) - reg * Uu))
    Vf = Vf.at[i].add(lr * (g[:, None] * Uu - reg * Vi))
    Vf = Vf.at[j].add(lr * (-g[:, None] * Uu - reg * Vj))
    b = b.at[i].add(lr * (g - reg * jnp.take(b, i)))
    b = b.at[j].add(lr * (-g - reg * jnp.take(b, j)))
    return Uf, Vf, b


@functools.partial(
    jax.jit, static_argnames=("n_items", "n_chunks", "chunk", "dns_k")
)
def _dns_pretrain_epoch(
    state: _IRGANState, u_arr, i_arr, pad_rows, key,
    lr: float, reg: float, temperature: float,
    n_items: int, n_chunks: int, chunk: int, dns_k: int,
):
    """One generator pretraining epoch: for every (u, i+) interaction draw
    DNS_K unobserved candidates from the generator's softmax and take the
    best-scoring one as j-, then apply the pairwise update to G."""

    def body(carry, xs):
        Gu, Gv, Gb = carry
        c, k_c = xs
        u = jax.lax.dynamic_slice_in_dim(u_arr, c * chunk, chunk)
        i = jax.lax.dynamic_slice_in_dim(i_arr, c * chunk, chunk)
        logits, scores = _masked_logits(Gu, Gv, Gb, u, pad_rows, n_items, temperature)
        cand = jax.random.categorical(k_c, logits, axis=-1, shape=(dns_k, chunk)).T
        cand_scores = jnp.take_along_axis(scores, cand, axis=1)  # [C, dns_k]
        j = jnp.take_along_axis(cand, jnp.argmax(cand_scores, axis=1)[:, None], axis=1)[:, 0]
        Gu, Gv, Gb = _pairwise_update(Gu, Gv, Gb, u, i, j, lr, reg)
        return (Gu, Gv, Gb), None

    keys = jax.random.split(key, n_chunks)
    (Gu, Gv, Gb), _ = jax.lax.scan(
        body, (state.Gu, state.Gv, state.Gb), (jnp.arange(n_chunks), keys)
    )
    return state._replace(Gu=Gu, Gv=Gv, Gb=Gb)


@functools.partial(
    jax.jit,
    static_argnames=("n_items", "n_chunks", "chunk", "d_steps", "g_steps", "g_samples"),
)
def _adversarial_epoch(
    state: _IRGANState, u_arr, i_arr, pad_rows, key,
    d_lr: float, g_lr: float, d_reg: float, g_reg: float, temperature: float,
    n_items: int, n_chunks: int, chunk: int, d_steps: int, g_steps: int,
    g_samples: int,
):
    """One adversarial epoch. D phase (x d_steps): pairwise logistic updates
    on (u, i+, j~G). G phase (x g_steps): REINFORCE over the full softmax —
    the surrogate logit gradient is (reward - baseline) * (onehot(j) - p),
    whose parameter pullback is two matmuls per chunk."""

    def d_body(carry, xs):
        st = carry
        c, k_c = xs
        u = jax.lax.dynamic_slice_in_dim(u_arr, c * chunk, chunk)
        i = jax.lax.dynamic_slice_in_dim(i_arr, c * chunk, chunk)
        logits, _ = _masked_logits(st.Gu, st.Gv, st.Gb, u, pad_rows, n_items, temperature)
        j = jax.random.categorical(k_c, logits, axis=-1)
        Du, Dv, Db = _pairwise_update(st.Du, st.Dv, st.Db, u, i, j, d_lr, d_reg)
        return st._replace(Du=Du, Dv=Dv, Db=Db), None

    def g_body(carry, xs):
        st = carry
        c, k_c = xs
        u = jax.lax.dynamic_slice_in_dim(u_arr, c * chunk, chunk)
        i = jax.lax.dynamic_slice_in_dim(i_arr, c * chunk, chunk)
        logits, _ = _masked_logits(st.Gu, st.Gv, st.Gb, u, pad_rows, n_items, temperature)
        p = jax.nn.softmax(logits, axis=-1)  # [C, I]
        j = jax.random.categorical(k_c, logits, axis=-1, shape=(g_samples, chunk))  # [S, C]

        Duu = jnp.take(st.Du, u, axis=0)
        d_scores = jnp.dot(Duu, st.Dv.T) + st.Db[None, :]  # [C, I]
        d_pos = jnp.take_along_axis(d_scores, i[:, None], axis=1)  # [C, 1]
        adv = jnp.take_along_axis(d_scores, j.T, axis=1) - d_pos  # [C, S]
        reward = jax.nn.softplus(adv)  # log(1 + e^adv): G's payoff for fooling D
        reward = reward - jnp.mean(reward, axis=1, keepdims=True)  # baseline

        onehot_sum = jnp.zeros((chunk, n_items), jnp.float32)
        onehot_sum = onehot_sum.at[jnp.arange(chunk)[None, :], j].add(reward.T)
        # d surrogate / d logits, averaged over the S samples
        dlogits = (onehot_sum - jnp.sum(reward, axis=1)[:, None] * p) / (g_samples * temperature)

        Gu = st.Gu.at[u].add(g_lr * (jnp.dot(dlogits, st.Gv) - g_reg * jnp.take(st.Gu, u, axis=0)))
        Gv = st.Gv + g_lr * jnp.dot(dlogits.T, jnp.take(st.Gu, u, axis=0))
        Gb = st.Gb + g_lr * jnp.sum(dlogits, axis=0)
        return st._replace(Gu=Gu, Gv=Gv, Gb=Gb), None

    k_d, k_g = jax.random.split(key)
    for s in range(d_steps):
        keys = jax.random.split(jax.random.fold_in(k_d, s), n_chunks)
        state, _ = jax.lax.scan(d_body, state, (jnp.arange(n_chunks), keys))
    for s in range(g_steps):
        keys = jax.random.split(jax.random.fold_in(k_g, s), n_chunks)
        state, _ = jax.lax.scan(g_body, state, (jnp.arange(n_chunks), keys))
        # full-table weight decay once per G pass (the per-chunk REINFORCE
        # update touches every Gv row, so row-targeted decay has no meaning)
        state = state._replace(
            Gv=state.Gv * (1.0 - g_lr * g_reg), Gb=state.Gb * (1.0 - g_lr * g_reg)
        )
    return state


class IRGAN_Recommender(MatrixFactorizationRecommender, IncrementalTrainingEarlyStopping):
    """IRGAN MF with dynamic-negative-sampling pretraining.

    Serving scores are the generator's ``u @ V.T + b``; the bias folds into
    the factor tables (ones column x bias column) so the base dot-product
    path (base.py MatrixFactorizationRecommender) serves it unchanged.
    """

    RECOMMENDER_NAME = "IRGAN_Recommender"

    def fit(
        self,
        epochs: int = 300,
        pre_train_epochs: int = 100,
        num_factors: int = 10,
        init_delta: float = 0.05,
        batch_size: int = 256,
        DNS_K: int = 5,
        DNS_lr: float = 0.05,
        D_lr: float = 1e-4,
        G_lr: float = 1e-4,
        d_steps: int = 1,
        g_steps: int = 1,
        temperature: float = 0.2,
        disc_reg: float = 1e-4,
        gen_reg: float = 1e-4,
        g_samples: int = 16,
        random_seed: int = 1234,
        **earlystopping_kwargs,
    ):
        # signature mirrors the reference kernel's __init__/fit
        # (IRGAN_Cython.pyx:51, :66-68); g_samples is ours (REINFORCE batch)
        rng = np.random.RandomState(random_seed)
        K = int(num_factors)
        self.num_factors = K
        urm = self.URM_train

        from ganmf_tpu.data.device import padded_csr_from_sparse

        pc = padded_csr_from_sparse(urm)
        self._pad = pc.idx  # [U, L] padded with n_items

        coo = urm.tocoo()
        order = rng.permutation(coo.nnz)
        u_arr = coo.row[order].astype(np.int32)
        i_arr = coo.col[order].astype(np.int32)
        chunk = int(batch_size)
        n_chunks = max(1, int(np.ceil(coo.nnz / chunk)))
        pad_to = n_chunks * chunk
        if pad_to > coo.nnz:  # wrap-around padding keeps every chunk full
            extra = pad_to - coo.nnz
            u_arr = np.concatenate([u_arr, u_arr[:extra]])
            i_arr = np.concatenate([i_arr, i_arr[:extra]])
        self._u_arr = jnp.asarray(u_arr)
        self._i_arr = jnp.asarray(i_arr)
        self._chunk, self._n_chunks = chunk, n_chunks

        def table(shape):
            return jnp.asarray(rng.uniform(-init_delta, init_delta, shape).astype(np.float32))

        self._state = _IRGANState(
            Gu=table((self.n_users, K)), Gv=table((self.n_items, K)),
            Gb=jnp.zeros((self.n_items,), jnp.float32),
            Du=table((self.n_users, K)), Dv=table((self.n_items, K)),
            Db=jnp.zeros((self.n_items,), jnp.float32),
        )
        self._key = jax.random.PRNGKey(random_seed)
        self._hp = dict(
            DNS_lr=float(DNS_lr), D_lr=float(D_lr), G_lr=float(G_lr),
            d_steps=int(d_steps), g_steps=int(g_steps), DNS_K=int(DNS_K),
            temperature=float(temperature), disc_reg=float(disc_reg),
            gen_reg=float(gen_reg), g_samples=int(g_samples),
        )

        # ---- phase 1: DNS generator pretraining (no early stopping: the
        # reference kernel's pretrain loop has none either) ----
        for _ in range(int(pre_train_epochs)):
            self._key, sub = jax.random.split(self._key)
            self._state = _dns_pretrain_epoch(
                self._state, self._u_arr, self._i_arr, self._pad, sub,
                self._hp["DNS_lr"], self._hp["gen_reg"], self._hp["temperature"],
                n_items=self.n_items, n_chunks=self._n_chunks, chunk=self._chunk,
                dns_k=self._hp["DNS_K"],
            )

        # ---- phase 2: adversarial epochs under early stopping ----
        self._update_best_model()
        if int(epochs) > 0:
            self._train_with_early_stopping(
                int(epochs), algorithm_name=self.RECOMMENDER_NAME, **earlystopping_kwargs
            )
        else:  # pretrain-only fit (epochs=0): serve the pretrained generator
            self.epochs_best = 0
        self.USER_factors = self.USER_factors_best
        self.ITEM_factors = self.ITEM_factors_best
        self.use_bias = False
        self._invalidate_device_cache()

    def _run_epoch(self, num_epoch):
        self._key, sub = jax.random.split(self._key)
        self._state = _adversarial_epoch(
            self._state, self._u_arr, self._i_arr, self._pad, sub,
            self._hp["D_lr"], self._hp["G_lr"], self._hp["disc_reg"],
            self._hp["gen_reg"], self._hp["temperature"],
            n_items=self.n_items, n_chunks=self._n_chunks, chunk=self._chunk,
            d_steps=self._hp["d_steps"], g_steps=self._hp["g_steps"],
            g_samples=self._hp["g_samples"],
        )

    def _checkpoint_state(self):
        return {"state": self._state, "key": self._key}

    def _restore_checkpoint_state(self, state):
        from ganmf_tpu.utils.checkpoint import coerce_pytree

        self._state = coerce_pytree(self._state, state["state"])
        self._key = jnp.asarray(state["key"])

    def _gen_factors(self):
        """Generator factors with the item bias folded in: scores stay
        exactly u.v + b under the base dot-product serving path."""
        Gu = np.asarray(self._state.Gu)
        Gv = np.asarray(self._state.Gv)
        Gb = np.asarray(self._state.Gb)
        U = np.concatenate([Gu, np.ones((Gu.shape[0], 1), np.float32)], axis=1)
        V = np.concatenate([Gv, Gb[:, None]], axis=1)
        return U, V

    def _prepare_model_for_validation(self):
        self.USER_factors, self.ITEM_factors = self._gen_factors()
        self.use_bias = False
        self._invalidate_device_cache()

    def _update_best_model(self):
        if hasattr(self, "_state"):
            self.USER_factors_best, self.ITEM_factors_best = self._gen_factors()
        else:
            self.USER_factors_best = self.USER_factors
            self.ITEM_factors_best = self.ITEM_factors
