"""GANMF: GAN-based matrix factorization (the paper's model).

Reference: GANRec/GANMF.py. Generator = plain MF (user/item embedding
tables, fake profile u_e @ item_e^T, :75-84). Discriminator = single-hidden
-layer autoencoder over profiles with MSE reconstruction loss (:62-70).

    dloss = real_recon + max(0, m * real_recon - fake_recon) + d_reg * L2(D)
    gloss = (1 - a) * fake_recon + a * MSE(real_enc, fake_enc) + g_reg * L2(G)

(:131-135; a = recon_coefficient = feature-matching weight, EBGAN-style
margin loss.)

Device redesign: the URM lives dense in device memory; one epoch = one jitted program
scanning d_steps x n_batches discriminator updates then g_steps x n_batches
generator updates over a shuffled padded permutation (the reference runs
the same schedule with per-step host densification, GANMF.py:172-203).
Both phases keep everything — batches, grads, Adam state — on device.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ganmf_tpu.data.device import PaddedCSR, padded_rows_dense
from ganmf_tpu.models.gan_base import (
    AdversarialRecommender,
    make_batches,
    padded_weights,
    shuffled_padded_perm,
)
from ganmf_tpu.utils.debug import instrumented_jit


class GANMFParams(NamedTuple):
    user_emb: jnp.ndarray  # [U, K]
    item_emb: jnp.ndarray  # [I, K]
    enc_w: jnp.ndarray  # [I, E]
    enc_b: jnp.ndarray  # [E]
    dec_w: jnp.ndarray  # [E, I]
    dec_b: jnp.ndarray  # [I]


def _init_params(key, n_users, n_items, num_factors, emb_dim) -> GANMFParams:
    glorot = jax.nn.initializers.glorot_uniform()
    k1, k2, k3, k4 = jax.random.split(key, 4)
    return GANMFParams(
        user_emb=glorot(k1, (n_users, num_factors), jnp.float32),
        item_emb=glorot(k2, (n_items, num_factors), jnp.float32),
        enc_w=glorot(k3, (n_items, emb_dim), jnp.float32),
        enc_b=jnp.zeros((emb_dim,), jnp.float32),
        dec_w=glorot(k4, (emb_dim, n_items), jnp.float32),
        dec_b=jnp.zeros((n_items,), jnp.float32),
    )


def _g_params(p: GANMFParams):
    return (p.user_emb, p.item_emb)


def _d_params(p: GANMFParams):
    return (p.enc_w, p.enc_b, p.dec_w, p.dec_b)


def _autoencode(p: GANMFParams, x):
    enc = jnp.dot(x, p.enc_w) + p.enc_b
    dec = jnp.dot(enc, p.dec_w) + p.dec_b
    return enc, dec


def _masked_mse(a, b, w):
    """Mean squared error over valid rows (tf.losses.mean_squared_error of
    the reference computes a plain mean; padding rows carry zero weight).
    The reduction runs in f32 regardless of the activation dtype (the
    convert fuses into the reduce, so bf16 activations cost no extra HBM)."""
    diff = a.astype(jnp.float32) - b.astype(jnp.float32)
    per_elem = diff**2 * w[:, None]
    return jnp.sum(per_elem) / (jnp.maximum(jnp.sum(w), 1.0) * a.shape[1])


def _l2(tensors):
    # tf.nn.l2_loss(v) = sum(v^2) / 2; always over the f32 master params
    return sum(jnp.sum(t.astype(jnp.float32) ** 2) / 2.0 for t in tensors)


def _losses(p: GANMFParams, uids, real, w, m, recon_coefficient, d_reg, g_reg,
            compute_dtype=jnp.float32):
    """compute_dtype=bf16 runs the matmuls and [B, I] activations in
    bfloat16 (halving their HBM traffic) while the L2 regularizers and all
    loss reductions stay f32; gradients flow back to the f32 master params
    through the casts (SURVEY §7 / VERDICT r2 #9)."""
    pc = p
    if compute_dtype != jnp.float32:
        pc = GANMFParams(*(t.astype(compute_dtype) for t in p))
        real = real.astype(compute_dtype)
    fake = jnp.dot(jnp.take(pc.user_emb, uids, axis=0), pc.item_emb.T)
    real_enc, real_dec = _autoencode(pc, real)
    fake_enc, fake_dec = _autoencode(pc, fake)
    real_recon = _masked_mse(real, real_dec, w)
    fake_recon = _masked_mse(fake, fake_dec, w)

    dloss = real_recon + jnp.maximum(0.0, m * real_recon - fake_recon) + d_reg * _l2(_d_params(p))
    gloss = (
        (1.0 - recon_coefficient) * fake_recon
        + recon_coefficient * _masked_mse(real_enc, fake_enc, w)
        + g_reg * _l2(_g_params(p))
    )
    return dloss, gloss


# TF1-style Adam moments; the learning rate is applied as a traced scalar so
# tuning trials with different lrs reuse one compiled epoch program.
ADAM = optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8)


def _lazy_adam_rows(param, g, m, v, row_mask, lr, t, b1=0.9, b2=0.999, eps=1e-8):
    """TF1 sparse-Adam semantics for embedding-lookup gradients: moments and
    parameter updates touch only the batch's rows (the reference's
    user_embeddings go through tf.nn.embedding_lookup, GANMF.py:82, so TF
    routes them to AdamOptimizer._apply_sparse)."""
    mask = row_mask[:, None]
    m = jnp.where(mask > 0, b1 * m + (1 - b1) * g, m)
    v = jnp.where(mask > 0, b2 * v + (1 - b2) * g * g, v)
    lr_t = lr * jnp.sqrt(1 - b2**t) / (1 - b1**t)
    upd = jnp.where(mask > 0, lr_t * m / (jnp.sqrt(v) + eps), 0.0)
    return param - upd, m, v


@functools.partial(
    instrumented_jit,
    static_argnames=("n_batches", "batch_size", "d_steps", "g_steps", "lazy_user_adam", "compute_dtype"),
)
def ganmf_epoch(
    params: GANMFParams,
    d_opt_state,
    g_opt_state,
    urm: jnp.ndarray,  # [U, I] training-orientation dense
    perm: jnp.ndarray,  # [n_batches * batch_size] shuffled padded user ids
    weights: jnp.ndarray,  # [n_batches * batch_size] 1 for real rows
    d_lr: jnp.ndarray,
    g_lr: jnp.ndarray,
    m: float,
    recon_coefficient: float,
    d_reg: float,
    g_reg: float,
    n_batches: int,
    batch_size: int,
    d_steps: int,
    g_steps: int,
    lazy_user_adam: bool = False,
    compute_dtype: str = "f32",
):
    n_cols = params.dec_b.shape[0]
    cd = jnp.bfloat16 if compute_dtype == "bf16" else jnp.float32

    def get_batch(step):
        b = step % n_batches
        uids = jax.lax.dynamic_slice_in_dim(perm, b * batch_size, batch_size)
        w = jax.lax.dynamic_slice_in_dim(weights, b * batch_size, batch_size)
        if isinstance(urm, PaddedCSR):  # streamed: densify the batch on device
            real = padded_rows_dense(urm, uids, n_cols)
        else:
            real = jnp.take(urm, uids, axis=0)
        return uids, real, w

    def d_loss_fn(d_p, p, uids, real, w):
        p = p._replace(enc_w=d_p[0], enc_b=d_p[1], dec_w=d_p[2], dec_b=d_p[3])
        dloss, _ = _losses(p, uids, real, w, m, recon_coefficient, d_reg, g_reg, compute_dtype=cd)
        return dloss

    def g_loss_fn(g_p, p, uids, real, w):
        p = p._replace(user_emb=g_p[0], item_emb=g_p[1])
        _, gloss = _losses(p, uids, real, w, m, recon_coefficient, d_reg, g_reg, compute_dtype=cd)
        return gloss

    def d_body(carry, step):
        p, d_state, loss_acc = carry
        uids, real, w = get_batch(step)
        dloss, grads = jax.value_and_grad(d_loss_fn)(_d_params(p), p, uids, real, w)
        updates, d_state = ADAM.update(grads, d_state, _d_params(p))
        new_d = jax.tree_util.tree_map(lambda t, u: t - d_lr * u, _d_params(p), updates)
        p = p._replace(enc_w=new_d[0], enc_b=new_d[1], dec_w=new_d[2], dec_b=new_d[3])
        return (p, d_state, loss_acc + dloss), None

    def g_body(carry, step):
        p, g_state, loss_acc = carry
        item_state, m_u, v_u, t = g_state
        uids, real, w = get_batch(step)
        gloss, grads = jax.value_and_grad(g_loss_fn)(_g_params(p), p, uids, real, w)

        # TF1 Adam applies *dense* variable updates even for lookup (sparse)
        # gradients, so dense Adam is the faithful default; lazy row-masked
        # updates are available as a variant.
        t = t + 1.0
        if lazy_user_adam:
            row_mask = jnp.zeros((p.user_emb.shape[0],), jnp.float32).at[uids].max(w)
            user_emb, m_u, v_u = _lazy_adam_rows(p.user_emb, grads[0], m_u, v_u, row_mask, g_lr, t)
        else:
            b1, b2, eps = 0.9, 0.999, 1e-8
            m_u = b1 * m_u + (1 - b1) * grads[0]
            v_u = b2 * v_u + (1 - b2) * grads[0] ** 2
            lr_t = g_lr * jnp.sqrt(1 - b2**t) / (1 - b1**t)
            user_emb = p.user_emb - lr_t * m_u / (jnp.sqrt(v_u) + eps)
        updates, item_state = ADAM.update((grads[1],), item_state, (p.item_emb,))
        item_emb = p.item_emb - g_lr * updates[0]

        p = p._replace(user_emb=user_emb, item_emb=item_emb)
        return (p, (item_state, m_u, v_u, t), loss_acc + gloss), None

    (params, d_opt_state, d_loss_sum), _ = jax.lax.scan(
        d_body, (params, d_opt_state, 0.0), jnp.arange(d_steps * n_batches)
    )
    (params, g_opt_state, g_loss_sum), _ = jax.lax.scan(
        g_body, (params, g_opt_state, 0.0), jnp.arange(g_steps * n_batches)
    )
    denom = float(n_batches)
    return params, d_opt_state, g_opt_state, d_loss_sum / (denom * d_steps), g_loss_sum / (denom * g_steps)


class GANMF(AdversarialRecommender):
    RECOMMENDER_NAME = "GANMF"

    def fit(
        self,
        num_factors: int = 10,
        emb_dim: int = 32,
        epochs: int = 300,
        batch_size: int = 32,
        d_lr: float = 1e-4,
        g_lr: float = 1e-4,
        d_steps: int = 1,
        g_steps: int = 1,
        d_reg: float = 0,
        g_reg: float = 0,
        m: float = 1,
        recon_coefficient: float = 1e-2,
        allow_worse=None,
        freq=None,
        after: int = 0,
        metrics=("MAP",),
        sample_every=None,
        validation_evaluator=None,
        validation_set=None,
        lazy_user_adam: bool = False,
        mesh_plan=None,
        urm_storage: str = "dense",
        compute_dtype: str = "f32",
    ):
        """``mesh_plan`` (ganmf_tpu.parallel.MeshPlan, optional): place the
        URM, embeddings and autoencoder kernels over a (data, model) device
        mesh; the same jitted epoch program then runs SPMD with
        GSPMD-inserted collectives (user-axis grad psums, item-axis
        contractions). Single-device runs pass None.

        ``urm_storage``: "dense" keeps the [U, I] URM resident in HBM (the
        default; right whenever it fits). "csr" keeps only the padded-CSR
        arrays in HBM — O(nnz)-sized — and densifies each [B, I] minibatch
        on the fly inside the epoch scan, for datasets whose dense matrix
        would exceed HBM."""
        self.config = dict(
            num_factors=num_factors, emb_dim=emb_dim, epochs=epochs, batch_size=batch_size,
            d_lr=d_lr, g_lr=g_lr, d_steps=d_steps, g_steps=g_steps, d_reg=d_reg, g_reg=g_reg,
            m=m, recon_coefficient=recon_coefficient,
        )
        self.num_factors = int(num_factors)
        self.emb_dim = int(emb_dim)

        self._stream_seen = urm_storage == "csr"
        if urm_storage == "csr":
            from ganmf_tpu.data.device import padded_csr_from_sparse

            train_csr = self._train_matrix()
            n_rows, n_cols = train_csr.shape
            urm = padded_csr_from_sparse(train_csr)
            if compute_dtype == "bf16":
                urm = urm._replace(val=urm.val.astype(jnp.bfloat16))
        elif urm_storage == "dense":
            urm = self._train_dense()  # training orientation
            n_rows, n_cols = urm.shape
            if compute_dtype == "bf16":
                urm = urm.astype(jnp.bfloat16)
        else:
            raise ValueError(f"urm_storage must be 'dense' or 'csr', got {urm_storage!r}")

        key = jax.random.PRNGKey(self.seed)
        self.params = _init_params(key, n_rows, n_cols, self.num_factors, self.emb_dim)

        if mesh_plan is not None:
            from ganmf_tpu.parallel.distributed import shard_ganmf_params, shard_padded_csr

            self.params = shard_ganmf_params(self.params, mesh_plan)
            if urm_storage == "csr":
                # streamed storage composes with the mesh: the padded-CSR
                # arrays shard over the user axis, each batch densifies its
                # [B, I] block on device (GSPMD inserts the row gathers)
                urm = shard_padded_csr(urm, mesh_plan)
            else:
                urm = mesh_plan.put(urm, mesh_plan.urm)

        self._d_state = ADAM.init(_d_params(self.params))
        self._g_state = (
            ADAM.init((self.params.item_emb,)),
            jnp.zeros_like(self.params.user_emb),
            jnp.zeros_like(self.params.user_emb),
            jnp.float32(0.0),
        )

        self.train_d_loss, self.train_g_loss = [], []
        start_epoch = self.resume_from_checkpoint()  # also restores loss histories

        n_batches, padded = make_batches(n_rows, int(batch_size))
        weights = jnp.asarray(padded_weights(n_rows, padded))
        rng = np.random.RandomState(self.seed)
        # fast-forward the shuffle stream past the completed epochs so a
        # resumed run continues the exact permutation sequence of the
        # uninterrupted one (one rng.shuffle draw per epoch)
        for _ in range(start_epoch - 1):
            shuffled_padded_perm(rng, n_rows, padded)

        def epoch_fn(epoch):
            perm = jnp.asarray(shuffled_padded_perm(rng, n_rows, padded))
            self.params, self._d_state, self._g_state, dl, gl = ganmf_epoch(
                self.params, self._d_state, self._g_state, urm, perm, weights,
                jnp.float32(d_lr), jnp.float32(g_lr),
                m=float(m), recon_coefficient=float(recon_coefficient),
                d_reg=float(d_reg), g_reg=float(g_reg),
                n_batches=n_batches, batch_size=int(batch_size),
                d_steps=int(d_steps), g_steps=int(g_steps),
                lazy_user_adam=bool(lazy_user_adam), compute_dtype=compute_dtype,
            )
            # keep device scalars; converting would force a sync per epoch
            self.train_d_loss.append(dl)
            self.train_g_loss.append(gl)

        result = self._run_training_loop(
            epochs, validation_evaluator, validation_set, sample_every,
            allow_worse, freq, list(metrics), after, epoch_fn, start_epoch=start_epoch,
        )
        self._invalidate_device_cache()
        return result

    # -- crash resume (full training state) -----------------------------------
    def _checkpoint_state(self):
        return {"params": self.params, "d_state": self._d_state, "g_state": self._g_state}

    def _restore_checkpoint_state(self, state):
        self.params = GANMFParams(*state["params"])
        self._d_state = state["d_state"]
        self._g_state = state["g_state"]

    # -- scoring (reference GANMF.py:285-292) ---------------------------------
    def score_device(self, user_ids: jnp.ndarray) -> jnp.ndarray:
        hi = jax.lax.Precision.HIGHEST
        if self.mode == "item":
            # trained on URM^T: external-user scores are columns of the
            # internal fake matrix -> item_emb[uids] @ user_emb^T
            return jnp.dot(jnp.take(self.params.item_emb, user_ids, axis=0),
                           self.params.user_emb.T, precision=hi)
        return jnp.dot(jnp.take(self.params.user_emb, user_ids, axis=0),
                       self.params.item_emb.T, precision=hi)

    # -- introspection (reference GANMF.py:294-307) ---------------------------
    def user_factors(self):
        return np.asarray(self.params.user_emb)

    def item_factors(self):
        return np.asarray(self.params.item_emb)

    def autoencoder_codes(self):
        x = self._train_dense()
        enc, _ = _autoencode(self.params, x)
        return np.asarray(enc)
