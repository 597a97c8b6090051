"""Multi-chip GANMF training step.

New capability over the single-GPU reference (SURVEY §2.9): the full
adversarial update — discriminator step then generator step on one user
minibatch — jitted over a (data, model) mesh. Placement:

  * URM            [U, I]  -> (data, model)
  * user embeddings [U, K] -> (data, -)      \\  generator
  * item embeddings [I, K] -> (model, -)     /
  * encoder kernel  [I, E] -> (model, -)     \\  discriminator
  * decoder kernel  [E, I] -> (-, model)     /
  * per-step batch rows    -> (data,)

Gradient reduction across the data axis and the item-dimension
contractions across the model axis are inserted by GSPMD from these
shardings — no hand-written collectives needed. The step
is the building block for a multi-chip fit(); ``dryrun`` in
``__graft_entry__`` exercises it on a virtual CPU mesh.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import optax

from ganmf_tpu.models.ganmf import ADAM, GANMFParams, _d_params, _g_params, _init_params, _losses
from ganmf_tpu.parallel.mesh import MODEL_AXIS, MeshPlan


def init_distributed(seed: int, n_users: int, n_items: int, num_factors: int, emb_dim: int,
                     plan: MeshPlan) -> Tuple[GANMFParams, object, object]:
    """Initialize sharded GANMF params + Adam states on the mesh."""
    params = _init_params(jax.random.PRNGKey(seed), n_users, n_items, num_factors, emb_dim)
    params = shard_ganmf_params(params, plan)
    d_state = ADAM.init(_d_params(params))
    g_state = ADAM.init(_g_params(params))
    return params, d_state, g_state


def shard_ganmf_params(params: GANMFParams, plan: MeshPlan) -> GANMFParams:
    return GANMFParams(
        user_emb=_safe_put(params.user_emb, plan.user_rows, plan),
        item_emb=_safe_put(params.item_emb, plan.item_rows, plan),
        enc_w=_safe_put(params.enc_w, plan.item_rows, plan),
        enc_b=_safe_put(params.enc_b, plan.replicated, plan),
        dec_w=_safe_put(params.dec_w, plan.item_cols, plan),
        dec_b=_safe_put(params.dec_b, plan.named(MODEL_AXIS), plan),
    )


def _safe_put(x, sharding, plan: MeshPlan):
    """device_put keeping every mesh axis that divides its dimension and
    dropping the rest (e.g. DisGANMF's [n_items+1, nodes] first kernel
    degrades to replicated on dim 0). Delegates to MeshPlan.put."""
    return plan.put(x, sharding)


def shard_padded_csr(pc, plan: MeshPlan):
    """Place streamed PaddedCSR storage on the mesh: both [R, L] arrays
    shard over the user axis, so per-shard HBM is O(nnz / n_user_shards).
    Batch densification then gathers rows across data shards via GSPMD."""
    return type(pc)(
        idx=_safe_put(pc.idx, plan.user_rows, plan),
        val=_safe_put(pc.val, plan.user_rows, plan),
    )


def shard_disganmf_params(params, plan: MeshPlan):
    """DisGANMFParams placement: embeddings over (data|model), the
    discriminator's first (item-wide) kernel over model, the small hidden
    kernels replicated."""
    return params._replace(
        user_emb=_safe_put(params.user_emb, plan.user_rows, plan),
        item_emb=_safe_put(params.item_emb, plan.item_rows, plan),
        d_ws=tuple(
            _safe_put(w, plan.item_rows if i == 0 else plan.replicated, plan)
            for i, w in enumerate(params.d_ws)
        ),
        d_bs=tuple(_safe_put(b, plan.replicated, plan) for b in params.d_bs),
        out_w=_safe_put(params.out_w, plan.replicated, plan),
        out_b=_safe_put(params.out_b, plan.replicated, plan),
    )


def _shard_mlp(p, plan: MeshPlan, in_items: bool, out_items: bool):
    """Place an MLP whose first kernel consumes an item-wide input
    (in_items) and/or whose last layer produces an item-wide output
    (out_items); hidden layers stay replicated."""
    n = len(p.ws)
    ws = []
    for i, w in enumerate(p.ws):
        if i == 0 and in_items and not (i == n - 1 and out_items):
            ws.append(_safe_put(w, plan.item_rows, plan))
        elif i == n - 1 and out_items:
            ws.append(_safe_put(w, plan.item_cols, plan))
        else:
            ws.append(_safe_put(w, plan.replicated, plan))
    bs = [
        _safe_put(
            b,
            plan.named(MODEL_AXIS) if (i == n - 1 and out_items) else plan.replicated,
            plan,
        )
        for i, b in enumerate(p.bs)
    ]
    return p._replace(ws=tuple(ws), bs=tuple(bs))


def shard_cfgan_params(params, plan: MeshPlan):
    """CFGANParams placement: G maps items->items (first kernel row-sharded,
    last kernel column-sharded over model); D consumes concat(cond, data)
    of width 2*I (first kernel row-sharded)."""
    return params._replace(
        G=_shard_mlp(params.G, plan, in_items=True, out_items=True),
        D=_shard_mlp(params.D, plan, in_items=True, out_items=False),
    )


def shard_caae_params(params, plan: MeshPlan):
    """CAAEParams placement: BPR discriminator factors over (data|model),
    both autoencoders item-sharded at the input/output layers."""
    return params._replace(
        d_user_emb=_safe_put(params.d_user_emb, plan.user_rows, plan),
        d_item_emb=_safe_put(params.d_item_emb, plan.item_rows, plan),
        d_item_bias=_safe_put(params.d_item_bias, plan.named(MODEL_AXIS), plan),
        G=_shard_mlp(params.G, plan, in_items=True, out_items=True),
        Gpr=_shard_mlp(params.Gpr, plan, in_items=True, out_items=True),
    )


def make_distributed_ganmf_step(plan: MeshPlan, m: float, recon_coefficient: float,
                                d_reg: float, g_reg: float):
    """Returns step(params, d_state, g_state, urm, uids, w, d_lr, g_lr)."""

    @functools.partial(jax.jit, donate_argnums=(0, 1, 2))
    def step(params, d_state, g_state, urm, uids, w, d_lr, g_lr):
        real = jnp.take(urm, uids, axis=0)

        def d_loss_fn(d_p):
            p = params._replace(enc_w=d_p[0], enc_b=d_p[1], dec_w=d_p[2], dec_b=d_p[3])
            return _losses(p, uids, real, w, m, recon_coefficient, d_reg, g_reg)[0]

        dloss, grads = jax.value_and_grad(d_loss_fn)(_d_params(params))
        updates, d_state = ADAM.update(grads, d_state, _d_params(params))
        new_d = jax.tree_util.tree_map(lambda t, u: t - d_lr * u, _d_params(params), updates)
        params = params._replace(enc_w=new_d[0], enc_b=new_d[1], dec_w=new_d[2], dec_b=new_d[3])

        def g_loss_fn(g_p):
            p = params._replace(user_emb=g_p[0], item_emb=g_p[1])
            return _losses(p, uids, real, w, m, recon_coefficient, d_reg, g_reg)[1]

        gloss, grads = jax.value_and_grad(g_loss_fn)(_g_params(params))
        updates, g_state = ADAM.update(grads, g_state, _g_params(params))
        new_g = jax.tree_util.tree_map(lambda t, u: t - g_lr * u, _g_params(params), updates)
        params = params._replace(user_emb=new_g[0], item_emb=new_g[1])

        return params, d_state, g_state, dloss, gloss

    return step
