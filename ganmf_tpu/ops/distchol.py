"""Distributed dense Cholesky + triangular solves over a mesh axis.

Column-block-distributed right-looking Cholesky: every chip owns a
contiguous [n, W] column block of a symmetric positive-definite matrix
(W = n / n_shards), and panels of width ``w`` are factored one at a time —
the owner broadcasts its (already fully-updated) panel with one psum,
every chip factors the w x w diagonal block redundantly (cheaper than
a second collective), applies the triangular solve to the panel, and
rank-w-updates only its own trailing columns. Forward/backward block
substitution reuses the same broadcast-a-panel primitive, so a full
inverse-against-local-columns never materializes more than [n, W] + one
[n, w] panel per chip.

This removes the last replicated [I, I] buffer from the EASE-R build
(VERDICT r2 / ROADMAP: the Cholesky factor used to be replicated per
chip). Reference computes the same inverse with one host
numpy.linalg.inv (EASE_R_Recommender.py:61).

All code here runs INSIDE shard_map (it uses axis_index/psum); the
public entry is :func:`ease_r_topk_sharded` which wraps the shard_map.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ganmf_tpu.parallel.mesh import MODEL_AXIS


def _broadcast_panel(Ml, p, *, w, ppl, axis):
    """Panel p ([n, w] columns of the distributed matrix) from its owner to
    every shard: one masked dynamic-slice + one psum (only the owner
    contributes nonzeros)."""
    me = jax.lax.axis_index(axis)
    owner = p // ppl
    loc = (p % ppl) * w
    # non-owners slice a harmless in-range window; the mask zeroes it
    panel_l = jax.lax.dynamic_slice(Ml, (0, jnp.where(me == owner, loc, 0)), (Ml.shape[0], w))
    return jax.lax.psum(jnp.where(me == owner, panel_l, 0.0), axis)


def _cholesky_local(Gl, *, w, axis):
    """Right-looking blocked Cholesky of the column-distributed symmetric
    matrix. Gl: this shard's [n, W] columns (full symmetric storage).
    Returns this shard's columns of the lower-triangular factor L."""
    n, W = Gl.shape
    P = n // w
    ppl = W // w
    me = jax.lax.axis_index(axis)
    rows = jnp.arange(n)[:, None]
    colg = me * W + jnp.arange(W)[None, :]  # global column ids of this shard

    def body(p, Gl):
        pw = p * w
        panel = _broadcast_panel(Gl, p, w=w, ppl=ppl, axis=axis)  # [n, w]
        D = jax.lax.dynamic_slice(panel, (pw, 0), (w, w))
        Lpp = jnp.linalg.cholesky(D)
        # X = panel @ inv(Lpp)^T; only rows strictly below the block are L
        X = jax.scipy.linalg.solve_triangular(Lpp, panel.T, lower=True).T
        Lbelow = jnp.where(rows >= pw + w, X, 0.0)  # [n, w]
        # trailing symmetric rank-w update of this shard's columns >= pw+w
        Lb_cols = jax.lax.dynamic_slice(Lbelow, (me * W, 0), (W, w))  # rows at my columns
        Lb_cols = jnp.where(colg.T >= pw + w, Lb_cols, 0.0)
        Gl = Gl - jax.lax.dot_general(
            Lbelow, Lb_cols.T, (((1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
        )
        # the owner writes the factored panel (diag block + below) back
        Lpanel = Lbelow + jax.lax.dynamic_update_slice(jnp.zeros((n, w), Gl.dtype), Lpp, (pw, 0))
        owner = p // ppl
        loc = (p % ppl) * w
        written = jax.lax.dynamic_update_slice(Gl, Lpanel, (0, jnp.where(me == owner, loc, 0)))
        return jnp.where(me == owner, written, Gl)

    Gl = jax.lax.fori_loop(0, P, body, Gl)
    return jnp.where(rows < colg, 0.0, Gl)  # zero the upper triangle


def _solve_lower_local(Ll, R, *, w, axis):
    """Forward block substitution L Y = R with L column-distributed and R a
    per-shard local right-hand side [n, W_r]. Returns the local Y."""
    n = Ll.shape[0]
    P = n // w
    ppl = Ll.shape[1] // w
    rows = jnp.arange(n)[:, None]

    def body(p, Y):
        pw = p * w
        panel = _broadcast_panel(Ll, p, w=w, ppl=ppl, axis=axis)
        Lpp = jax.lax.dynamic_slice(panel, (pw, 0), (w, w))
        Rp = jax.lax.dynamic_slice(Y, (pw, 0), (w, Y.shape[1]))
        Yp = jax.scipy.linalg.solve_triangular(Lpp, Rp, lower=True)
        Y = jax.lax.dynamic_update_slice(Y, Yp, (pw, 0))
        Lbelow = jnp.where(rows >= pw + w, panel, 0.0)
        return Y - jax.lax.dot_general(
            Lbelow, Yp, (((1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
        )

    return jax.lax.fori_loop(0, P, body, R)


def _solve_upper_local(Ll, Y, *, w, axis):
    """Backward block substitution L^T X = Y (left-looking: each panel
    gathers the contributions of already-solved trailing blocks)."""
    n = Ll.shape[0]
    P = n // w
    ppl = Ll.shape[1] // w
    rows = jnp.arange(n)[:, None]

    def body(i, X):
        p = P - 1 - i
        pw = p * w
        panel = _broadcast_panel(Ll, p, w=w, ppl=ppl, axis=axis)
        Lpp = jax.lax.dynamic_slice(panel, (pw, 0), (w, w))
        Lbelow = jnp.where(rows >= pw + w, panel, 0.0)  # [n, w]
        Yp = jax.lax.dynamic_slice(Y, (pw, 0), (w, Y.shape[1]))
        # contributions of solved blocks (stored in X, zero elsewhere)
        Yp_eff = Yp - jax.lax.dot_general(
            Lbelow.T, X, (((1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
        )
        Xp = jax.scipy.linalg.solve_triangular(Lpp.T, Yp_eff, lower=False)
        return jax.lax.dynamic_update_slice(X, Xp, (pw, 0))

    X0 = jnp.zeros_like(Y)
    return jax.lax.fori_loop(0, P, body, X0)


def _ease_local(A, l2_norm, *, k, w, n_real, axis):
    """Per-shard EASE-R pipeline: local Gram columns -> distributed Cholesky
    -> distributed solve against this shard's unit columns -> B weights ->
    per-column top-K. A: replicated [U, n_pad] URM; returns ([W, k], [W, k])."""
    from ganmf_tpu.ops.topk import tiled_topk

    hi = jax.lax.Precision.HIGHEST
    me = jax.lax.axis_index(axis)
    n = A.shape[1]
    S = jax.lax.axis_size(axis)
    W = n // S
    colg = me * W + jnp.arange(W)  # this shard's global target columns

    Al = jax.lax.dynamic_slice(A, (0, me * W), (A.shape[0], W))
    Gl = jax.lax.dot_general(A, Al, (((0,), (0,)), ((), ())), precision=hi)  # A^T @ Al
    # ridge on the full padded diagonal: padded rows/cols become an
    # independent lambda*I block, so they factor cleanly and never couple
    # into the real columns' inverse
    Gl = Gl + l2_norm * (jnp.arange(n)[:, None] == colg[None, :]).astype(Gl.dtype)

    Ll = _cholesky_local(Gl, w=w, axis=axis)
    rhs = (jnp.arange(n)[:, None] == colg[None, :]).astype(Gl.dtype)  # unit columns
    Y = _solve_lower_local(Ll, rhs, w=w, axis=axis)
    Pcols = _solve_upper_local(Ll, Y, w=w, axis=axis)  # [n, W] columns of G^-1

    diag = Pcols[colg, jnp.arange(W)]
    B = -Pcols / diag[None, :]
    B = jnp.where(jnp.arange(n)[:, None] == colg[None, :], 0.0, B)
    B = jnp.where(jnp.arange(n)[:, None] < n_real, B, 0.0)  # padded rows out
    sent = jnp.where(B == 0.0, -jnp.inf, B)  # stored-nonzero semantics
    vals, idx = tiled_topk(sent.T, k)  # [W, k]
    return jnp.where(jnp.isfinite(vals), vals, 0.0), jnp.asarray(idx)


def ease_r_topk_sharded(A: jnp.ndarray, l2_norm: float, k: int, plan, panel: int = 256):
    """Fully-sharded EASE-R with top-K export: no [I, I] buffer is ever
    replicated — the Gram, the Cholesky factor, the inverse columns and the
    B weights all live column-sharded over the mesh model axis, and the
    factorization itself is the distributed blocked algorithm above.

    Returns ([n, k] values, [n, k] indices) like _ease_r_weights_topk.
    """
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    n = A.shape[1]
    S = plan.n_model
    # pad the item axis so every shard holds the same number of whole panels
    w = max(8, min(panel, -(-n // S)))
    n_pad = ((n + S * w - 1) // (S * w)) * (S * w)
    A = jnp.pad(A, ((0, 0), (0, n_pad - n)))

    fn = shard_map(
        functools.partial(_ease_local, k=k, w=w, n_real=n, axis=MODEL_AXIS),
        mesh=plan.mesh,
        in_specs=(P(None, None), P()),
        out_specs=(P(MODEL_AXIS, None), P(MODEL_AXIS, None)),
        check_vma=False,
    )
    vals, idx = jax.jit(fn, static_argnames=())(A, jnp.asarray(l2_norm, A.dtype))
    return vals[:n], idx[:n]
