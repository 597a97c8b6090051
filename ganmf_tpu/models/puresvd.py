"""PureSVD: truncated SVD of the interaction matrix.

The reference wraps sklearn's randomized_svd (MatrixFactorization/
PureSVDRecommender.py:29-37). Here the randomized range-finder runs on the
device — it is matmul-dominated (A @ Omega, power iterations, Q^T A) — and
only the tiny (k+p) x (k+p) SVD runs via jnp.linalg.svd.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from ganmf_tpu.data.device import dense_bf16_from_padded as _dense_bf16_from_padded
from ganmf_tpu.models.base import MatrixFactorizationRecommender


_HI = jax.lax.Precision.HIGHEST

# Device-memory budget for keeping the interaction matrix resident as
# dense bf16 (2 bytes/element) during a randomized-SVD fit. At ML-20M shape
# (138,493 x 26,744) the bf16 matrix is 7.4 GB and the f32 one 14.8 GB.
# Override with $GANMF_TPU_SVD_BF16_GB.
_RESIDENT_BF16_LIMIT = int(float(os.environ.get("GANMF_TPU_SVD_BF16_GB", "9")) * (1 << 30))


def _cholqr(Y):
    """One CholeskyQR pass: Q = Y R^-1 with R = chol(Y^T Y)^T.

    Matmul + small-triangular-solve only — a matmul-shaped replacement
    for Householder QR, which is serial."""
    G = jnp.dot(Y.T, Y, precision=_HI)
    G = G + 1e-7 * jnp.trace(G) / G.shape[0] * jnp.eye(G.shape[0], dtype=Y.dtype)
    L = jnp.linalg.cholesky(G)
    # Y = Q L^T  =>  Q = Y L^-T : solve L Q^T = Y^T
    Qt = jax.scipy.linalg.solve_triangular(L, Y.T, lower=True)
    return Qt.T


def _cholqr2(Y):
    """CholeskyQR2: two passes give near-Householder orthogonality."""
    return _cholqr(_cholqr(Y))


@functools.partial(jax.jit, static_argnames=("num_factors", "n_oversample", "n_iter"))
def _randomized_svd(A: jnp.ndarray, key, num_factors: int, n_oversample: int = 10, n_iter: int = 7):
    k = num_factors + n_oversample
    omega = jax.random.normal(key, (A.shape[1], k), dtype=A.dtype)
    Y = jnp.dot(A, omega, precision=_HI)
    for _ in range(n_iter):
        Y = _cholqr(Y)
        Z = jnp.dot(A.T, Y, precision=_HI)
        Z = _cholqr(Z)
        Y = jnp.dot(A, Z, precision=_HI)
    Q = _cholqr2(Y)
    B = jnp.dot(Q.T, A, precision=_HI)  # [k, I]
    Ub, S, Vt = jnp.linalg.svd(B, full_matrices=False)
    U = jnp.dot(Q, Ub, precision=_HI)
    return U[:, :num_factors], S[:num_factors], Vt[:num_factors]


@functools.partial(jax.jit, static_argnames=("num_factors", "n_iter"))
def _puresvd_factors(A: jnp.ndarray, key, num_factors: int, n_iter: int):
    """One device program producing the final (USER, ITEM) factor pair —
    a single dispatch + one batched readback on latency-bound links."""
    U, S, Vt = _randomized_svd(A, key, num_factors=num_factors, n_iter=n_iter)
    return U, (S[:, None] * Vt).T


# _dense_bf16_from_padded moved to data/device.py (imported above) so the
# similarity Gram can share it


@functools.partial(jax.jit, static_argnames=("num_factors", "n_oversample", "n_iter"))
def _puresvd_factors_resident(Ab, key, num_factors: int, n_oversample: int = 10, n_iter: int = 7):
    """Randomized SVD over a resident dense bf16 A: every range-finder pass
    is one direct matmul (bf16 x bf16 -> f32 accumulate) instead of
    re-scattering padded-CSR chunks into dense slabs 2*n_iter+2 times —
    the scatter traffic, not the matmuls, bounds the streamed build at
    ML-20M (same diagnosis as the int8 similarity build in
    ops/similarity.py).

    The power-iteration subspace tolerates bf16 rounding of the iterate
    (CholeskyQR re-orthonormalizes in f32 each pass); the final projection
    B = Q^T A runs Q in split-bf16 planes so, with A bf16-exact, B carries
    ~16 mantissa bits — the rank-k factors solve the same tiny SVD as the
    streamed path to ~1e-5."""

    def mm_a(Xb):  # [I, k] bf16 -> [R, k] f32
        return jax.lax.dot_general(
            Ab, Xb, (((1,), (0,)), ((), ())), preferred_element_type=jnp.float32
        )

    def mm_at(Yb):  # [R, k] bf16 -> [I, k] f32
        return jax.lax.dot_general(
            Ab, Yb, (((0,), (0,)), ((), ())), preferred_element_type=jnp.float32
        )

    k = num_factors + n_oversample
    omega = jax.random.normal(key, (Ab.shape[1], k), dtype=jnp.float32)
    Y = mm_a(omega.astype(jnp.bfloat16))
    for _ in range(n_iter):
        Y = _cholqr(Y)
        Z = _cholqr(mm_at(Y.astype(jnp.bfloat16)))
        Y = mm_a(Z.astype(jnp.bfloat16))
    Q = _cholqr2(Y)
    # split-plane final projection: per-term products against bf16-exact A
    # are exact, so the two planes reconstruct Q^T A to ~2^-16 relative
    q_hi = Q.astype(jnp.bfloat16)
    q_lo = (Q - q_hi.astype(jnp.float32)).astype(jnp.bfloat16)
    B = (mm_at(q_hi) + mm_at(q_lo)).T  # [k, I]
    Ub, S, Vt = jnp.linalg.svd(B, full_matrices=False)
    U = jnp.dot(Q, Ub, precision=_HI)
    S, Vt = S[:num_factors], Vt[:num_factors]
    return U[:, :num_factors], (S[:, None] * Vt).T


@functools.partial(jax.jit, static_argnames=("n_cols", "num_factors", "n_oversample", "n_iter", "chunk"))
def _puresvd_factors_streamed(
    idx: jnp.ndarray,  # [U_pad, L] padded-CSR column ids (sentinel n_cols)
    val: jnp.ndarray,  # [U_pad, L] values (0 on pad slots)
    key,
    n_cols: int,
    num_factors: int,
    n_oversample: int = 10,
    n_iter: int = 7,
    chunk: int = 2048,
):
    """Randomized SVD whose A-products stream over padded-CSR row chunks.

    The dense [U, I] matrix never materializes (14.8 GB at ML-20M); each
    chunk densifies to [chunk, I] on the fly and feeds the same
    CholeskyQR range-finder as the dense program. All FLOPs are matmuls;
    device memory holds only the padded-CSR arrays, one chunk, and the thin
    [U, k]/[I, k] iterates."""
    hi = jax.lax.Precision.HIGHEST
    n_rows_pad = idx.shape[0]
    n_chunks = n_rows_pad // chunk

    def _dense_chunk(c):
        bi = jax.lax.dynamic_slice_in_dim(idx, c * chunk, chunk)
        bv = jax.lax.dynamic_slice_in_dim(val, c * chunk, chunk)
        D = jnp.zeros((chunk, n_cols + 1), jnp.float32)
        return D.at[jnp.arange(chunk)[:, None], bi].add(bv)[:, :n_cols]

    def matmul_A(omega):  # [I, k] -> [U_pad, k]
        def body(c, Y):
            Yc = jnp.dot(_dense_chunk(c), omega, precision=hi)
            return jax.lax.dynamic_update_slice(Y, Yc, (c * chunk, 0))

        return jax.lax.fori_loop(0, n_chunks, body, jnp.zeros((n_rows_pad, omega.shape[1]), jnp.float32))

    def matmul_AT(Y):  # [U_pad, k] -> [I, k]
        def body(c, Z):
            Yc = jax.lax.dynamic_slice_in_dim(Y, c * chunk, chunk)
            return Z + jnp.dot(_dense_chunk(c).T, Yc, precision=hi)

        return jax.lax.fori_loop(0, n_chunks, body, jnp.zeros((n_cols, Y.shape[1]), jnp.float32))

    k = num_factors + n_oversample
    omega = jax.random.normal(key, (n_cols, k), dtype=jnp.float32)
    Y = matmul_A(omega)
    for _ in range(n_iter):
        Y = _cholqr(Y)
        Z = _cholqr(matmul_AT(Y))
        Y = matmul_A(Z)
    Q = _cholqr2(Y)
    B = matmul_AT(Q).T  # [k, I]
    Ub, S, Vt = jnp.linalg.svd(B, full_matrices=False)
    U = jnp.dot(Q, Ub, precision=hi)
    S, Vt = S[:num_factors], Vt[:num_factors]
    return U[:, :num_factors], (S[:, None] * Vt).T


class PureSVDRecommender(MatrixFactorizationRecommender):
    RECOMMENDER_NAME = "PureSVDRecommender"

    def fit(self, num_factors: int = 100, random_seed: int = 1234, n_iter: int = 7):
        if self._urm_streams():
            # dense f32 [U, I] would blow the HBM budget. Preferred: keep A
            # resident as dense bf16 (exact for bf16-representable values)
            # so every pass is one matmul; fall back to streaming the
            # A-products over padded-CSR chunks when even bf16 won't fit.
            chunk = 2048
            pc = self._padded_urm()
            pad = (-self.n_users) % chunk
            idx_a, val_a = pc.idx, pc.val
            if pad:
                idx_a = jnp.concatenate(
                    [idx_a, jnp.full((pad, idx_a.shape[1]), self.n_items, dtype=idx_a.dtype)]
                )
                val_a = jnp.concatenate([val_a, jnp.zeros((pad, val_a.shape[1]), val_a.dtype)])
            resident = (
                self._urm_values_bf16_exact()
                and 2 * idx_a.shape[0] * self.n_items <= _RESIDENT_BF16_LIMIT
            )
            if resident:
                Ab = _dense_bf16_from_padded(idx_a, val_a, n_cols=self.n_items, chunk=chunk)
                U, V = _puresvd_factors_resident(
                    Ab, jax.random.PRNGKey(random_seed),
                    num_factors=int(num_factors), n_iter=int(n_iter),
                )
                del Ab
            else:
                U, V = _puresvd_factors_streamed(
                    idx_a, val_a, jax.random.PRNGKey(random_seed), n_cols=self.n_items,
                    num_factors=int(num_factors), n_iter=int(n_iter), chunk=chunk,
                )
            U = U[: self.n_users]
            float(U[0, 0])
            self.USER_factors, self.ITEM_factors = U, V
            return
        A = self.device_urm().dense
        U, V = _puresvd_factors(A, jax.random.PRNGKey(random_seed), num_factors=int(num_factors), n_iter=int(n_iter))
        # factors stay device-resident; the host view materializes lazily
        # (MatrixFactorizationRecommender property) only if something reads
        # it — scoring/evaluation run straight off these arrays. A scalar
        # probe forces completion (block_until_ready returns early on the
        # relay backend), so fit() returns with the factors actually built.
        float(U[0, 0])
        # the factor setters reset _device_factors; the URM cache is left
        # alone (fit does not modify URM_train, and re-densifying it costs
        # a full host->device upload)
        self.USER_factors, self.ITEM_factors = U, V
