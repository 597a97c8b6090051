"""CAAE: Adversarial Collaborative Auto-Encoder.

Reference: GANRec/CAAE.py. Three networks: D = BPR-style MF discriminator
over (user, pos, neg) triples with item bias (:50-81); G = sigmoid
autoencoder trained with a REINFORCE reward on sampled items plus a masked
reconstruction loss (:86-101); G' = a second autoencoder with a reward-only
loss (:106-119). All three use plain SGD (:140-142).

Device redesign (the reference interleaves host-side CDF sampling with
device updates every step, :228-337):
  * epoch-start G/G' reconstructions of all profiles are computed once on
    device; ALL negative items for the D phase are drawn up front in one
    vectorized bucketed inverse-CDF pass (the tables are fixed at epoch
    start, so nothing in the serialized update scan depends on them;
    equivalent to the reference's host inverse-CDF binary search,
    GANRec/Cython/cython_utils.pyx:74-104);
  * the G phase's weighted without-replacement sample Nu (prob ~ G'
    softmax restricted to non-interactions, size S * |non-interactions|)
    uses the Gumbel-top-k trick with per-user k;
  * the whole epoch is one jitted program; the dense URM stays in HBM
    (the reference holds it dense in host RAM, CAAE.py:199).

Reference quirks preserved: gpr_layers/gpr_units are ignored and G' is
built with g_layers/g_units (CAAE.py:136-137); G-phase users are drawn
without replacement, G'-phase users with replacement (:270,312).
Reference bug NOT preserved: the reference's _compute_item_score slices
URM rows by batch position instead of by requested user id (CAAE.py:392),
scoring the wrong users for every block after the first; here scoring
gathers the requested users' profiles.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ganmf_tpu.models.gan_base import AdversarialRecommender
from ganmf_tpu.ops.topk import smallest_k_mask
from ganmf_tpu.utils.debug import instrumented_jit


class MLPParams(NamedTuple):
    ws: Tuple[jnp.ndarray, ...]
    bs: Tuple[jnp.ndarray, ...]


class CAAEParams(NamedTuple):
    d_user_emb: jnp.ndarray  # [U, K]
    d_item_emb: jnp.ndarray  # [I, K]
    d_item_bias: jnp.ndarray  # [I]
    G: MLPParams
    Gpr: MLPParams


def _init_mlp(key, dims):
    glorot = jax.nn.initializers.glorot_uniform()
    keys = jax.random.split(key, len(dims) - 1)
    ws = tuple(glorot(keys[l], (dims[l], dims[l + 1]), jnp.float32) for l in range(len(dims) - 1))
    bs = tuple(jnp.zeros((dims[l + 1],), jnp.float32) for l in range(len(dims) - 1))
    return MLPParams(ws, bs)


def _autoencode(p: MLPParams, x):
    """All layers sigmoid-activated, including the reconstruction
    (CAAE.py:90-94)."""
    h = x
    for w, b in zip(p.ws, p.bs):
        h = jax.nn.sigmoid(jnp.dot(h, w) + b)
    return h


def _l2(tree):
    return sum(jnp.sum(t**2) / 2.0 for t in jax.tree_util.tree_leaves(tree))


def _sgd(tree, grads, lr):
    return jax.tree_util.tree_map(lambda t, g: t - lr * g, tree, grads)


def _bucketed_cdf_tables(prob: jnp.ndarray, nb: int):
    """Two-level inverse-CDF tables for per-row categorical sampling:
    bucket-level cdf [R, nb] and within-bucket cdf [R * nb, S]."""
    n_rows, n_cols = prob.shape
    s = -(-n_cols // nb)
    p3 = jnp.pad(prob, ((0, 0), (0, nb * s - n_cols))).reshape(n_rows, nb, s)
    bcdf = jnp.cumsum(jnp.sum(p3, axis=-1), axis=1)
    wcdf = jnp.cumsum(p3, axis=-1).reshape(n_rows * nb, s)
    return bcdf, wcdf


def _bucketed_cdf_sample(bcdf, wcdf, rows, key, nb: int, n_cols: int):
    """One categorical draw per row from the bucketed tables. Per-draw HBM
    traffic is O(nb + n_cols/nb) elements instead of a full n_cols-wide cdf
    row; distribution is exactly p(bucket) * p(item | bucket) = p(item).
    Zero-probability padding items have a flat cdf tail and r < total
    strictly, so they are never selected."""
    s = wcdf.shape[1]
    k1, k2 = jax.random.split(key)
    bb = jnp.take(bcdf, rows, axis=0)  # [B, nb]
    r1 = jax.random.uniform(k1, rows.shape) * bb[:, -1]
    b = jnp.minimum(jnp.sum(bb < r1[:, None], axis=1), nb - 1).astype(jnp.int32)
    wrow = jnp.take(wcdf, rows * nb + b, axis=0)  # [B, s]
    r2 = jax.random.uniform(k2, rows.shape) * wrow[:, -1]
    j = jnp.minimum(jnp.sum(wrow < r2[:, None], axis=1), s - 1).astype(jnp.int32)
    return jnp.minimum(b * s + j, n_cols - 1)


def _cdf_sample(cdf, rows, key, n_items: int):
    """One categorical draw per row by inverse-CDF binary search: the first
    index j with cdf[row, j] >= r. Touches O(log I) HBM elements per draw
    versus O(I) for a gathered-logits categorical — the device analogue of
    the reference's Cython sampler (cython_utils.pyx:74-104)."""
    r = jax.random.uniform(key, rows.shape) * jnp.take(cdf[:, -1], rows)
    lo = jnp.zeros(rows.shape, jnp.int32)
    hi = jnp.full(rows.shape, n_items - 1, jnp.int32)
    for _ in range(max(1, int(np.ceil(np.log2(n_items))))):
        mid = (lo + hi) // 2
        go_right = cdf[rows, mid] < r
        lo = jnp.where(go_right, mid + 1, lo)
        hi = jnp.where(go_right, hi, mid)
    return jnp.minimum(lo, n_items - 1)


@functools.partial(
    instrumented_jit,
    static_argnames=("d_bsize", "n_d_chunks", "d_steps", "g_steps", "gpr_steps", "m_batch", "n_samples", "d_scatter"),
)
def caae_epoch(
    params: CAAEParams,
    urm: jnp.ndarray,  # [U, I]
    inter_users: jnp.ndarray,  # [nnz_pad] user of each interaction
    inter_items: jnp.ndarray,  # [nnz_pad] item of each interaction
    inter_weight: jnp.ndarray,  # [nnz_pad] 0 for padding
    key,
    lr: jnp.ndarray,
    beta: jnp.ndarray,
    lmbda: jnp.ndarray,
    S: jnp.ndarray,
    d_bsize: int,
    n_d_chunks: int,
    d_steps: int,
    g_steps: int,
    gpr_steps: int,
    m_batch: int,
    n_samples: int,
    d_scatter: str = "direct",
):
    n_users, n_items = urm.shape
    interacted = urm != 0
    n_nonint = jnp.sum(~interacted, axis=1)

    k_shuffle, k_d, k_g, k_gpr = jax.random.split(key, 4)

    # per-epoch interaction shuffle (CAAE.py:220)
    perm = jax.random.permutation(k_shuffle, inter_users.shape[0])
    users = jnp.take(inter_users, perm)
    pos_items = jnp.take(inter_items, perm)
    weights = jnp.take(inter_weight, perm)

    # epoch-start generator outputs drive all D-phase negative sampling
    # (CAAE.py:228-241); sampling distribution = softmax(reconstruction).
    # Negatives are drawn by inverse-CDF binary search — the reference's own
    # sampler structure (cython_utils.pyx:74-104) — because a per-chunk
    # categorical would gather the full [chunk, I] logits block from HBM
    # while the binary search touches O(log I) elements per draw.
    g_logits_full = _autoencode(params.G, urm)  # [U, I]
    gpr_logits_full = _autoencode(params.Gpr, urm)
    gpr_prob_full = jax.nn.softmax(gpr_logits_full, axis=1)
    # Two-level (bucketed) inverse-CDF tables. One draw only needs its
    # bucket row [NB] and the chosen bucket's within-row [S], so per-draw
    # HBM traffic is O(NB + I/NB) ~ O(2*sqrt(I)) elements instead of the
    # full I-wide cdf row, which made the D phase bandwidth-bound.
    # Distribution is exactly p(bucket) * p(item | bucket) = p(item).
    NB = 64
    g_bcdf, g_wcdf = _bucketed_cdf_tables(jax.nn.softmax(g_logits_full, axis=1), NB)
    gpr_bcdf, gpr_wcdf = _bucketed_cdf_tables(gpr_prob_full, NB)

    def cdf_sample(tables, rows, key):
        bcdf, wcdf = tables
        return _bucketed_cdf_sample(bcdf, wcdf, rows, key, NB, n_items)

    # ---------------- D phase -------------------------------------------------
    # The BPR loss touches only the 3 * d_bsize gathered embedding rows, so
    # grads are taken w.r.t. the gathered values and scattered back with a
    # single .at[].add — numerically the dense jax.grad + SGD update, without
    # streaming the whole [U,K]/[I,K] tables through HBM twice per chunk.
    #
    # All three stores live fused in ONE [U + I, K + 1] table for the scan:
    # user rows first (their bias column is zero-initialized, referenced by
    # no term, so its gradient is identically zero), then item rows with the
    # bias folded in as column K. One chunk update is then exactly one row
    # gather and one scatter-add over [3B] fused indices instead of ten —
    # the scan is gather/scatter-latency-bound, not FLOP-bound, so fewer
    # ops over the same rows is the saving.
    # Equivalence with the unfused form: XLA scatter-add applies duplicate
    # updates in operand order, so [u; U+pos; U+neg] reproduces
    # .at[u].add / .at[pos].add / .at[neg].add, and the gradients are
    # elementwise in the gathered rows. Measured agreement after an epoch:
    # embeddings bitwise equal, bias within 1 ulp (XLA fuses the two bias
    # gradient contributions into an FMA here) — i.e. the same trajectory
    # up to compiler rounding; PARITY rows re-validated after this change.
    K = params.d_user_emb.shape[1]
    B = d_bsize

    def d_local_loss(rows, w):
        ue = rows[:B, :K]
        pe, ne = rows[B:2 * B], rows[2 * B:]
        x = jnp.sum(ue * (pe[:, :K] - ne[:, :K]), axis=1) + (pe[:, K] - ne[:, K])
        log_lik = jnp.sum(jax.nn.log_sigmoid(x) * w) / jnp.maximum(jnp.sum(w), 1.0)
        reg_rows = 0.5 * (jnp.sum(ue**2, 1) + jnp.sum(pe**2, 1) + jnp.sum(ne**2, 1))
        return -log_lik + beta * jnp.sum(reg_rows * w)

    def d_fused_update(tab, idxs, w):
        rows = jnp.take(tab, idxs, axis=0)  # [3B, K+1]
        g_rows = jax.grad(d_local_loss)(rows, w)
        return tab.at[idxs].add(-lr * g_rows)

    # Negatives depend only on the epoch-start tables and the fixed shuffled
    # user stream — never on the evolving embedding table — so ALL of them
    # are drawn here in one fully-parallel pass instead of inside the scan,
    # and the full [n_steps, 3B] fused gather-index arrays are assembled up
    # front. The serialized loop body shrinks to gather + grad + scatter;
    # the four bucket/within-bucket CDF gathers, the RNG splits, and the
    # index slicing/concat it used to pay per iteration become one
    # vectorized pass over [n_steps * B].
    n_steps = d_steps * n_d_chunks
    u_all = jnp.tile(
        users[: n_d_chunks * d_bsize].reshape(n_d_chunks, d_bsize), (d_steps, 1)
    )  # [n_steps, B]
    pos_all = jnp.tile(
        pos_items[: n_d_chunks * d_bsize].reshape(n_d_chunks, d_bsize), (d_steps, 1)
    )
    w_all = jnp.tile(
        weights[: n_d_chunks * d_bsize].reshape(n_d_chunks, d_bsize), (d_steps, 1)
    )
    k_d1, k_d2 = jax.random.split(k_d)
    step_rows = u_all.reshape(n_steps * d_bsize)
    neg_g_all = cdf_sample((g_bcdf, g_wcdf), step_rows, k_d1).reshape(n_steps, d_bsize)
    neg_gpr_all = cdf_sample((gpr_bcdf, gpr_wcdf), step_rows, k_d2).reshape(n_steps, d_bsize)
    idx_g_all = jnp.concatenate([u_all, n_users + pos_all, n_users + neg_g_all], axis=1)
    idx_gpr_all = jnp.concatenate([u_all, n_users + pos_all, n_users + neg_gpr_all], axis=1)

    tab = jnp.concatenate(
        [
            jnp.pad(params.d_user_emb, ((0, 0), (0, 1))),
            jnp.concatenate([params.d_item_emb, params.d_item_bias[:, None]], axis=1),
        ],
        axis=0,
    )

    if d_scatter == "direct":

        def d_chunk_update(tab, inputs):
            idx_g, idx_gpr, w = inputs
            # one update with G negatives, one with G' negatives (CAAE.py:255-265)
            tab = d_fused_update(tab, idx_g, w)
            tab = d_fused_update(tab, idx_gpr, w)
            return tab, None

        tab, _ = jax.lax.scan(d_chunk_update, tab, (idx_g_all, idx_gpr_all, w_all))
    else:
        # "dedup": conflict-free scatters. XLA must serialize a scatter-add
        # whose indices may collide; here every update's duplicate handling
        # is resolved OUTSIDE the scan — the index stream is sorted per
        # update (one batched per-epoch sort), duplicate runs are summed
        # inside the scan with one cumsum + two gathers (gathers have no
        # write hazards), and the scatter sees provably unique indices
        # (run starts keep their row, every other slot targets its own
        # scratch row past the table). Same math as "direct" up to f32
        # summation order within a duplicate run.
        nb3 = 3 * d_bsize
        pos_col = jnp.arange(nb3)

        def prep(idx_all):
            sort_idx = jnp.sort(idx_all, axis=1)
            perm = jnp.argsort(idx_all, axis=1)
            is_start = jnp.concatenate(
                [jnp.ones((n_steps, 1), bool), sort_idx[:, 1:] != sort_idx[:, :-1]], axis=1
            )
            # end of each duplicate run = (next run's start) - 1
            nxt = jnp.where(is_start, pos_col[None, :], nb3)
            nxt = jnp.flip(jax.lax.cummin(jnp.flip(jnp.roll(nxt, -1, axis=1).at[:, -1].set(nb3), axis=1), axis=1), axis=1)
            end_pos = jnp.minimum(nxt - 1, nb3 - 1)
            scat_idx = jnp.where(is_start, sort_idx, n_users + n_items + pos_col[None, :])
            return perm.astype(jnp.int32), scat_idx.astype(jnp.int32), end_pos.astype(jnp.int32)

        perm_g, scat_g, end_g = prep(idx_g_all)
        perm_gpr, scat_gpr, end_gpr = prep(idx_gpr_all)

        def d_dedup_update(tab, idxs, perm, scat, end, w):
            rows = jnp.take(tab, idxs, axis=0)  # [3B, K+1] (duplicates fine)
            g_rows = jax.grad(d_local_loss)(rows, w)
            g_sorted = jnp.take(g_rows, perm, axis=0)
            c = jnp.cumsum(g_sorted, axis=0)
            upper = jnp.take(c, end, axis=0)
            lower = jnp.where((pos_col > 0)[:, None], jnp.take(c, jnp.maximum(pos_col - 1, 0), axis=0), 0.0)
            return tab.at[scat].add(-lr * (upper - lower), unique_indices=True)

        def d_chunk_update(tab, inputs):
            idx_g, pg, sg, eg, idx_gpr, pp, sp, ep, w = inputs
            tab = d_dedup_update(tab, idx_g, pg, sg, eg, w)
            tab = d_dedup_update(tab, idx_gpr, pp, sp, ep, w)
            return tab, None

        tab = jnp.pad(tab, ((0, nb3), (0, 0)))  # scratch rows for non-starts
        tab, _ = jax.lax.scan(
            d_chunk_update, tab,
            (idx_g_all, perm_g, scat_g, end_g, idx_gpr_all, perm_gpr, scat_gpr, end_gpr, w_all),
        )
        tab = tab[: n_users + n_items]
    params = params._replace(
        d_user_emb=tab[:n_users, :K],
        d_item_emb=tab[n_users:, :K],
        d_item_bias=tab[n_users:, K],
    )

    # ---------------- helper: rewards from D ----------------------------------
    def reward_logits(uids, items):
        ue = jnp.take(params.d_user_emb, uids, axis=0)  # [m, K]
        fe = jnp.take(params.d_item_emb, items, axis=0)  # [m, n, K]
        fb = jnp.take(params.d_item_bias, items)  # [m, n]
        return jnp.einsum("mk,mnk->mn", ue, fe) + fb

    rows = jnp.arange(m_batch)

    # ---------------- G phase --------------------------------------------------
    def g_loss_fn(g_p, profiles, e_mask, reward, fake_items):
        recon = _autoencode(g_p, profiles)
        ae_loss = jnp.sum(((recon - profiles) * e_mask) ** 2)
        prob = jax.nn.softmax(recon, axis=1)[rows[:, None], fake_items]
        pg = -jnp.mean(jnp.log(jnp.maximum(prob, 1e-20)) * reward)
        return lmbda * pg + (1.0 - lmbda) * ae_loss + beta * _l2(g_p)

    def g_body(carry, k):
        g_p = carry
        k1, k2, k3 = jax.random.split(k, 3)
        uids = jax.random.permutation(k1, n_users)[:m_batch]  # without replacement (CAAE.py:270)
        profiles = jnp.take(urm, uids, axis=0)
        seen = profiles != 0

        # Nu ~ weighted sample w/o replacement from non-interactions with
        # prob ~ G' softmax (CAAE.py:277-285); Gumbel-top-k with per-user k
        p_gpr = jnp.take(gpr_prob_full, uids, axis=0)
        gumbel = -jnp.log(-jnp.log(jax.random.uniform(k2, profiles.shape, minval=1e-20) + 1e-20))
        keys = jnp.where(seen, -jnp.inf, jnp.log(jnp.maximum(p_gpr, 1e-30)) + gumbel)
        k_u = (jnp.take(n_nonint, uids) * S).astype(jnp.int32)
        # k_u largest keys = smallest_k_mask of the negated keys; bitwise
        # identical to the original argsort(-keys) rank table
        nu = smallest_k_mask(-keys, k_u) & (~seen)
        e_mask = jnp.clip(profiles + nu.astype(jnp.float32), 0.0, 1.0)

        g_recon = _autoencode(g_p, profiles)
        # n_samples draws per user via inverse CDF: a shaped categorical
        # would materialize [n_samples, m, I] Gumbel noise (~hundreds of MB
        # per step at ML-1M shapes); the binary search touches O(log I)
        fake_items = _cdf_sample(
            jnp.cumsum(jax.nn.softmax(g_recon, axis=1), axis=1),
            jnp.repeat(jnp.arange(m_batch), n_samples), k3, n_items,
        ).reshape(m_batch, n_samples)
        reward = jax.nn.log_sigmoid(reward_logits(uids, fake_items) - 1.0)

        grads = jax.grad(g_loss_fn)(g_p, profiles, e_mask, reward, fake_items)
        return _sgd(g_p, grads, lr), None

    g_p, _ = jax.lax.scan(g_body, params.G, jax.random.split(k_g, g_steps))
    params = params._replace(G=g_p)

    # ---------------- G' phase --------------------------------------------------
    def gpr_loss_fn(gpr_p, profiles, reward, fake_items):
        recon = _autoencode(gpr_p, profiles)
        prob = jax.nn.softmax(recon, axis=1)[rows[:, None], fake_items]
        return -jnp.mean(jnp.log(jnp.maximum(prob, 1e-20)) * reward) + beta * _l2(gpr_p)

    def gpr_body(carry, k):
        gpr_p = carry
        k1, k2 = jax.random.split(k)
        uids = jax.random.randint(k1, (m_batch,), 0, n_users)  # with replacement (CAAE.py:312)
        profiles = jnp.take(urm, uids, axis=0)
        recon = _autoencode(gpr_p, profiles)
        fake_items = _cdf_sample(
            jnp.cumsum(jax.nn.softmax(recon, axis=1), axis=1),
            jnp.repeat(jnp.arange(m_batch), n_samples), k2, n_items,
        ).reshape(m_batch, n_samples)
        reward = jax.nn.log_sigmoid(1.0 - reward_logits(uids, fake_items))
        grads = jax.grad(gpr_loss_fn)(gpr_p, profiles, reward, fake_items)
        return _sgd(gpr_p, grads, lr), None

    gpr_p, _ = jax.lax.scan(gpr_body, params.Gpr, jax.random.split(k_gpr, gpr_steps))
    params = params._replace(Gpr=gpr_p)

    return params


class CAAE(AdversarialRecommender):
    RECOMMENDER_NAME = "CAAE"
    SUPPORTS_ITEM_MODE = False  # the reference CAAE ignores mode (CAAE.py:25)

    def fit(
        self,
        epochs: int = 300,
        d_steps: int = 1,
        g_steps: int = 1,
        gpr_steps: int = 1,
        g_layers: int = 1,
        g_units: int = 20,
        gpr_layers: int = 1,
        gpr_units: int = 20,
        num_factors: int = 10,
        d_bsize: int = 1024,
        m_batch: int = 32,
        lmbda: float = 0.5,
        beta: float = 1e-4,
        lr: float = 1e-4,
        S: float = 0.3,
        allow_worse=None,
        freq=None,
        after: int = 0,
        metrics=("MAP",),
        sample_every=None,
        validation_evaluator=None,
        validation_set=None,
        mesh_plan=None,
        d_scatter: str = "direct",
    ):
        if d_scatter not in ("direct", "dedup"):
            raise ValueError(f"d_scatter must be 'direct' or 'dedup', got {d_scatter!r}")
        self.config = dict(
            epochs=epochs, d_steps=d_steps, g_steps=g_steps, gpr_steps=gpr_steps,
            g_layers=g_layers, g_units=g_units, gpr_layers=gpr_layers, gpr_units=gpr_units,
            num_factors=num_factors, d_bsize=d_bsize, m_batch=m_batch,
            lmbda=lmbda, beta=beta, lr=lr, S=S,
        )

        urm_csr = self.URM_train
        urm = jnp.asarray(np.asarray(urm_csr.todense(), dtype=np.float32))
        nnz = urm_csr.nnz

        coo = urm_csr.tocoo()
        n_d_chunks = max(1, int(np.ceil(nnz / int(d_bsize))))
        pad = n_d_chunks * int(d_bsize) - nnz
        inter_users = jnp.asarray(np.concatenate([coo.row, np.zeros(pad, np.int32)]).astype(np.int32))
        inter_items = jnp.asarray(np.concatenate([coo.col, np.zeros(pad, np.int32)]).astype(np.int32))
        inter_weight = jnp.asarray(np.concatenate([np.ones(nnz, np.float32), np.zeros(pad, np.float32)]))

        median_interactions = int(np.median(np.ediff1d(urm_csr.indptr)))
        n_samples = max(1, 2 * median_interactions)

        key = jax.random.PRNGKey(self.seed)
        k_d, k_g, k_gpr, self._epoch_key = jax.random.split(key, 4)
        glorot = jax.nn.initializers.glorot_uniform()
        k_du, k_di = jax.random.split(k_d)
        g_dims = [self.n_items] + [int(g_units)] * int(g_layers) + [self.n_items]
        # reference builds G' with g_layers/g_units too (CAAE.py:136-137)
        gpr_dims = g_dims
        self.params = CAAEParams(
            d_user_emb=glorot(k_du, (self.n_users, int(num_factors)), jnp.float32),
            d_item_emb=glorot(k_di, (self.n_items, int(num_factors)), jnp.float32),
            d_item_bias=jnp.zeros((self.n_items,), jnp.float32),
            G=_init_mlp(k_g, g_dims),
            Gpr=_init_mlp(k_gpr, gpr_dims),
        )

        if mesh_plan is not None:
            from ganmf_tpu.parallel.distributed import shard_caae_params

            self.params = shard_caae_params(self.params, mesh_plan)
            urm = mesh_plan.put(urm, mesh_plan.urm)

        m_batch_eff = int(min(m_batch, self.n_users))
        start_epoch = self.resume_from_checkpoint()  # also restores _epoch_key

        def epoch_fn(epoch):
            self._epoch_key, sub = jax.random.split(self._epoch_key)
            self.params = caae_epoch(
                self.params, urm, inter_users, inter_items, inter_weight, sub,
                jnp.float32(lr), jnp.float32(beta), jnp.float32(lmbda), jnp.float32(S),
                d_bsize=int(d_bsize), n_d_chunks=n_d_chunks,
                d_steps=int(d_steps), g_steps=int(g_steps), gpr_steps=int(gpr_steps),
                m_batch=m_batch_eff, n_samples=n_samples, d_scatter=d_scatter,
            )
            self._score_cache = None

        self._score_cache = None
        result = self._run_training_loop(
            epochs, validation_evaluator, validation_set, sample_every,
            allow_worse, freq, list(metrics), after, epoch_fn, start_epoch=start_epoch,
        )
        self._invalidate_device_cache()
        return result

    # -- crash resume (full training state; plain SGD, no optimizer state) -----
    def _checkpoint_state(self):
        return {"params": self.params, "epoch_key": self._epoch_key}

    def _restore_checkpoint_state(self, state):
        from ganmf_tpu.models.gan_base import coerce_pytree

        self.params = coerce_pytree(self.params, state["params"])
        self._epoch_key = jnp.asarray(state["epoch_key"])

    def _on_params_loaded(self):
        self._score_cache = None

    def score_device(self, user_ids: jnp.ndarray) -> jnp.ndarray:
        if getattr(self, "_score_cache", None) is None:
            self._score_cache = _autoencode(self.params.G, self.device_urm().dense)
        return jnp.take(self._score_cache, user_ids, axis=0)
