"""Vectorized ranking metrics.

One jitted device program evaluates a whole batch of users across all
cutoffs at once, replacing the reference's per-user python loop
(reference: Base/Evaluation/Evaluator.py:291-335). Metric definitions
follow Base/Evaluation/metrics.py exactly, including:

  * AP with min(#positives, list length) denominator (metrics.py:681-690)
  * NDCG with 2^rel - 1 gains and the ideal DCG computed from the test
    ratings truncated at the recommended-list length (metrics.py:693-722)
  * ROC-AUC over the recommended list only, returning 1.0 when the list
    contains no negatives (metrics.py:576-592)
  * HIT_RATE accumulated as hits-per-user (Evaluator.py:319)
  * Novelty / AveragePopularity / Gini / Shannon / Herfindahl /
    MeanInterList / Coverage from global recommendation counters
    (metrics.py:30-570)

The scalar-per-user metrics are summed on device; counter metrics update a
per-cutoff item counter with a scatter-add. Finalization (division by user
count, Gini sort, entropy, F1) happens once on host in the evaluator.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

#: Metric presentation order = the reference's EvaluatorMetrics enum order
#: (Base/Evaluation/Evaluator.py:20-41); DIVERSITY_SIMILARITY is inserted
#: before DIVERSITY_MEAN_INTER_LIST only when a diversity object is given.
METRIC_ORDER = [
    "ROC_AUC",
    "PRECISION",
    "PRECISION_RECALL_MIN_DEN",
    "RECALL",
    "MAP",
    "MRR",
    "NDCG",
    "F1",
    "HIT_RATE",
    "ARHR",
    "RMSE",
    "NOVELTY",
    "AVERAGE_POPULARITY",
    "DIVERSITY_MEAN_INTER_LIST",
    "DIVERSITY_HERFINDAHL",
    "COVERAGE_ITEM",
    "COVERAGE_USER",
    "DIVERSITY_GINI",
    "SHANNON_ENTROPY",
]

# indices of the scalar sums produced per cutoff by the batch kernel
SCALAR_FIELDS = [
    "ROC_AUC",
    "PRECISION",
    "PRECISION_RECALL_MIN_DEN",
    "RECALL",
    "MAP",
    "MRR",
    "NDCG",
    "HIT_RATE",
    "ARHR",
    "RMSE",
    "NOVELTY",
    "AVERAGE_POPULARITY",
    "_COVERED_USERS",
]


class BatchStats(NamedTuple):
    """Per-cutoff accumulators for one user batch."""

    scalars: jnp.ndarray  # [n_cutoffs, len(SCALAR_FIELDS)] summed over users
    counters: jnp.ndarray  # [n_cutoffs, n_items] recommendation counts


@functools.partial(jax.jit, static_argnames=("cutoffs", "max_cutoff"))
def evaluate_batch(
    scores: jnp.ndarray,  # [B, I] seen-masked model scores (-inf = removed)
    test_ratings: jnp.ndarray,  # [B, I] test interaction values (0 = none)
    n_pos: jnp.ndarray,  # [B] number of test interactions per user
    user_valid: jnp.ndarray,  # [B] bool, False for padding rows
    item_novelty: jnp.ndarray,  # [I] -log2(pop/n_inter)/I, 0 for cold items
    pop_normalized: jnp.ndarray,  # [I] popularity / max popularity
    cutoffs: Tuple[int, ...],
    max_cutoff: int,
    topk=None,
) -> BatchStats:
    K = max_cutoff

    if topk is None:
        top_vals, top_idx = jax.lax.top_k(scores, K)
    else:
        # Precomputed ranking (e.g. ops.topk.sharded_topk's cross-shard
        # merge when scores are item-sharded over a mesh).
        top_vals, top_idx = topk

    # RMSE over test items is cutoff-independent (Evaluator.py:298-299)
    test_mask = (test_ratings != 0).astype(jnp.float32)
    finite_scores = jnp.isfinite(scores)
    fin = test_mask * finite_scores.astype(jnp.float32)
    sq_err = jnp.where(finite_scores, (scores - test_ratings) ** 2, 0.0) * fin
    fin_cnt = jnp.sum(fin, axis=1)
    user_rmse = jnp.where(fin_cnt > 0, jnp.sqrt(jnp.sum(sq_err, axis=1) / jnp.maximum(fin_cnt, 1.0)), jnp.nan)

    return _evaluate_core(
        top_vals, top_idx, test_ratings, n_pos, user_valid, item_novelty,
        pop_normalized, user_rmse, cutoffs, K,
    )


@functools.partial(jax.jit, static_argnames=("cutoffs", "max_cutoff"))
def evaluate_batch_from_topk(
    top_vals: jnp.ndarray,  # [B, K] ranked scores (from the fused scorer)
    top_idx: jnp.ndarray,  # [B, K] ranked item ids
    test_ratings: jnp.ndarray,  # [B, I]
    n_pos: jnp.ndarray,
    user_valid: jnp.ndarray,
    item_novelty: jnp.ndarray,
    pop_normalized: jnp.ndarray,
    user_rmse: jnp.ndarray,  # [B] precomputed (per-pair gather path)
    cutoffs: Tuple[int, ...],
    max_cutoff: int,
) -> BatchStats:
    """Metrics from a precomputed ranking (ops.scoring.masked_topk_matmul
    ranks and probes the [B, I] scores; only [B, k] and [B, P] reach this
    program)."""
    return _evaluate_core(
        top_vals, top_idx, test_ratings, n_pos, user_valid, item_novelty,
        pop_normalized, user_rmse, cutoffs, max_cutoff,
    )


def _evaluate_core(
    top_vals, top_idx, test_ratings, n_pos, user_valid, item_novelty,
    pop_normalized, user_rmse, cutoffs, K,
) -> BatchStats:
    I = test_ratings.shape[1]
    valid = jnp.isfinite(top_vals)  # -inf entries are dropped from rankings

    rel_ratings = jnp.take_along_axis(test_ratings, top_idx, axis=1)  # [B, K]
    rel = (rel_ratings != 0).astype(jnp.float32)

    # per-user ideal relevance ordering for NDCG (top-K largest test ratings)
    ideal_ratings, _ = jax.lax.top_k(test_ratings, K)  # [B, K]

    positions = jnp.arange(K, dtype=jnp.float32)
    log_discount = jnp.log(positions + 2.0)  # natural log as in dcg()

    n_pos_f = n_pos.astype(jnp.float32)
    uvalid = user_valid.astype(jnp.float32)

    per_cutoff_scalars = []
    per_cutoff_counters = []

    for c in cutoffs:
        m = valid & (jnp.arange(K) < c)  # [B, K] effective-list mask
        mf = m.astype(jnp.float32)
        relm = rel * mf
        length = jnp.sum(mf, axis=1)  # = min(c, n_valid)
        has_list = (length > 0).astype(jnp.float32)

        hits = jnp.sum(relm, axis=1)
        precision = jnp.where(length > 0, hits / jnp.maximum(length, 1.0), 0.0)
        min_den = jnp.minimum(n_pos_f, length)
        prec_min = jnp.where(length > 0, hits / jnp.maximum(min_den, 1.0), 0.0)
        recall = hits / jnp.maximum(n_pos_f, 1.0)

        cum_rel = jnp.cumsum(relm, axis=1)
        p_at_k = relm * cum_rel / (positions + 1.0)
        ap = jnp.where(length > 0, jnp.sum(p_at_k, axis=1) / jnp.maximum(min_den, 1.0), 0.0)

        rr = jnp.max(relm / (positions + 1.0), axis=1)
        arhr = jnp.sum(relm / (positions + 1.0), axis=1)

        # AUC within the recommended list (metrics.py:576-592)
        negm = mf * (1.0 - rel)
        n_neg = jnp.sum(negm, axis=1)
        suffix_neg = n_neg[:, None] - jnp.cumsum(negm, axis=1)
        auc_num = jnp.sum(relm * suffix_neg, axis=1)
        auc = jnp.where(
            n_neg == 0,
            1.0,
            jnp.where(hits > 0, auc_num / jnp.maximum(hits * n_neg, 1.0), 0.0),
        )

        gains = (jnp.power(2.0, rel_ratings) - 1.0) * mf
        rank_dcg = jnp.sum(gains / log_discount, axis=1)
        ideal_mask = (jnp.arange(K)[None, :] < length[:, None]).astype(jnp.float32)
        ideal_gains = (jnp.power(2.0, ideal_ratings) - 1.0) * ideal_mask
        ideal_dcg = jnp.sum(ideal_gains / log_discount, axis=1)
        ndcg = jnp.where(rank_dcg == 0.0, 0.0, rank_dcg / jnp.maximum(ideal_dcg, 1e-30))

        novelty = jnp.sum(jnp.take(item_novelty, top_idx) * mf, axis=1)
        avg_pop = jnp.where(
            length > 0,
            jnp.sum(jnp.take(pop_normalized, top_idx) * mf, axis=1) / jnp.maximum(length, 1.0),
            0.0,
        )

        scal = jnp.stack(
            [auc, precision, prec_min, recall, ap, rr, ndcg, hits, arhr, user_rmse, novelty, avg_pop, has_list],
            axis=1,
        )  # [B, n_fields]
        # Padding rows are zeroed with where() (not multiplication) so a NaN
        # user_rmse in a padding row cannot poison the batch sums.
        per_cutoff_scalars.append(jnp.sum(jnp.where(uvalid[:, None] > 0, scal, 0.0), axis=0))

        counter = jnp.zeros((I,), jnp.float32).at[top_idx.reshape(-1)].add(
            (mf * uvalid[:, None]).reshape(-1)
        )
        per_cutoff_counters.append(counter)

    return BatchStats(jnp.stack(per_cutoff_scalars), jnp.stack(per_cutoff_counters))


def finalize_counter_metrics(counter: np.ndarray, n_users_eval: int, cutoff: int, n_items: int,
                             n_ignore_items: int = 0, ignore_items: np.ndarray = None):
    """Host-side finalization of the counter-based global metrics.

    Follows the get_metric_value implementations in metrics.py:
    Gini_Diversity(:160-178), Shannon_Entropy(:260-280),
    Diversity_Herfindahl(:210-224), Coverage_Item(:45-46),
    Diversity_MeanInterList(:536-551).
    """
    counter = np.asarray(counter, dtype=np.float64)
    if ignore_items is not None and len(ignore_items):
        keep = np.ones(len(counter), dtype=bool)
        keep[np.asarray(ignore_items, dtype=np.int64)] = False
    else:
        keep = np.ones(len(counter), dtype=bool)

    out = {}

    # Coverage_Item
    out["COVERAGE_ITEM"] = (counter > 0).sum() / (n_items - n_ignore_items)

    # Herfindahl (zero-count items kept, only ignored items removed)
    kept = counter[keep]
    total = kept.sum()
    out["DIVERSITY_HERFINDAHL"] = (1.0 - np.sum((kept / total) ** 2)) if total != 0 else np.nan

    # Gini diversity and Shannon entropy drop zero-occurrence items
    nz = kept[kept > 0]
    if len(nz):
        srt = np.sort(nz)
        n = len(srt)
        index = np.arange(1, n + 1)
        out["DIVERSITY_GINI"] = 2 * np.sum((n + 1 - index) / (n + 1) * srt / srt.sum())
        p = nz / nz.sum()
        out["SHANNON_ENTROPY"] = -np.sum(p * np.log2(p))
    else:
        out["DIVERSITY_GINI"] = np.nan
        out["SHANNON_ENTROPY"] = np.nan

    # MeanInterList diversity (full counter, no ignore filter in reference)
    if n_users_eval == 0:
        out["DIVERSITY_MEAN_INTER_LIST"] = 1.0
    else:
        cooc = np.sum(counter**2) - n_users_eval * cutoff
        pairs = n_users_eval**2 - n_users_eval
        out["DIVERSITY_MEAN_INTER_LIST"] = (pairs - cooc / cutoff) / pairs if pairs else 0.0

    return out


def item_novelty_terms(urm_train, n_items: int) -> np.ndarray:
    """Per-item novelty contribution -log2(pop/total)/n_items, 0 for cold
    items (metrics.py:298-341)."""
    pop = np.ediff1d(urm_train.tocsc().indptr).astype(np.float64)
    total = pop.sum()
    out = np.zeros(n_items, dtype=np.float64)
    warm = pop > 0
    out[warm] = -np.log2(pop[warm] / total) / n_items
    return out


def normalized_popularity(urm_train) -> np.ndarray:
    """Popularity normalized by the most popular item (metrics.py:355-374)."""
    pop = np.ediff1d(urm_train.tocsc().indptr).astype(np.float64)
    mx = pop.max() if pop.size else 1.0
    return pop / (mx if mx > 0 else 1.0)
