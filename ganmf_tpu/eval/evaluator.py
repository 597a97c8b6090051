"""Holdout top-K ranking evaluator.

API- and protocol-compatible rebuild of the reference evaluator
(Base/Evaluation/Evaluator.py): users with >= minRatingsPerUser test
interactions are scored in blocks, seen items are masked out, rankings are
truncated per cutoff and ~20 metrics are accumulated. Unlike the reference,
scoring + ranking + per-user metrics run as one jitted device program per
block (ganmf_tpu.eval.metrics.evaluate_batch); only finalization runs on
host.

Returns the same (results_dict, results_string) pair with identical metric
ordering and formatting (Evaluator.py:95-110, 362-414).
"""

from __future__ import annotations

import functools
import time
from typing import Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sps

from ganmf_tpu.data.device import padded_rows_dense
from ganmf_tpu.eval.metrics import (
    METRIC_ORDER,
    SCALAR_FIELDS,
    evaluate_batch,
    evaluate_batch_from_topk,
    finalize_counter_metrics,
    item_novelty_terms,
    normalized_popularity,
)

from ganmf_tpu.utils.debug import debug_enabled as _debug_enabled

@functools.partial(jax.jit, static_argnames=("cutoffs",))
def _diversity_block(M_dev, top_idx, top_val, valid, cutoffs):
    """Per-cutoff intra-list diversity sums for one user block (vectorized
    equivalent of the reference's per-user/per-position python loop,
    metrics.py:405-458). -inf-scored entries sort to the list tail, so the
    finite prefix of each row is the user's actual recommendation list."""
    finite = jnp.isfinite(top_val)  # [B, K]
    out = []
    for c in cutoffs:
        items = top_idx[:, :c]  # [B, c]
        fin = finite[:, :c]
        L = jnp.sum(fin, axis=1)  # [B]
        # G[b, p, j] = M[items[p], items[j]]
        rows = jnp.take(M_dev, items, axis=0)  # [B, c, I]
        G = jnp.take_along_axis(rows, items[:, None, :], axis=2)  # [B, c, c]
        p_idx = jnp.arange(c)
        pair = (p_idx[:, None] < (L[:, None, None] - 1)) & (p_idx[None, :] < L[:, None, None])
        pair = pair & (p_idx[:, None] != p_idx[None, :])
        total = jnp.sum(jnp.where(pair, G, 0.0), axis=(1, 2))
        denom = (L * (L - 1)).astype(jnp.float32)
        per_user = jnp.where((L > 1) & valid, total / jnp.maximum(denom, 1.0), 0.0)
        out.append(jnp.sum(per_user.astype(jnp.float64)
                           if jax.config.jax_enable_x64 else per_user))
    return jnp.stack(out)


@jax.jit
def _pair_rmse_from_probe(ps, pf, tvals, pvalid):
    """Per-user RMSE from the fused program's test-pair probes: ps[b, p] is
    the masked score at test item p (0 when masked to -inf), pf[b, p] > 0
    iff that score was finite (reference Evaluator.py:298-299 semantics)."""
    fin = pvalid & (pf > 0)
    sq = jnp.where(fin, (ps - tvals) ** 2, 0.0)
    cnt = jnp.sum(fin, axis=1)
    return jnp.where(cnt > 0, jnp.sqrt(jnp.sum(sq, axis=1) / jnp.maximum(cnt, 1.0)), jnp.nan)


def _seen_rows(model, uids: jnp.ndarray, max_len: int = None) -> jnp.ndarray:
    """[B, I] bool seen-mask rows; duck-typed models may only provide the
    dense device_train_mask. ``max_len`` crops the streamed scatter to the
    caller's per-block profile-length bound (see evaluateRecommender's
    length-ordered blocks)."""
    if hasattr(model, "device_seen_rows"):
        try:
            return model.device_seen_rows(uids, max_len=max_len)
        except TypeError:  # duck-typed models without the crop kwarg
            return model.device_seen_rows(uids)
    return jnp.take(model.device_train_mask(), uids, axis=0)


def _pow2_crop(max_needed: int, full: int) -> int:
    """Smallest power-of-two >= max_needed (floor 8), capped at full — the
    per-block gather/scatter width. Quantizing to powers of two bounds the
    number of distinct compiled block programs at log2(L)."""
    m = max(8, int(max_needed))
    return min(int(full), 1 << (m - 1).bit_length())


def get_result_string(results_run: Dict, n_decimals: int = 7) -> str:
    """Reference-identical result formatting (Evaluator.py:95-110)."""
    output = ""
    for cutoff in results_run.keys():
        output += "CUTOFF: {} - ".format(cutoff)
        for metric, value in results_run[cutoff].items():
            output += "{}: {:.{n_decimals}f}, ".format(metric, value, n_decimals=n_decimals)
        output += "\n"
    return output


class _BaseEvaluator:
    EVALUATOR_NAME = "Evaluator_Base_Class"

    def __init__(
        self,
        URM_test,
        cutoff_list: Sequence[int],
        minRatingsPerUser: int = 1,
        exclude_seen: bool = True,
        diversity_object=None,
        ignore_items=None,
        ignore_users=None,
        mesh_plan=None,
    ):
        if isinstance(URM_test, list):
            raise ValueError("List of URM_test not supported")

        # Optional multi-chip plan: each chip ranks its user shard of every
        # block; when items are model-sharded too, ranking goes through the
        # all-gather top-k merge (SURVEY §2.9 "sharded top-K evaluation").
        self._plan = mesh_plan

        self.URM_test = sps.csr_matrix(URM_test).copy()
        self.URM_test.eliminate_zeros()
        self.cutoff_list = list(cutoff_list)
        # ranking length is capped by the item count (argpartition in the
        # reference has the same hard limit)
        self.max_cutoff = min(max(self.cutoff_list), URM_test.shape[1])
        self.minRatingsPerUser = minRatingsPerUser
        self.exclude_seen = exclude_seen
        self.diversity_object = diversity_object
        self._diversity_dev = None

        self.n_users, self.n_items = self.URM_test.shape

        self.ignore_items_flag = ignore_items is not None
        self.ignore_items_ID = np.asarray(ignore_items if ignore_items is not None else [], dtype=np.int64)
        self.ignore_users_ID = np.asarray(ignore_users if ignore_users is not None else [], dtype=np.int64)

        n_ratings = np.ediff1d(self.URM_test.indptr)
        mask = n_ratings >= minRatingsPerUser
        users = np.arange(self.n_users)[mask]
        if len(self.ignore_users_ID):
            users = np.array(sorted(set(users.tolist()) - set(self.ignore_users_ID.tolist())))
        self.usersToEvaluate = list(users)

        # device-resident test ratings in padded-CSR form — O(nnz), not
        # O(U*I): the dense [U, I] test matrix is 14.8 GB at ML-20M scale
        # and would evict the model from HBM. Blocks densify their [B, I]
        # rows on the fly (scatter from the padded arrays).
        from ganmf_tpu.data.device import padded_csr_from_sparse

        self._test_padded = padded_csr_from_sparse(self.URM_test)
        self._n_pos = jnp.asarray(n_ratings.astype(np.int32))

        if len(self.ignore_items_ID):
            ign = jnp.zeros((self.n_items,), dtype=bool).at[jnp.asarray(self.ignore_items_ID)].set(True)
            self._ignore_items_mask = ign
        else:
            self._ignore_items_mask = None

        self._test_pairs = None  # lazy [U, P] padded test (ids, vals, mask)

    def _padded_test_arrays(self):
        """Padded per-user test pairs for the fused path's RMSE gather."""
        if self._test_pairs is None:
            csr = self.URM_test
            U = self.n_users
            nnz = np.diff(csr.indptr)
            P = max(1, int(nnz.max()) if len(nnz) else 1)
            ids = np.zeros((U, P), np.int32)
            vals = np.zeros((U, P), np.float32)
            msk = np.zeros((U, P), bool)
            row_of = np.repeat(np.arange(U), nnz)
            slot = np.arange(csr.nnz, dtype=np.int64) - np.repeat(csr.indptr[:-1], nnz)
            ids[row_of, slot] = csr.indices
            vals[row_of, slot] = csr.data
            msk[row_of, slot] = True
            self._test_pairs = (jnp.asarray(ids), jnp.asarray(vals), jnp.asarray(msk))
        return self._test_pairs

    # -- model interface -----------------------------------------------------

    def _score_block(self, model, user_ids: np.ndarray, max_len: int = None) -> jnp.ndarray:
        """[B, I] device scores with seen/custom-item masking applied."""
        uids = jnp.asarray(user_ids, dtype=jnp.int32)
        if hasattr(model, "score_device"):
            scores = model.score_device(uids)
        else:
            scores = jnp.asarray(
                np.asarray(model._compute_item_score(np.asarray(user_ids)), dtype=np.float32)
            )
        if self.exclude_seen:
            scores = jnp.where(_seen_rows(model, uids, max_len=max_len), -jnp.inf, scores)
        if self._ignore_items_mask is not None:
            scores = jnp.where(self._ignore_items_mask[None, :], -jnp.inf, scores)
        return scores

    # -- candidate restriction hook (negative-sample evaluator) ---------------

    def _restrict_candidates(self, scores: jnp.ndarray, user_ids: np.ndarray) -> jnp.ndarray:
        return scores

    # -- fused ranking path -----------------------------------------------------

    def _can_fuse(self, model) -> bool:
        """MF-family models rank through the fused matmul+top_k+probe
        program (ops/scoring.py). Requires plain holdout semantics (no
        candidate restriction, no mesh, no KNN cold fallback) and built
        factors."""
        return (
            self._plan is None
            and self.diversity_object is None
            and type(self)._restrict_candidates is _BaseEvaluator._restrict_candidates
            and hasattr(model, "_factors_device")
            and getattr(model, "_USER_factors_store", None) is not None
            and getattr(model, "_ITEM_factors_store", None) is not None
            and not getattr(model, "_cold_user_KNN_model_available", False)
            and not getattr(model, "use_bias", False)
        )

    def _can_fuse_sim(self, model) -> bool:
        """Similarity-matrix models (URM[u] @ W or W[u] @ URM) rank through
        the same fused program when their operands are dense on device;
        same holdout-semantics restrictions as _can_fuse."""
        from ganmf_tpu.models.base import (
            ItemSimilarityRecommender,
            UserSimilarityRecommender,
        )

        if (
            self._plan is not None
            or self.diversity_object is not None
            or type(self)._restrict_candidates is not _BaseEvaluator._restrict_candidates
        ):
            return False
        if isinstance(model, (ItemSimilarityRecommender, UserSimilarityRecommender)):
            # check the device-authoritative W first: touching the W_sparse
            # property on such models would materialize the full [I, I]
            # matrix on host just to decide fusibility
            dev_w = getattr(model, "_device_w", None)
            if (dev_w is None or dev_w is False) and getattr(model, "W_sparse", None) is None:
                return False
            return model._w_device() is not False
        return False

    def _fused_block(self, model, uids_np: np.ndarray, max_len: int = None,
                     pair_len: int = None):
        from ganmf_tpu.models import base as base_mod
        from ganmf_tpu.ops.scoring import masked_topk_matmul

        uids = jnp.asarray(uids_np, dtype=jnp.int32)
        # the model builds (rows, right): MF U[u] x V^T, item-based
        # URM[u] x W, user-based W[u] x URM — with the f32 operand split
        # into bf16 planes when the other side is bf16-exact (binary
        # profiles) AND the catalog exceeds base._SIM_SPLIT_MIN_ITEMS (small
        # catalogs keep the bitwise HIGHEST path so exact ties rank
        # identically to recommend())
        rows, right = model._fused_serving_operands(uids, max_len=max_len)
        # item-based models score with exactly the profile that defines
        # "seen": derive the mask from the left operand inside the fused
        # program instead of re-scattering identical [B, I] rows
        mask_from_rows = (
            self.exclude_seen
            and self._ignore_items_mask is None
            and isinstance(model, base_mod.ItemSimilarityRecommender)
            and not isinstance(rows, tuple)
        )
        if mask_from_rows:
            seen = None
        else:
            if self.exclude_seen:
                seen = _seen_rows(model, uids, max_len=max_len)
            else:
                seen = jnp.zeros((len(uids_np), self.n_items), bool)
            if self._ignore_items_mask is not None:
                seen = seen | self._ignore_items_mask[None, :]
            seen = model._fused_exclude_cold(uids, seen)

        ids, tvals, pvalid = self._padded_test_arrays()
        tp = pair_len if pair_len is not None else ids.shape[1]
        pair_ids = jnp.take(ids, uids, axis=0)[:, :tp]
        vals, idx, ps, pf = masked_topk_matmul(
            rows, right, seen, pair_ids, k=self.max_cutoff,
            mask_from_rows=mask_from_rows,
        )
        user_rmse = _pair_rmse_from_probe(
            ps, pf, jnp.take(tvals, uids, axis=0)[:, :tp],
            jnp.take(pvalid, uids, axis=0)[:, :tp]
        )
        return vals, idx, user_rmse

    # -- main entry ------------------------------------------------------------

    def evaluateRecommender(self, recommender_object):
        try:
            return self._evaluate_pass(recommender_object)
        except Exception as err:  # pragma: no cover - HBM-pressure path
            if "RESOURCE_EXHAUSTED" not in str(err):
                raise
            # Device stats stay async through the block loop, so a block OOM
            # can surface only at the FINAL readback — past the per-block
            # degrade catch, with the accumulators poisoned. Drop the
            # rebuildable fused operand caches (the bf16 W planes alone hold
            # [I, I] HBM) and redo the whole pass through the streamed path.
            if getattr(recommender_object, "_device_w_planes", None) is not None:
                recommender_object._device_w_planes = None
            return self._evaluate_pass(recommender_object, allow_fused=False)

    def _evaluate_pass(self, recommender_object, allow_fused: bool = True):
        if self.ignore_items_flag and hasattr(recommender_object, "set_items_to_ignore"):
            recommender_object.set_items_to_ignore(self.ignore_items_ID)

        urm_train = recommender_object.get_URM_train()
        # novelty/popularity depend only on the training URM: cache the host
        # pass and the device transfer across repeated evaluations (the
        # early-stopping loop evaluates every `freq` epochs). get_URM_train()
        # returns a fresh copy per call, so key on the recommender's stable
        # URM_train attribute where it exists; the strong reference makes
        # the identity check sound (no recycled-id false hits).
        key_obj = getattr(recommender_object, "URM_train", None)
        if key_obj is None:
            key_obj = urm_train
        if getattr(self, "_nov_pop_key", None) is not key_obj:
            self._nov_pop = (
                jnp.asarray(item_novelty_terms(urm_train, self.n_items), dtype=jnp.float32),
                jnp.asarray(normalized_popularity(urm_train), dtype=jnp.float32),
            )
            self._nov_pop_key = key_obj
        novelty_terms, pop_norm = self._nov_pop

        # Cap at 4096 rows (score block [B, I] stays ~100s of MB at the
        # reference catalogs); fewer, larger blocks amortize per-dispatch
        # overhead (LastFM's 1884 users fit one block instead of two)
        block_size = int(min(4096, max(1, 1e8 / max(self.n_items, 1))))
        users = np.asarray(self.usersToEvaluate, dtype=np.int64)
        n_eval = len(users)
        # Evaluate users in training-profile-length order: streamed models
        # scatter [B, L]-padded rows per block, and at heavy-tailed shapes
        # the global L is ~15x the mean row length — length-classed blocks
        # crop their gather/scatter width to their own class (power-of-two
        # quantized, so at most log2(L) distinct compiled programs). The
        # accumulated metric sums are evaluation-order independent.
        train_lens = np.ediff1d(urm_train.indptr).astype(np.int64)
        test_lens = np.ediff1d(self.URM_test.indptr).astype(np.int64)
        if n_eval:
            users = users[np.argsort(train_lens[users], kind="stable")]
        if n_eval:
            # equalize blocks to the evaluated-user count: padding is pure
            # wasted compute (LastFM's 1884 users padded to one 4096 block
            # spent 2.2x the needed score/top-K work). Rounded to a lane
            # multiple; per-dataset shapes, so one compile either way.
            n_blocks = -(-n_eval // block_size)
            per_block = -(-n_eval // n_blocks)
            block_size = min(block_size, -(-per_block // 8) * 8)
        if self._plan is not None:
            # shard_map needs the user-block dimension to divide evenly
            shards = self._plan.n_user_shards
            block_size = int(np.ceil(block_size / shards) * shards)
        cutoffs = tuple(self.cutoff_list)

        # Accumulate on device: per-block stats stay async (no host readback
        # inside the loop); one transfer at the end.
        scalar_acc = jnp.zeros((len(cutoffs), len(SCALAR_FIELDS)), dtype=jnp.float32)
        counter_acc = jnp.zeros((len(cutoffs), self.n_items), dtype=jnp.float32)
        diversity_values = [0.0] * len(cutoffs)

        use_fused = allow_fused and (
            self._can_fuse(recommender_object) or self._can_fuse_sim(recommender_object)
        )

        start = 0
        while start < n_eval:
            chunk = users[start : start + block_size]
            pad = block_size - len(chunk)
            uids = np.concatenate([chunk, np.zeros(pad, dtype=np.int64)]) if pad else chunk
            valid = np.concatenate([np.ones(len(chunk), bool), np.zeros(pad, bool)]) if pad else np.ones(len(chunk), bool)

            # per-block crop widths; pad users (valid=False) may exceed the
            # crop — their cropped rows are never counted. Caps are the
            # global max lengths (padded planes are at least that wide;
            # padded_rows_dense ignores crops past its plane width).
            crop_train = _pow2_crop(train_lens[chunk].max(), train_lens.max())
            crop_test = _pow2_crop(test_lens[chunk].max(), test_lens.max())

            uids_j = jnp.asarray(uids, dtype=jnp.int32)
            test_rows = padded_rows_dense(
                self._test_padded, uids_j, self.n_items, max_len=crop_test
            )

            if use_fused:
                try:
                    top_vals, top_idx, user_rmse = self._fused_block(
                        recommender_object, uids,
                        max_len=crop_train, pair_len=crop_test)
                except Exception as err:  # pragma: no cover - HBM-pressure path
                    # the fused ranker holds extra [B, I]/[I, I] operands; at
                    # marginal device memory (e.g. a 2.9 GB device W right
                    # after large trainer buffers) it can OOM where the plain
                    # streamed path still fits — degrade for the rest of
                    # this eval instead of failing it
                    if "RESOURCE_EXHAUSTED" not in str(err):
                        raise
                    use_fused = False
                    continue  # redo this block through the streamed path
                if _debug_enabled() and bool(jnp.isnan(top_vals).any()):
                    raise FloatingPointError(
                        f"NaN model scores in evaluation block starting at user index {start}"
                        " (GANMF_TPU_DEBUG=1)"
                    )
                stats = evaluate_batch_from_topk(
                    top_vals,
                    top_idx,
                    test_rows,
                    jnp.take(self._n_pos, uids_j),
                    jnp.asarray(valid),
                    novelty_terms,
                    pop_norm,
                    user_rmse,
                    cutoffs=cutoffs,
                    max_cutoff=self.max_cutoff,
                )
            else:
                scores = self._score_block(recommender_object, uids, max_len=crop_train)
                scores = self._restrict_candidates(scores, uids)
                if _debug_enabled() and bool(jnp.isnan(scores).any()):
                    raise FloatingPointError(
                        f"NaN model scores in evaluation block starting at user index {start}"
                        " (GANMF_TPU_DEBUG=1)"
                    )

                topk = None
                if self._plan is not None:
                    plan = self._plan
                    test_rows = jax.device_put(test_rows, plan.user_rows)
                    n_model = plan.n_model
                    if (
                        n_model > 1
                        and self.n_items % n_model == 0
                        and self.max_cutoff <= self.n_items // n_model
                    ):
                        # items sharded over the model axis: per-shard top-k +
                        # all-gather merge, exact for k <= shard width
                        from ganmf_tpu.ops.topk import sharded_topk

                        scores = plan.put(scores, plan.urm)
                        topk = sharded_topk(
                            scores, self.max_cutoff, plan, batch_axes=plan.user_axes
                        )
                    else:
                        scores = jax.device_put(scores, plan.user_rows)
                stats = evaluate_batch(
                    scores,
                    test_rows,
                    jnp.take(self._n_pos, uids_j),
                    jnp.asarray(valid),
                    novelty_terms,
                    pop_norm,
                    cutoffs=cutoffs,
                    max_cutoff=self.max_cutoff,
                    topk=topk,
                )
                if self.diversity_object is not None:
                    self._accumulate_diversity(diversity_values, scores, valid, cutoffs)

            scalar_acc = scalar_acc + stats.scalars
            counter_acc = counter_acc + stats.counters

            start += block_size
            # Throttle in-flight dispatch: async blocks each pin [B, I]-scale
            # operands and executable temps in HBM until they execute, and an
            # unbounded queue can exhaust the device at catalog-scale shapes
            # (the accumulator chains every prior block, so this waits for
            # all of them). A handful of blocks in flight keeps the device
            # busy; the sync round trip is microseconds against a block's
            # hundreds of milliseconds of compute.
            if (start // block_size) % 4 == 0:
                jax.block_until_ready(scalar_acc)

        # one packed device->host transfer instead of one per accumulator
        packed = np.asarray(jnp.concatenate([scalar_acc.ravel(), counter_acc.ravel()]))
        ns = scalar_acc.shape[0] * scalar_acc.shape[1]
        return self._finalize(
            packed[:ns].astype(np.float64).reshape(scalar_acc.shape),
            packed[ns:].astype(np.float64).reshape(counter_acc.shape),
            diversity_values,
            n_eval,
            recommender_object,
        )

    def _accumulate_diversity(self, diversity_values, scores, valid, cutoffs):
        """Intra-list diversity from a user-provided item diversity matrix
        (metrics.py:405-458), as one jitted device program per block.

        Reference semantics (Diversity_similarity.add_recommendations):
        total = sum over list positions p in [0, L-2] of the similarity of
        item p to every *other* recommended item (all j != p, including
        j > p and j < p), normalized by L*(L-1)."""
        if self._diversity_dev is None:
            M = self.diversity_object
            dense = M.toarray() if sps.issparse(M) else np.asarray(M)
            self._diversity_dev = jnp.asarray(dense, dtype=jnp.float32)
        top_val, top_idx = jax.lax.top_k(scores, self.max_cutoff)
        sums = _diversity_block(
            self._diversity_dev, top_idx, top_val, jnp.asarray(valid), tuple(cutoffs)
        )
        for ci in range(len(cutoffs)):
            diversity_values[ci] += float(sums[ci])

    def _finalize(self, scalar_acc, counter_acc, diversity_values, n_eval, recommender_object):
        results_dict: Dict[int, Dict[str, float]] = {}
        n_ignore_items = len(self.ignore_items_ID)
        n_ignore_users = len(self.ignore_users_ID)

        for ci, cutoff in enumerate(self.cutoff_list):
            sums = dict(zip(SCALAR_FIELDS, scalar_acc[ci]))
            counters = finalize_counter_metrics(
                counter_acc[ci],
                n_users_eval=n_eval,
                cutoff=cutoff,
                n_items=self.n_items,
                n_ignore_items=n_ignore_items,
                ignore_items=self.ignore_items_ID,
            )

            res: Dict[str, float] = {}
            for metric in METRIC_ORDER:
                if metric == "F1":
                    res[metric] = 0.0
                elif metric in sums:
                    res[metric] = sums[metric] / n_eval if n_eval else 0.0
                elif metric == "COVERAGE_USER":
                    res[metric] = (sums["_COVERED_USERS"] / (self.n_users - n_ignore_users)) if self.n_users else 0.0
                elif metric in counters:
                    res[metric] = counters[metric]
                if metric == "NDCG" and self.diversity_object is not None:
                    # DIVERSITY_SIMILARITY sits between RMSE-group metrics in
                    # the reference enum; inserted in its enum position below.
                    pass
            if self.diversity_object is not None:
                # insert in enum order: after AVERAGE_POPULARITY
                ordered = {}
                for k, v in res.items():
                    ordered[k] = v
                    if k == "AVERAGE_POPULARITY":
                        ordered["DIVERSITY_SIMILARITY"] = diversity_values[ci] / n_eval if n_eval else 0.0
                res = ordered

            precision_, recall_ = res["PRECISION"], res["RECALL"]
            if precision_ + recall_ != 0:
                res["F1"] = 2 * (precision_ * recall_) / (precision_ + recall_)

            results_dict[cutoff] = res

        if n_eval == 0:
            print("WARNING: No users had a sufficient number of relevant items")

        if self.ignore_items_flag and hasattr(recommender_object, "reset_items_to_ignore"):
            recommender_object.reset_items_to_ignore()

        return results_dict, get_result_string(results_dict)


class EvaluatorHoldout(_BaseEvaluator):
    """Evaluates on every item (reference EvaluatorHoldout, Evaluator.py:214)."""

    EVALUATOR_NAME = "EvaluatorHoldout"


class EvaluatorNegativeItemSample(_BaseEvaluator):
    """Ranks only each user's test items plus a fixed negative sample
    (reference Evaluator.py:419-620)."""

    EVALUATOR_NAME = "EvaluatorNegativeItemSample"

    def __init__(self, URM_test, URM_test_negative, cutoff_list, **kwargs):
        super().__init__(URM_test, cutoff_list, **kwargs)
        negative = sps.csr_matrix(URM_test_negative)
        candidates = (self.URM_test + negative).tocsr()
        candidates.data = np.ones_like(candidates.data)
        self._candidate_mask = jnp.asarray(
            np.asarray(candidates.todense()) != 0
        )

    def _restrict_candidates(self, scores: jnp.ndarray, user_ids: np.ndarray) -> jnp.ndarray:
        mask = jnp.take(self._candidate_mask, jnp.asarray(user_ids, dtype=jnp.int32), axis=0)
        return jnp.where(mask, scores, -jnp.inf)
