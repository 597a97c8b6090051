"""Explain the ItemKNN non-cosine NDCG deltas in PARITY.md.

Hypothesis: the published test_results.txt rows for the non-cosine
ItemKNN configs were produced by a snapshot-era evaluator whose ndcg()
computed the ideal DCG over ALL of a user's test ratings, i.e. without
the `[:len(ranked_list)]` truncation the current reference applies
(Base/Evaluation/metrics.py:708). This script retrains each config with
the committed best params, reproduces the full published metric rows,
and computes NDCG both ways:

  NDCG_new  = dcg(ranked_rel[:c]) / dcg(sorted_test_rel[:c])   (current)
  NDCG_old  = dcg(ranked_rel[:c]) / dcg(sorted_test_rel)       (untruncated)

If every rank-derived metric (PRECISION/RECALL/MAP/MRR/HIT_RATE/ARHR)
matches the published row to ~1e-6 while published NDCG matches NDCG_old,
the rankings are identical and the published NDCG values are artifact-era.

Usage: python scripts/ndcg_archaeology.py [config ...]
"""

import os
import pickle
import re
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp

from ganmf_tpu.data.splits import load_reference_splits
from ganmf_tpu.eval.evaluator import EvaluatorHoldout
from ganmf_tpu.models.itemknn import ItemKNNCFRecommender

REF = os.environ.get("GANMF_REF", "/root/reference")
SIMS = ("asymmetric", "dice", "euclidean", "jaccard", "tversky")
DATASETS = ("1M", "hetrec2011")
CUTOFFS = (5, 10, 20, 50)
RANK_METRICS = ("PRECISION", "RECALL", "MAP", "MRR", "HIT_RATE", "ARHR",
                "PRECISION_RECALL_MIN_DEN", "ROC_AUC")


def parse_results(path):
    rows = {}
    for line in open(path):
        m = re.match(r"CUTOFF: (\d+) - (.*)", line.strip())
        if not m:
            continue
        c = int(m.group(1))
        rows[c] = {
            k: float(v) for k, v in re.findall(r"(\w+): ([-\d.a-z]+),", m.group(2))
        }
    return rows


def dcg(scores):
    return np.sum((np.power(2.0, scores) - 1) / np.log(np.arange(len(scores)) + 2.0))


def ndcg_both_ways(model, evaluator, test_csr):
    """Per-cutoff mean NDCG under the truncated (current reference) and
    untruncated (snapshot-era) ideal-DCG conventions, over the evaluator's
    user set using the model's actual rankings."""
    users = np.asarray(evaluator.usersToEvaluate)
    K = max(CUTOFFS)
    sums_new = {c: 0.0 for c in CUTOFFS}
    sums_old = {c: 0.0 for c in CUTOFFS}
    block = 512
    for s in range(0, len(users), block):
        chunk = users[s : s + block]
        scores = evaluator._score_block(model, chunk)
        import jax.lax

        vals, idx = jax.lax.top_k(scores, K)
        vals, idx = np.asarray(vals), np.asarray(idx)
        for b, u in enumerate(chunk):
            t0, t1 = test_csr.indptr[u], test_csr.indptr[u + 1]
            it2rel = dict(zip(test_csr.indices[t0:t1], test_csr.data[t0:t1]))
            ranked = idx[b][np.isfinite(vals[b])]
            rel = np.asarray([it2rel.get(i, 0.0) for i in ranked], np.float32)
            ideal_all = np.sort(test_csr.data[t0:t1])[::-1]
            for c in CUTOFFS:
                rank_dcg = dcg(rel[:c])
                if rank_dcg == 0.0:
                    continue
                L = len(ranked[:c])
                sums_new[c] += rank_dcg / dcg(ideal_all[:L])
                sums_old[c] += rank_dcg / dcg(ideal_all)
    n = len(users)
    return {c: sums_new[c] / n for c in CUTOFFS}, {c: sums_old[c] / n for c in CUTOFFS}


def run(sim, dataset):
    name = f"ItemKNNCFRecommender_{sim}_{dataset}"
    params = pickle.load(open(f"{REF}/experiments/{name}/best_params.pkl", "rb"))
    published = parse_results(f"{REF}/test_results/{name}/test_results.txt")

    ss = load_reference_splits(dataset)
    train = (ss.train + ss.validation).tocsr()
    model = ItemKNNCFRecommender(train)
    model.fit(**params)
    evaluator = EvaluatorHoldout(ss.test, list(CUTOFFS))
    ours, _ = evaluator.evaluateRecommender(model)

    ndcg_new, ndcg_old = ndcg_both_ways(model, evaluator, ss.test.tocsr())

    print(f"\n=== {name} (topK={params.get('topK')}) ===")
    max_rank_delta = 0.0
    for mname in RANK_METRICS:
        d = max(abs(ours[c][mname] - published[c][mname]) for c in CUTOFFS)
        max_rank_delta = max(max_rank_delta, d)
        print(f"  {mname}: max |delta| {d:.2e}")
    for c in CUTOFFS:
        pub = published[c]["NDCG"]
        print(
            f"  cutoff {c}: published NDCG {pub:.7f} | ours(new) {ndcg_new[c]:.7f} "
            f"(d={ndcg_new[c]-pub:+.4f}) | ours(old/untruncated) {ndcg_old[c]:.7f} "
            f"(d={ndcg_old[c]-pub:+.4f})"
        )
    return max_rank_delta, {c: ndcg_old[c] - published[c]["NDCG"] for c in CUTOFFS}


if __name__ == "__main__":
    targets = sys.argv[1:] or [f"{s}_{d}" for d in DATASETS for s in SIMS]
    for t in targets:
        sim, dataset = t.rsplit("_", 1)
        run(sim, dataset)
