#!/usr/bin/env python3
"""Online-serving latency rows (VERDICT r3 #9): p50/p99 of single-user and
32-user `recommend()` dispatch per model family on all three reference
datasets. serve_all covers batch export (PERF.md); this measures the
interactive path a live service would hit.

Records PERF rows "Latency[<ds>] <family> recommend b=<n>" with p50 as the
row time and p99 in the note.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np


N_SINGLE = 200
N_BATCH = 100


def _percentiles(samples):
    a = np.asarray(samples)
    return float(np.percentile(a, 50)), float(np.percentile(a, 99))


def _record(name, seconds, note=""):
    import perf_report

    perf_report.record(perf_report.load_rows(), name, seconds, note)


def measure(model, family, ds, n_users):
    rng = np.random.RandomState(0)
    # warmup both shapes (compile)
    model.recommend(int(rng.randint(n_users)), cutoff=20, remove_seen_flag=True)
    model.recommend(rng.randint(0, n_users, size=32), cutoff=20, remove_seen_flag=True)

    lats = []
    for _ in range(N_SINGLE):
        u = int(rng.randint(n_users))
        t0 = time.time()
        model.recommend(u, cutoff=20, remove_seen_flag=True)
        lats.append(time.time() - t0)
    p50, p99 = _percentiles(lats)
    _record(f"Latency[{ds}] {family} recommend b=1", p50, f"p99 {p99*1e3:.1f} ms, n={N_SINGLE}")

    lats = []
    for _ in range(N_BATCH):
        uids = rng.randint(0, n_users, size=32)
        t0 = time.time()
        model.recommend(uids, cutoff=20, remove_seen_flag=True)
        lats.append(time.time() - t0)
    p50, p99 = _percentiles(lats)
    _record(f"Latency[{ds}] {family} recommend b=32", p50,
            f"p99 {p99*1e3:.1f} ms ({32/p50:,.0f} users/s at p50), n={N_BATCH}")


def main(datasets):
    from ganmf_tpu.data import load_reference_splits
    from ganmf_tpu.models import GANMF, ItemKNNCFRecommender, PureSVDRecommender

    for ds in datasets:
        splits = load_reference_splits(ds)
        train = splits.train
        n_users = train.shape[0]

        svd = PureSVDRecommender(train)
        svd.fit(num_factors=50)
        measure(svd, "MF", ds, n_users)
        del svd

        knn = ItemKNNCFRecommender(train)
        knn.fit(topK=300, shrink=0, similarity="cosine")
        measure(knn, "ItemKNN", ds, n_users)
        del knn

        gan = GANMF(train, mode="user", seed=1337, is_experiment=True)
        gan.fit(epochs=2, num_factors=64, emb_dim=128, batch_size=256)
        measure(gan, "GANMF", ds, n_users)
        del gan


if __name__ == "__main__":
    main(sys.argv[1:] or ["1M", "LastFM", "hetrec2011"])
