#!/usr/bin/env python3
"""Measure steady-state training/eval performance on the GPU and write
``chiprun_out/perf_report.{json,md}``. Baseline wall-clock numbers come
from the reference's committed test_results timing strings corrected for
the timedelta unit bug (BASELINE.md).

    python scripts/perf_report.py [1M|LastFM ...]   # measure and merge rows
    python scripts/perf_report.py --render           # re-render the .md
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

from _timing import atomic_json_dump, epoch_time, require_card, timeit

OUT_DIR = "chiprun_out"
ROWS_JSON = os.path.join(OUT_DIR, "perf_report.json")
ROWS_MD = os.path.join(OUT_DIR, "perf_report.md")


# -- roofline model -------------------------------------------------------------
# Dominant-term analytic work per row, against the card's published peaks,
# so "fast" is falsifiable. Keyed by jax's device_kind; a card missing here
# is an error, not a default. Matmul rows are compared with the TF32 rate
# (f32 matmuls at default precision), bandwidth rows with device memory.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "matmul_flops": 495e12,  # dense TF32 tensor-core rate
        "mem_bytes": 3.35e12,
        "source": "NVIDIA H100 SXM data sheet (dense rates at the 700 W limit)",
    },
}


def peaks():
    import jax

    kind = jax.devices()[0].device_kind
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for device_kind {kind!r}; add them to PEAKS")
    return PEAKS[kind]


SHAPES = {  # dataset -> (U, I, train_nnz)
    "1M": (6040, 3706, 799983),
    "LastFM": (1884, 17632, 74238),
    "hetrec2011": (2113, 10109, 684308),
    # synthetic ML-20M stand-in (scripts/synthesize_ml20m.py), split by the
    # repo's own reader; nnz from the committed 20M_URM_train build
    "20M": (138493, 26744, 15107163),
}


def _flops_str(flops, seconds):
    rate = flops / seconds
    return f"{rate/1e12:.2f} TFLOP/s ({100*rate/peaks()['matmul_flops']:.1f}% TF32 peak)"


def _bytes_str(nbytes, seconds):
    rate = nbytes / seconds
    return f"{rate/1e9:.0f} GB/s ({100*rate/peaks()['mem_bytes']:.0f}% of device memory bandwidth)"


def _work(name):
    """Analytic dominant-term work for a PERF row: ("flops"|"bytes", amount)
    or None. Matmul counts are forward FLOPs x3 for trained passes
    (fwd:bwd ~ 1:2); bandwidth-bound rows use the row-traffic model.
    Approximations are deliberate: order-of-magnitude headroom, not a
    simulator."""
    ds = None
    for key in SHAPES:
        if f"[{key}]" in name:
            ds = key
    if ds is None:
        return None
    U, I, nnz = SHAPES[ds]

    if name.startswith("GANMF[20M]"):
        B, K, E = 512, 64, 128  # the scale-proof config (scripts/scale20m.py)
        nb = -(-U // B)
        per_batch = 2 * B * K * I + 8 * B * I * E
        return ("flops", nb * 2 * 3 * per_batch)
    if name.startswith("GANMF["):
        B, K, E = 64, 250, 992
        nb = -(-U // B)
        per_batch = 2 * B * K * I + 8 * B * I * E  # generator + AE on real+fake
        return ("flops", nb * 2 * 3 * per_batch)
    if name.startswith("DisGANMF["):
        B, K, H = 128, 64, 256
        nb = -(-U // B)
        per_batch = 2 * B * K * I + 4 * B * (I + 1) * H  # gen + MLP-D real+fake
        return ("flops", nb * 2 * 3 * per_batch)
    if name.startswith("CFGAN["):
        B, G_H, D_H = 128, 256, 64
        nb = -(-U // B)
        per_batch = 4 * B * G_H * I + 8 * B * I * D_H
        return ("flops", nb * 2 * 3 * per_batch)
    if name.startswith("CAAE["):
        # gather/scatter-bound D phase + table build; row-traffic model
        B, K, d_steps = 4096, 50, 2
        n_chunks = -(-nnz // B)
        dphase = d_steps * n_chunks * 2 * (3 * B * (K + 1) * 4 * 2)
        tables = 10 * U * I * 4  # autoencodes + softmax + cdf passes
        return ("bytes", dphase + tables)
    if name.startswith("IALS["):
        K = 50
        return ("flops", 4 * U * I * K * K)
    if name.startswith("SLIM-BPR["):
        # U BPR samples, each streaming ~4 row-passes of the dense [I] row
        return ("bytes", U * I * 4 * 4)
    if name.startswith("PureSVD["):
        k = 60  # K + oversampling
        return ("flops", 8 * U * I * k)
    if name.startswith("ItemKNN["):
        return ("flops", 2 * U * I * I)
    if name.startswith("P3alpha["):
        return ("flops", 2 * U * I * I)
    if name.startswith("EASE-R["):
        return ("flops", 2 * U * I * I + I**3 // 3 + 2 * I**3)
    if "similarity-family" in name:
        # matmul-bound: URM rows x dense [I, I] W at HIGHEST precision
        return ("flops", 2 * U * I * I)
    if name.startswith("Eval["):
        # ranking-bound: model scores + masks stream through device memory
        return ("bytes", 2 * U * I * 4)
    return None


def roofline(name, seconds):
    w = _work(name)
    if w is None:
        return ""
    kind, amount = w
    return _flops_str(amount, seconds) if kind == "flops" else _bytes_str(amount, seconds)


def plausible(name, seconds):
    """False when a timing implies running above the card's peak: such a
    value is a measurement fault and is flagged, never recorded as is."""
    w = _work(name)
    if w is None:
        return True
    kind, amount = w
    peak = peaks()["matmul_flops" if kind == "flops" else "mem_bytes"]
    return amount / max(seconds, 1e-12) <= peak


def load_rows():
    if os.path.isfile(ROWS_JSON):
        return {k: tuple(v) for k, v in json.load(open(ROWS_JSON)).items()}
    return {}


def record(rows, name, seconds, note=""):
    """Merge one row into the report and re-render it (a killed run keeps
    its finished rows)."""
    if not plausible(name, seconds):
        note = (note + " " if note else "") + "IMPLAUSIBLE (>peak) — remeasure"
    rows[name] = (seconds, note)
    print(f"{name:45s} {seconds*1e3:10.2f} ms  {note}", flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    atomic_json_dump({k: list(v) for k, v in rows.items()}, ROWS_JSON)
    _write(rows)


def main(datasets=("1M", "LastFM")):
    import jax
    import jax.numpy as jnp

    from ganmf_tpu.data import load_reference_splits
    from ganmf_tpu.eval import EvaluatorHoldout
    from ganmf_tpu.models import (
        CAAE, CFGAN, GANMF, DisGANMF, IALSRecommender, ItemKNNCFRecommender,
        P3alphaRecommender, PureSVDRecommender, SLIM_BPR, TopPop,
    )
    from ganmf_tpu.models.extras import EASE_R_Recommender

    # merge into prior measurements so partial re-runs (one dataset, one
    # volatile row) update rows in place instead of discarding the rest
    rows = load_rows()

    def record_row(name, seconds, note=""):
        record(rows, name, seconds, note)

    for ds in datasets:
        splits = load_reference_splits(ds)
        train = splits.train
        U, I = train.shape

        # -- GAN trainers: the median steady epoch of the jitted epoch
        # program fit() runs (scripts/_timing.py)
        cfg = dict(num_factors=250, emb_dim=min(992, int(I * 0.75)), batch_size=64)
        t = epoch_time(lambda: GANMF(train, mode="user", seed=1337, is_experiment=True), cfg)
        record_row(f"GANMF[{ds}] steady epoch (K=250, b=64)", t,
               "ref ~3.64 s/epoch (ML-1M GPU)" if ds == "1M" else "")

        t = epoch_time(lambda: GANMF(train, mode="user", seed=1337, is_experiment=True),
                       dict(cfg, compute_dtype="bf16"))
        record_row(f"GANMF[{ds}] steady epoch (K=250, b=64, bf16)", t,
               "f32 master params; parity receipts in PARITY_SEEDS.md")

        t = epoch_time(lambda: DisGANMF(train, mode="user", seed=1, is_experiment=True),
                       dict(num_factors=64, d_nodes=256, batch_size=128))
        record_row(f"DisGANMF[{ds}] steady epoch", t)

        cfg_cf = dict(d_nodes=64, g_nodes=256, scheme="ZR", zr_ratio=0.3, zr_coefficient=0.1,
                      d_batch_size=128, g_batch_size=128)
        t = epoch_time(lambda: CFGAN(train, mode="user", seed=1, is_experiment=True), cfg_cf)
        record_row(f"CFGAN[{ds}] steady epoch", t)

        cfg_ca = dict(d_steps=2, g_steps=2, gpr_steps=2, g_units=100, num_factors=50,
                      d_bsize=4096, m_batch=128)
        t = epoch_time(lambda: CAAE(train, seed=1, is_experiment=True), cfg_ca, n_epochs=41)
        record_row(f"CAAE[{ds}] steady epoch", t)

        ials = IALSRecommender(train)
        ials.fit(epochs=1, num_factors=50, alpha=5.0)

        def ials_epoch():
            ials._run_epoch(0)
            return float(jnp.sum(ials._U_dev))

        record_row(f"IALS[{ds}] 1 epoch (K=50)", timeit(ials_epoch, n=3),
               "ref ~0.8 s/epoch (ML-1M)" if ds == "1M" else "")

        slim = SLIM_BPR(train)
        slim.fit(epochs=1, topK=478, learning_rate=0.05)

        def slim_epoch():
            slim._run_epoch(0)
            return float(jnp.sum(slim._state.cache))

        record_row(f"SLIM-BPR[{ds}] 1 epoch", timeit(slim_epoch, n=3),
               "ref ~8.6 s/epoch (ML-1M)" if ds == "1M" else "")

        from ganmf_tpu.models.mf_sgd import MatrixFactorization_BPR

        mf = MatrixFactorization_BPR(train)
        mf.fit(epochs=1, num_factors=64)

        def mf_epoch():
            mf._run_epoch(0)
            return float(jnp.sum(mf._state.U))

        record_row(f"MF-BPR[{ds}] 1 epoch (K=64)", timeit(mf_epoch, n=3))

        # -- one-shot fits ------------------------------------------------------
        # warm-URM fit: the sklearn baseline operates on an in-RAM matrix, so
        # the comparable cost here excludes the one-time host->device staging
        svd_m = PureSVDRecommender(train)
        svd_m.fit(num_factors=50)

        def svd_fit():
            svd_m.fit(num_factors=50)
            return float(jnp.sum(svd_m._USER_factors_store))

        record_row(f"PureSVD[{ds}] fit (K=50, warm URM)", timeit(svd_fit, n=5),
               "ref ~0.12 s (ML-1M)" if ds == "1M" else "")
        def _w_sync(m):
            # builds adopt a device-authoritative W (no host export)
            return m._device_w

        def knn_build():
            m = ItemKNNCFRecommender(train)
            m.fit(topK=300, shrink=0)
            return _w_sync(m)

        record_row(f"ItemKNN[{ds}] cosine build (topK=300)", timeit(knn_build, n=2))

        def p3_build():
            m = P3alphaRecommender(train)
            m.fit(topK=300, alpha=0.9)
            return _w_sync(m)

        record_row(f"P3alpha[{ds}] build (topK=300)", timeit(p3_build, n=2))
        if ds == "1M":
            def ease_fit():
                m = EASE_R_Recommender(train)
                m.fit(l2_norm=100.0)
                # W stays device-authoritative; score readback is the sync
                return float(jnp.sum(m.score_device(jnp.arange(8))))

            record_row(f"EASE-R[{ds}] closed form (scoring-ready)", timeit(ease_fit, n=2))

            def ease_fit_topk():
                m = EASE_R_Recommender(train)
                m.fit(l2_norm=100.0, topK=300)
                return _w_sync(m)

            record_row(f"EASE-R[{ds}] closed form (topK=300 pruned W)", timeit(ease_fit_topk, n=2))

        # -- evaluation throughput ---------------------------------------------
        tp = TopPop(train); tp.fit()
        svd = PureSVDRecommender(train); svd.fit(num_factors=50)
        ev = EvaluatorHoldout(splits.test, [5, 10, 20, 50])
        ev.evaluateRecommender(svd)  # compile
        t = timeit(lambda: ev.evaluateRecommender(svd), n=3)
        n_users = len(ev.usersToEvaluate)
        record_row(f"Eval[{ds}] {n_users} users x 4 cutoffs", t,
               f"{n_users/t:,.0f} users/s (ref ~686 users/s on ML-1M)")

        # similarity-family models route through the fused matmul+top_k+probe
        # path (ops/scoring.masked_topk_matmul)
        knn_ev = ItemKNNCFRecommender(train)
        knn_ev.fit(topK=300, shrink=0)
        ev_knn = EvaluatorHoldout(splits.test, [5, 10, 20, 50])
        assert ev_knn._can_fuse_sim(knn_ev)
        ev_knn.evaluateRecommender(knn_ev)  # compile
        t = timeit(lambda: ev_knn.evaluateRecommender(knn_ev), n=3)
        record_row(f"Eval[{ds}] similarity-family (ItemKNN) {n_users} users", t,
               f"{n_users/t:,.0f} users/s")

        # -- serving throughput: ranked top-20 lists for every user ------------
        # (the production recommend path: fused device scoring + ranking,
        # host sees only the [B, 20] winners and assembles python lists)
        all_users = np.arange(U)
        def serve(model):
            out = []
            for s in range(0, U, 2048):
                out.extend(model.recommend_fused(all_users[s:s + 2048], cutoff=20))
            return len(out)
        serve(svd)  # compile
        t = timeit(lambda: serve(svd), n=3)
        record_row(f"Serve[{ds}] MF top-20 lists, all {U} users", t, f"{U/t:,.0f} users/s")
        serve(knn_ev)
        t = timeit(lambda: serve(knn_ev), n=3)
        record_row(f"Serve[{ds}] ItemKNN top-20 lists, all {U} users", t, f"{U/t:,.0f} users/s")

        # batch export: the whole user base through ONE lax.map dispatch,
        # host reads back only the [U, 20] winners (Recommender.serve_all)
        def serve_batch(model):
            idx, vals = model.serve_all(cutoff=20, block=2048)
            return int(idx[-1, 0])
        serve_batch(svd)  # compile
        t = timeit(lambda: serve_batch(svd), n=3)
        record_row(f"Serve[{ds}] MF top-20 export, serve_all 1 dispatch", t, f"{U/t:,.0f} users/s")
        serve_batch(knn_ev)
        t = timeit(lambda: serve_batch(knn_ev), n=3)
        record_row(f"Serve[{ds}] ItemKNN top-20 export, serve_all 1 dispatch", t, f"{U/t:,.0f} users/s")

    _write(rows)
    print(f"wrote {ROWS_MD}")


def _write(rows):
    lines = [
        f"# perf_report — {require_card()}",
        "",
        "Steady-state timings on the GPU, median of n, compile excluded; every",
        "timing waits for the device with block_until_ready. Reference baselines",
        "from the corrected test_results timing strings (BASELINE.md).",
        "",
        "| Benchmark | time | achieved (dominant-term roofline) | note |",
        "|---|---|---|---|",
    ]

    def ds_group(name):
        for i, key in enumerate(("[1M]", "[LastFM]", "[hetrec2011]")):
            if key in name:
                return i
        return 3

    ordered = sorted(rows.items(), key=lambda kv: ds_group(kv[0]))  # stable
    for name, (seconds, note) in ordered:
        lines.append(f"| {name} | {seconds*1e3:.1f} ms | {roofline(name, seconds)} | {note} |")
    lines += [
        "",
        "The roofline column divides an analytic dominant-term work count",
        "(forward matmul FLOPs x3 for trained passes; row-traffic bytes for",
        "gather/scatter-bound programs — formulas in scripts/perf_report.py)",
        f"by the time, against the card's published peaks ({peaks()['source']}).",
    ]
    with open(ROWS_MD, "w") as fh:
        fh.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    if sys.argv[1:] == ["--render"]:
        _write(load_rows())
    else:
        main(tuple(sys.argv[1:]) or ("1M", "LastFM"))
