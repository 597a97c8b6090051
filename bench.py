#!/usr/bin/env python3
"""Driver benchmark: one JSON line tracking the framework's headline numbers.

Headline metric: GANMF training-epoch time on ML-1M with the paper's committed
best params (experiments/GANMF_user_1M/best_params.txt — num_factors=250,
emb_dim=992, batch_size=64).

The `basket` key adds the other framework-level numbers (VERDICT r3 #7):
evaluation throughput, CFGAN and IALS epoch times, and whole-base serving
throughput, each with its own `vs_baseline` against the reference's
corrected wall-clock numbers (BASELINE.md "Timing baseline"):

  - GANMF ML-1M final train ~240 s / 66 epochs  -> 3.64 s/epoch
  - CFGAN_user_1M final train 0:51:02 printed -> 35.4 s / 26 epochs
    -> 1.363 s/epoch (test_results/CFGAN_user_1M/test_results.txt)
  - IALS ML-1M final train ~4.0 s / 5 epochs -> 0.80 s/epoch
  - test eval 6040 users x 4 cutoffs ~8.8 s -> ~686 users/s; the
    reference's serving path is the same recommend() loop, so 686 users/s
    is also the serving baseline.

Runs only on an NVIDIA GPU: it prints the card's name and power limit
first and refuses any other device. Every timing ends in
jax.block_until_ready. Then it prints ONE JSON line:
  {"metric": ..., "value": ..., "unit": ..., "vs_baseline": ...,
   "basket": [{"metric": ..., "value": ..., "unit": ..., "vs_baseline": ...}, ...]}
A basket row that fails is reported on stderr, left out of the line, and
makes the exit code non-zero.
"""

import json
import os
import sys
import traceback

_ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "scripts"))

REF_GANMF_EPOCH_S = 240.0 / 66.0
REF_CFGAN_EPOCH_S = (3062.0 * 1000.0 / 86400.0) / 26.0
REF_IALS_EPOCH_S = 4.0 / 5.0
REF_EVAL_USERS_PER_S = 686.0
REF_SERVE_USERS_PER_S = 686.0

BEST_PARAMS_ML1M = {
    "num_factors": 250, "emb_dim": 992, "batch_size": 64, "m": 10,
    "d_lr": 0.0001, "g_lr": 0.0001653241474168571, "d_reg": 0.0001,
    "recon_coefficient": 0.01,
}


def _load_ml1m():
    from ganmf_tpu.data import load_reference_splits

    try:
        splits = load_reference_splits("1M")
        return splits.train, splits.test
    except FileNotFoundError:
        # fallback: a seeded matrix with ML-1M's shape and density
        from chip_smoke import ml1m_standin

        return ml1m_standin()


def bench_ganmf_epoch(train_csr):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from _timing import timeit
    from ganmf_tpu.models import GANMF
    from ganmf_tpu.models.ganmf import ADAM, _d_params, _init_params, ganmf_epoch
    from ganmf_tpu.models.gan_base import make_batches, padded_weights, shuffled_padded_perm

    model = GANMF(train_csr, mode="user", seed=1337, is_experiment=True)
    urm = model._train_dense()
    n_rows = urm.shape[0]
    p = BEST_PARAMS_ML1M

    params = _init_params(jax.random.PRNGKey(1337), *urm.shape, p["num_factors"], p["emb_dim"])
    d_state = ADAM.init(_d_params(params))
    g_state = (
        ADAM.init((params.item_emb,)),
        jnp.zeros_like(params.user_emb),
        jnp.zeros_like(params.user_emb),
        jnp.float32(0.0),
    )
    n_batches, padded = make_batches(n_rows, p["batch_size"])
    weights = jnp.asarray(padded_weights(n_rows, padded))
    rng = np.random.RandomState(1337)

    def one_epoch():
        nonlocal params, d_state, g_state
        perm = jnp.asarray(shuffled_padded_perm(rng, n_rows, padded))
        params, d_state, g_state, dl, gl = ganmf_epoch(
            params, d_state, g_state, urm, perm, weights,
            jnp.float32(p["d_lr"]), jnp.float32(p["g_lr"]),
            m=float(p["m"]), recon_coefficient=float(p["recon_coefficient"]),
            d_reg=float(p["d_reg"]), g_reg=0.0,
            n_batches=n_batches, batch_size=p["batch_size"], d_steps=1, g_steps=1,
        )
        return params, dl, gl

    # the first call compiles; the median of the timed epochs is the
    # steady state
    return timeit(one_epoch, n=20)


def bench_cfgan_epoch(train_csr):
    from _timing import epoch_time

    from ganmf_tpu.models import CFGAN

    cfg = dict(d_nodes=64, g_nodes=256, scheme="ZR", zr_ratio=0.3, zr_coefficient=0.1,
               d_batch_size=128, g_batch_size=128)
    return epoch_time(lambda: CFGAN(train_csr, mode="user", seed=1, is_experiment=True), cfg)


def bench_ials_epoch(train_csr):
    from _timing import timeit
    from ganmf_tpu.models import IALSRecommender

    ials = IALSRecommender(train_csr)
    ials.fit(epochs=1, num_factors=50, alpha=5.0)

    def one_epoch():
        ials._run_epoch(0)
        return ials._U_dev

    return timeit(one_epoch, n=3)


def bench_eval_and_serve(train_csr, test_csr):
    from _timing import timeit
    from ganmf_tpu.eval import EvaluatorHoldout
    from ganmf_tpu.models import PureSVDRecommender

    model = PureSVDRecommender(train_csr)
    model.fit(num_factors=50)

    evaluator = EvaluatorHoldout(test_csr, cutoff_list=[5, 10, 20, 50])
    n_eval_users = len(evaluator.usersToEvaluate)

    def run_eval():
        results, _ = evaluator.evaluateRecommender(model)
        return results

    t_eval = timeit(run_eval, n=3)

    n_users = train_csr.shape[0]

    def run_serve():
        return model.serve_all(cutoff=20)  # host arrays: already complete

    t_serve = timeit(run_serve, n=3)
    return n_eval_users / t_eval, n_users / t_serve


def _load_ml20m():
    """The ML-20M-scale synthetic stand-in (seeded, cached): regenerates
    ratings.csv + splits deterministically if the gitignored caches are
    absent (scripts/synthesize_ml20m.py; ~5 min one-time)."""
    from ganmf_tpu.data import load_reference_splits

    try:
        return load_reference_splits("20M", split_dir=None)
    except FileNotFoundError:
        pass
    from synthesize_ml20m import synthesize

    data_dir = os.environ.get("GANMF_TPU_DATA", os.path.join("datasets", "all_datasets"))
    synthesize(os.path.join(data_dir, "ml-20m", "ratings.csv"), verbose=False)
    from ganmf_tpu.cli.experiment import load_urms

    return load_urms("20M")


def bench_20m():
    """Two ML-20M-scale rows so the bench history tracks the streamed /
    flat-CSR at-scale paths (VERDICT r4 #7), not just ML-1M-toy shapes:

      - ials20m_epoch_time: one IALS epoch, K=96, urm_storage='csr'
        (flat-CSR at this skew). vs_baseline extrapolates the reference's
        measured ML-1M 0.80 s/epoch linearly in train nnz
        (15.04 M / 0.80 M -> 15.0 s) — the reference never ran 20M.
      - serve20m_users_per_s: PureSVD serve_all top-20 export over all
        138,493 users; same 686 users/s recommend-loop baseline as ML-1M.
    """
    from _timing import timeit
    from ganmf_tpu.models import IALSRecommender, PureSVDRecommender

    splits = _load_ml20m()
    rows = []

    ials = IALSRecommender(splits.train)
    ials.fit(epochs=1, num_factors=96, alpha=5.0, reg=1e-2, urm_storage="csr")

    def one_epoch():
        ials._run_epoch(0)
        return ials._U_dev

    ep_s = timeit(one_epoch, n=2)
    ref_20m_ials = REF_IALS_EPOCH_S * (splits.train.nnz / 0.80e6)
    rows.append({
        "metric": "ials20m_epoch_time", "value": round(ep_s, 4),
        "unit": "s", "vs_baseline": round(ref_20m_ials / ep_s, 2),
    })
    del ials

    svd = PureSVDRecommender(splits.train)
    svd.fit(num_factors=128)

    def run_serve():
        return svd.serve_all(cutoff=20)

    t_serve = timeit(run_serve, n=2)
    rows.append({
        "metric": "serve20m_users_per_s", "value": round(splits.train.shape[0] / t_serve, 1),
        "unit": "users/s", "vs_baseline": round((splits.train.shape[0] / t_serve) / REF_SERVE_USERS_PER_S, 2),
    })
    return rows


def main():
    from _timing import require_card

    require_card()  # refuses anything but a GPU; prints the card's line
    train, test = _load_ml1m()

    per_epoch = bench_ganmf_epoch(train)
    basket, failed = [], []

    def row(name, fn):
        try:
            basket.extend(fn())
        except Exception:  # report every row; the exit code carries the failure
            failed.append(name)
            print(f"# basket {name} failed:", file=sys.stderr)
            traceback.print_exc()

    def cfgan_rows():
        cfgan_s = bench_cfgan_epoch(train)
        return [{"metric": "cfgan_ml1m_train_epoch_time", "value": round(cfgan_s, 4),
                 "unit": "s", "vs_baseline": round(REF_CFGAN_EPOCH_S / cfgan_s, 2)}]

    def ials_rows():
        ials_s = bench_ials_epoch(train)
        return [{"metric": "ials_ml1m_epoch_time", "value": round(ials_s, 4),
                 "unit": "s", "vs_baseline": round(REF_IALS_EPOCH_S / ials_s, 2)}]

    def eval_serve_rows():
        eval_ups, serve_ups = bench_eval_and_serve(train, test)
        return [
            {"metric": "eval_ml1m_users_per_s", "value": round(eval_ups, 1),
             "unit": "users/s", "vs_baseline": round(eval_ups / REF_EVAL_USERS_PER_S, 2)},
            {"metric": "serve_all_ml1m_users_per_s", "value": round(serve_ups, 1),
             "unit": "users/s", "vs_baseline": round(serve_ups / REF_SERVE_USERS_PER_S, 2)},
        ]

    row("cfgan", cfgan_rows)
    row("ials", ials_rows)
    row("eval/serve", eval_serve_rows)
    row("20M", bench_20m)

    print(json.dumps({
        "metric": "ganmf_ml1m_train_epoch_time",
        "value": round(per_epoch, 4),
        "unit": "s",
        "vs_baseline": round(REF_GANMF_EPOCH_S / per_epoch, 2),
        "basket": basket,
    }))
    if failed:
        sys.exit(f"basket rows failed: {', '.join(failed)}")


if __name__ == "__main__":
    main()
