#!/usr/bin/env python3
"""Measures the perf options that were built but whose defaults wait on a
measurement on the GPU (ROADMAP.md, design debt 6):

  1. CAAE  d_scatter="direct" vs "dedup"   (ML-1M + LastFM steady epoch)
  2. SLIM-BPR presample=False vs True      (ML-1M 1-epoch)
  3. MF-BPR  presample=False vs True       (ML-1M 1-epoch)

Prints one JSON line per measurement; defaults get flipped in code only
if the alternative wins on the chip.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _timing import epoch_time, timeit

import jax
import jax.numpy as jnp

from ganmf_tpu.data.splits import load_reference_splits
from ganmf_tpu.models import CAAE, SLIM_BPR
from ganmf_tpu.models.mf_sgd import MatrixFactorization_BPR


def main():
    results = {}
    for ds in (["1M", "LastFM"] if len(sys.argv) < 2 else [sys.argv[1]]):
        train = load_reference_splits(ds).train
        cfg_ca = dict(d_steps=2, g_steps=2, gpr_steps=2, g_units=100, num_factors=50,
                      d_bsize=4096, m_batch=128)
        for scatter in ("direct", "dedup"):
            t = epoch_time(
                lambda: CAAE(train, seed=1, is_experiment=True),
                dict(cfg_ca, d_scatter=scatter), n_epochs=41)
            results[f"CAAE[{ds}] d_scatter={scatter}"] = t
            print(json.dumps({"bench": f"CAAE[{ds}] d_scatter={scatter}", "ms": t * 1e3}), flush=True)

        if ds != "1M":
            continue

        for presample in (False, True):
            slim = SLIM_BPR(train)
            slim.fit(epochs=1, topK=478, learning_rate=0.05, presample=presample)

            def slim_epoch():
                slim._run_epoch(0)
                return float(jnp.sum(slim._state.cache))

            t = timeit(slim_epoch, n=3)
            results[f"SLIM-BPR[{ds}] presample={presample}"] = t
            print(json.dumps({"bench": f"SLIM-BPR[{ds}] presample={presample}", "ms": t * 1e3}), flush=True)

        for presample in (False, True):
            mf = MatrixFactorization_BPR(train)
            mf.fit(epochs=1, num_factors=64, presample=presample)

            def mf_epoch():
                mf._run_epoch(0)
                return float(jnp.sum(mf._state.U))

            t = timeit(mf_epoch, n=3)
            results[f"MF-BPR[{ds}] presample={presample}"] = t
            print(json.dumps({"bench": f"MF-BPR[{ds}] presample={presample}", "ms": t * 1e3}), flush=True)

    print(json.dumps({"all": {k: round(v * 1e3, 1) for k, v in results.items()}}))


if __name__ == "__main__":
    main()
