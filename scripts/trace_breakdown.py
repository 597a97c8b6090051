#!/usr/bin/env python3
"""Device-time breakdown of the main path's steady state, from a
jax.profiler trace on the GPU.

Two windows, each traced in its own profiler session after warm-up:
  ganmf_epochs  3 epochs of GANMF's jitted epoch program at the published
                ML-1M width (the chip_smoke.py stand-in data)
  eval_pass     one EvaluatorHoldout pass of PureSVD (K=50) through the
                fused ranking route

For every device trace line: busy time (union of its events), the share
of the host-clock window in which the device was idle, and the top
events by summed duration. Writes chiprun_out/trace_breakdown.json and
keeps the raw traces under chiprun_out/trace/.

    python scripts/trace_breakdown.py
"""

import glob
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax

from _timing import require_card

OUT = os.path.join("chiprun_out", "trace")


def traced(name, fn):
    """Run fn() under a profiler session; returns the host-clock window and
    the device breakdown of that session's trace."""
    logdir = os.path.join(OUT, name)
    with jax.profiler.trace(logdir):
        t0 = time.perf_counter_ns()
        jax.block_until_ready(fn())
        wall_ns = time.perf_counter_ns() - t0
    from ganmf_tpu.utils.profiling import trace_breakdown

    path = sorted(glob.glob(os.path.join(logdir, "**", "*.xplane.pb"), recursive=True))[-1]
    lines = trace_breakdown(path)
    for v in lines.values():
        v["idle_share_of_window"] = 1.0 - v["busy_ns"] / wall_ns
    return {"window_ns": wall_ns, "lines": lines}


def main():
    card = require_card()
    from chip_smoke import GANMF_ML1M, ml1m_standin

    from ganmf_tpu.eval import EvaluatorHoldout
    from ganmf_tpu.models import GANMF, PureSVDRecommender
    from ganmf_tpu.models import ganmf as ganmf_mod
    from ganmf_tpu.utils.profiling import timed_calls

    train, test = ml1m_standin()
    out = {"card": card}

    model = GANMF(train, mode="user", seed=1337, is_experiment=True)
    with timed_calls(ganmf_mod, "ganmf_epoch") as calls:
        model.fit(epochs=2, **GANMF_ML1M)
    args, kwargs = calls.last

    def epochs():
        state = args
        for _ in range(3):
            p, d, g, _, _ = ganmf_mod.ganmf_epoch(*state, **kwargs)
            state = (p, d, g) + tuple(state[3:])
        return state[0]

    out["ganmf_epochs"] = traced("ganmf_epochs", epochs)

    svd = PureSVDRecommender(train)
    svd.fit(num_factors=50)
    ev = EvaluatorHoldout(test, cutoff_list=[5, 10, 20, 50])
    ev.evaluateRecommender(svd)  # compile
    out["eval_pass"] = traced("eval_pass", lambda: ev.evaluateRecommender(svd)[0][20]["MAP"])

    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "trace_breakdown.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    for window in ("ganmf_epochs", "eval_pass"):
        w = out[window]
        print(window, "window_ms", w["window_ns"] / 1e6)
        for key, v in w["lines"].items():
            print(f"  {key}: events {v['events']} busy_ms {v['busy_ns']/1e6:.3f} "
                  f"idle {v['idle_share_of_window']:.3f}")
            for name, ns in v["top"][:6]:
                print(f"      {ns/1e6:9.3f} ms  {name[:90]}")


if __name__ == "__main__":
    main()
