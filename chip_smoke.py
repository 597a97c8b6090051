#!/usr/bin/env python3
"""Smoke run of the main path on one NVIDIA GPU.

    python chip_smoke.py

Needs a GPU and exits non-zero without one. Everything runs in this one
process (JAX reserves most of the card's memory, so a second JAX process
on the card would fail). The data is a seeded stand-in with ML-1M's shape
(6040 x 3706) and density (4.46%), split 80/20; weights are random from
fixed seeds. Phases, one line each:

  (a) GANMF in user mode at the published ML-1M best params trains 3
      epochs through ``GANMF.fit``, then ``EvaluatorHoldout`` evaluates it.
      Prints the steady epoch time, the epoch program's memory analysis,
      the peak device memory and MAP@20.
  (b) One GANMF D+G step on the GPU against the same step on the CPU
      device of this process, from the same state: losses and gradients,
      at HIGHEST matmul precision and at the default one.
  (c) PureSVD (K=50) evaluated through the fused XLA ranking program and
      through the plain route, against the CPU device; ``recommend_fused``
      against ``recommend``. Also times the fused eval blocks.
  (d) ``smallest_k_mask`` at the CFGAN ZR draw's shape, bitwise against a
      numpy rank table, then one CFGAN ML-1M epoch.

Any failed check raises, so the exit code is non-zero. The last line is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
The phase functions take their sizes as arguments, so the CPU tests run
them at tiny shapes.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sps

from ganmf_tpu.utils.accelerator import card_line, require_gpu
from ganmf_tpu.utils.profiling import timed_calls

CUTOFFS = (5, 10, 20, 50)

# GANMF's published ML-1M best params (experiments/GANMF_user_1M of the
# reference; the same values bench.py times)
GANMF_ML1M = {
    "num_factors": 250, "emb_dim": 992, "batch_size": 64, "m": 10,
    "d_lr": 0.0001, "g_lr": 0.0001653241474168571, "d_reg": 0.0001,
    "recon_coefficient": 0.01,
}
# the CFGAN ML-1M configuration bench.py times
CFGAN_ML1M = {
    "d_nodes": 64, "g_nodes": 256, "scheme": "ZR", "zr_ratio": 0.3,
    "zr_coefficient": 0.1, "d_batch_size": 128, "g_batch_size": 128,
}
H100_HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM data sheet


class CheckFailed(RuntimeError):
    pass


def check(ok, what):
    if not ok:
        raise CheckFailed(what)


def ml1m_standin(n_users=6040, n_items=3706, density=0.0446, seed=0):
    """(train, test) CSR: a seeded binary matrix with ML-1M's shape and
    density, 80/20 per interaction (bench.py's stand-in)."""
    rng = np.random.RandomState(seed)
    dense = (rng.rand(n_users, n_items) < density).astype(np.float32)
    keep = rng.rand(n_users, n_items) < 0.8
    return sps.csr_matrix(dense * keep), sps.csr_matrix(dense * ~keep)


def _max_rel_err(a, b):
    """max |a - b| / max |b| over one array (0 when both are all zero)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.max(np.abs(b)) if b.size else 0.0
    diff = np.max(np.abs(a - b)) if b.size else 0.0
    return float(diff / scale) if scale > 0 else float(diff)


def _memory_analysis(jitted, args, kwargs) -> dict:
    ma = jitted.lower(*args, **kwargs).compile().memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    return {f: int(getattr(ma, f)) for f in fields if ma is not None and hasattr(ma, f)}


def _peak_bytes(dev):
    stats = dev.memory_stats() or {}
    return stats.get("peak_bytes_in_use", "not reported")


def phase_ganmf(train, test, params=GANMF_ML1M, epochs=3, seed=1337, cutoffs=CUTOFFS):
    """(a) GANMF.fit then EvaluatorHoldout, on the default device."""
    from ganmf_tpu.eval import EvaluatorHoldout
    from ganmf_tpu.models import GANMF
    from ganmf_tpu.models import ganmf as ganmf_mod

    model = GANMF(train, mode="user", seed=seed, is_experiment=True)
    t0 = time.perf_counter()
    with timed_calls(ganmf_mod, "ganmf_epoch") as epoch_s:
        model.fit(epochs=epochs, **params)
    fit_s = time.perf_counter() - t0
    losses = [float(x) for x in model.train_d_loss + model.train_g_loss]
    check(np.all(np.isfinite(losses)), f"GANMF losses not finite: {losses}")
    mem = _memory_analysis(ganmf_mod.ganmf_epoch._fast, *epoch_s.last)

    t0 = time.perf_counter()
    results, _ = EvaluatorHoldout(test, cutoff_list=list(cutoffs)).evaluateRecommender(model)
    eval_s = time.perf_counter() - t0
    map20 = results[min(20, max(cutoffs))]["MAP"]
    check(np.isfinite(map20) and 0.0 <= map20 <= 1.0, f"GANMF MAP@20 out of range: {map20}")
    steady = epoch_s[1:] or epoch_s
    return {
        "epochs": epochs, "fit_s": fit_s, "epoch_s": list(epoch_s),
        "steady_epoch_s": statistics.median(steady), "first_epoch_s": epoch_s[0],
        "epoch_memory": mem, "peak_bytes_in_use": _peak_bytes(jax.devices()[0]),
        "eval_s_with_compile": eval_s, "MAP@20": map20,
        "d_loss": losses[:epochs], "g_loss": losses[epochs:],
    }


def _step_state(train, params, seed):
    from ganmf_tpu.models.ganmf import _init_params

    U, I = train.shape
    p = _init_params(jax.random.PRNGKey(seed), U, I, params["num_factors"], params["emb_dim"])
    p = jax.tree_util.tree_map(np.asarray, p)
    B = params["batch_size"]
    uids = np.random.RandomState(seed).permutation(U)[:B].astype(np.int32)
    return p, uids, np.asarray(train[uids].todense(), np.float32), np.ones(B, np.float32)


def _step_on(device, precision, state, train_dense, params):
    """Losses and gradients of one D+G step on ``device``, plus the losses
    the jitted epoch program reports for that one step."""
    from ganmf_tpu.models.ganmf import (ADAM, GANMFParams, _d_params, _g_params,
                                        _losses, ganmf_epoch)

    p_np, uids_np, real_np, w_np = state
    hp = (float(params["m"]), float(params["recon_coefficient"]),
          float(params["d_reg"]), 0.0)
    ctx = jax.default_matmul_precision(precision) if precision else contextlib.nullcontext()
    with jax.default_device(device), ctx:
        p = GANMFParams(*(jax.device_put(t, device) for t in p_np))
        uids, real, w = (jax.device_put(x, device) for x in (uids_np, real_np, w_np))

        @jax.jit
        def losses_and_grads(p, uids, real, w):
            dl, dg = jax.value_and_grad(lambda q: _losses(q, uids, real, w, *hp)[0])(p)
            gl, gg = jax.value_and_grad(lambda q: _losses(q, uids, real, w, *hp)[1])(p)
            return dl, gl, _d_params(dg), _g_params(gg)

        dl, gl, dgrad, ggrad = losses_and_grads(p, uids, real, w)
        urm = jax.device_put(train_dense, device)
        g_state = (ADAM.init((p.item_emb,)), jnp.zeros_like(p.user_emb),
                   jnp.zeros_like(p.user_emb), jnp.float32(0.0))
        out = ganmf_epoch(
            p, ADAM.init(_d_params(p)), g_state, urm, uids, w,
            jnp.float32(params["d_lr"]), jnp.float32(params["g_lr"]),
            m=hp[0], recon_coefficient=hp[1], d_reg=hp[2], g_reg=hp[3],
            n_batches=1, batch_size=len(uids_np), d_steps=1, g_steps=1,
        )
        return jax.device_get({
            "loss": (dl, gl), "grad": (dgrad, ggrad), "step_loss": (out[3], out[4]),
        })


def phase_ganmf_step(train, gpu, cpu, params=GANMF_ML1M, seed=1337,
                     bounds=(("highest", 1e-5), (None, 5e-3))):
    """(b) one GANMF D+G step on ``gpu`` against the same on ``cpu``.
    Errors are max |gpu - cpu| / max |cpu| per tensor (losses per value);
    each precision's worst error must stay within its bound. On an H100
    the worst errors were 7.6e-7 at HIGHEST and 4.9e-4 at the default
    precision, where f32 matmuls may run in TF32 (about three decimal
    digits); the bounds leave a tenfold margin for XLA choosing other
    algorithms in another process."""
    state = _step_state(train, params, seed)
    train_dense = np.asarray(train.todense(), np.float32)
    out = {}
    for precision, bound in bounds:
        g = _step_on(gpu, precision, state, train_dense, params)
        c = _step_on(cpu, precision, state, train_dense, params)
        errs = {}
        for key in ("loss", "step_loss", "grad"):
            leaves_g = jax.tree_util.tree_leaves(g[key])
            leaves_c = jax.tree_util.tree_leaves(c[key])
            for a in leaves_g + leaves_c:
                check(np.all(np.isfinite(a)), f"non-finite {key} at precision {precision}")
            errs[key] = max(_max_rel_err(a, b) for a, b in zip(leaves_g, leaves_c))
        name = precision or "default"
        out[name] = {"max_rel_err": errs, "bound": bound}
        worst = max(errs.values())
        check(worst <= bound, f"GANMF step GPU vs CPU at {name} precision: {errs} > {bound}")
    return out


def _ranking_gap(lists_a, lists_b, scores64, rel=1e-6):
    """Positions where two rankings hold different items, and the worst
    |s[a] - s[b]| / |top score| over them (float64 scores). Lists that
    differ only inside ties give a gap within ``rel``."""
    n_diff, worst = 0, 0.0
    for u, (a, b) in enumerate(zip(lists_a, lists_b)):
        check(len(a) == len(b), f"user {u}: list lengths {len(a)} vs {len(b)}")
        if a == b:
            continue
        s = scores64[u]
        top = max(abs(s[a[0]]), 1e-30)
        for x, y in zip(a, b):
            if x != y:
                n_diff += 1
                worst = max(worst, abs(s[x] - s[y]) / top)
    check(worst <= rel, f"rankings differ beyond ties: gap {worst} > {rel}")
    return n_diff, worst


def _metric_gap(ra, rb):
    worst = 0.0
    for c in ra:
        for m, va in ra[c].items():
            vb = rb[c][m]
            if np.isnan(va) and np.isnan(vb):
                continue
            worst = max(worst, abs(va - vb))
    return worst


def phase_puresvd(train, test, gpu, cpu, num_factors=50, n_serve=256, cutoffs=CUTOFFS,
                  atol=1e-5, timed_passes=3):
    """(c) PureSVD through the fused and the plain evaluation routes on
    ``gpu``, against the fused route on ``cpu`` with the same factors."""
    from ganmf_tpu.eval import EvaluatorHoldout
    from ganmf_tpu.models import PureSVDRecommender

    with jax.default_device(gpu):
        model = PureSVDRecommender(train)
        model.fit(num_factors=num_factors)
        ev = EvaluatorHoldout(test, cutoff_list=list(cutoffs))
        check(ev._can_fuse(model), "PureSVD does not take the fused route")
        fused, _ = ev.evaluateRecommender(model)  # compiles
        pass_s = []
        for _ in range(timed_passes):
            t0 = time.perf_counter()
            ev.evaluateRecommender(model)
            pass_s.append(time.perf_counter() - t0)
        with timed_calls(ev, "_fused_block") as block_s:
            ev.evaluateRecommender(model)
        block_args = block_s.last[0]
        plain, _ = ev._evaluate_pass(model, allow_fused=False)

        users = np.arange(train.shape[0])
        lists_gpu = []
        for s in range(0, len(users), 2048):
            lists_gpu += model.recommend_fused(users[s:s + 2048], cutoff=max(cutoffs))
        serve = users[:n_serve]
        check(model.recommend_fused(serve, cutoff=max(cutoffs))
              == model.recommend(serve, cutoff=max(cutoffs)),
              f"recommend_fused != recommend for {n_serve} users")
        U_np, V_np = np.asarray(model.USER_factors), np.asarray(model.ITEM_factors)

    with jax.default_device(cpu):
        model_cpu = PureSVDRecommender(train)
        model_cpu.USER_factors, model_cpu.ITEM_factors = U_np, V_np
        fused_cpu, _ = EvaluatorHoldout(test, cutoff_list=list(cutoffs)).evaluateRecommender(model_cpu)
        lists_cpu = []
        for s in range(0, len(users), 2048):
            lists_cpu += model_cpu.recommend_fused(users[s:s + 2048], cutoff=max(cutoffs))

    gap_routes = _metric_gap(fused, plain)
    gap_devices = _metric_gap(fused, fused_cpu)
    check(gap_routes <= atol, f"fused vs plain metrics differ by {gap_routes}")
    check(gap_devices <= atol, f"GPU vs CPU metrics differ by {gap_devices}")
    s64 = U_np.astype(np.float64) @ V_np.astype(np.float64).T
    n_diff, rank_gap = _ranking_gap(lists_gpu, lists_cpu, s64)

    B, I = len(block_args[1]), train.shape[1]
    steady_pass = min(pass_s)
    return {
        "MAP@20": fused[min(20, max(cutoffs))]["MAP"],
        "metric_gap_fused_vs_plain": gap_routes, "metric_gap_gpu_vs_cpu": gap_devices,
        "ranked_positions_differing_gpu_vs_cpu": n_diff, "worst_tie_gap": rank_gap,
        "eval_pass_s": pass_s, "eval_users": len(ev.usersToEvaluate),
        "fused_block_shape": [B, I], "fused_block_s": list(block_s),
        "fused_blocks_share_of_pass": sum(block_s) / steady_pass,
        "score_round_trip_s_at_3.35TB/s": 2 * 4 * B * I / H100_HBM_BYTES_PER_S,
    }


def _time_steady(fn, *args, n=10):
    jax.block_until_ready(fn(*args))  # compile
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def phase_masks(train, cfgan=CFGAN_ML1M, stream_shape=(128, 65536), seed=3, epochs=2):
    """(d) the exact-k mask draw, bitwise against a stable numpy rank table
    at the ZR draw's shape, timed there and at the streamed batch shape;
    then CFGAN.fit, whose steady epoch gives the draw's share."""
    from ganmf_tpu.models import CFGAN
    from ganmf_tpu.models import cfgan as cfgan_mod
    from ganmf_tpu.ops.topk import smallest_k_mask

    urm = np.asarray(train.todense(), np.float32)
    interacted = urm != 0
    keys = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), urm.shape))
    keys = np.where(interacted, np.inf, keys).astype(np.float32)
    k_u = ((~interacted).sum(axis=1) * np.float32(cfgan["zr_ratio"])).astype(np.int32)
    draw = jax.jit(smallest_k_mask)
    got = np.asarray(draw(jnp.asarray(keys), jnp.asarray(k_u)))
    ranks = np.argsort(np.argsort(keys, axis=1, kind="stable"), axis=1, kind="stable")
    check(np.array_equal(got, ranks < k_u[:, None]), "smallest_k_mask != rank table")
    draw_s = _time_steady(draw, jnp.asarray(keys), jnp.asarray(k_u))

    r, c = stream_shape
    skeys = jax.random.uniform(jax.random.PRNGKey(seed + 1), (r, c))
    stream_s = _time_steady(draw, skeys, jnp.full((r,), c // 3, jnp.int32))

    model = CFGAN(train, mode="user", seed=1, is_experiment=True)
    with timed_calls(cfgan_mod, "cfgan_epoch") as epoch_s:
        model.fit(epochs=epochs, **cfgan)
    leaves = jax.tree_util.tree_leaves(model.params)
    check(all(bool(jnp.all(jnp.isfinite(t))) for t in leaves), "CFGAN params not finite")
    scores = np.asarray(model.score_device(jnp.arange(min(256, train.shape[0]))))
    check(np.all(np.isfinite(scores)), "CFGAN scores not finite")
    steady = statistics.median(epoch_s[1:] or epoch_s)
    return {
        "mask_shape": list(keys.shape), "mask_draw_s": draw_s,
        "stream_shape": [r, c], "stream_draw_s": stream_s,
        "cfgan_epoch_s": list(epoch_s), "cfgan_steady_epoch_s": steady,
        "draw_share_of_epoch": draw_s / steady,
    }


def main():
    gpu = require_gpu()
    print(card_line(), flush=True)
    cpu = jax.devices("cpu")[0]
    train, test = ml1m_standin()

    for tag, run in (
        ("(a) ganmf", lambda: phase_ganmf(train, test)),
        ("(b) ganmf_step_gpu_vs_cpu", lambda: phase_ganmf_step(train, gpu, cpu)),
        ("(c) puresvd_eval", lambda: phase_puresvd(train, test, gpu, cpu)),
        ("(d) mask_draw_and_cfgan", lambda: phase_masks(train)),
    ):
        t0 = time.perf_counter()
        out = run()
        out["phase_s"] = time.perf_counter() - t0
        print(tag, json.dumps(out), flush=True)

    print(json.dumps({"ok": True, "device": {
        "platform": gpu.platform, "kind": gpu.device_kind, "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
