"""Shared timing for the measurement scripts.

Measurements run only on an NVIDIA GPU: the first timing refuses any
other device and prints the card's name and power limit. Every timing
waits for the device with ``jax.block_until_ready``.
"""

import importlib
import json
import os
import statistics
import time

# the jitted epoch program each GAN model's fit() calls, by RECOMMENDER_NAME
EPOCH_PROGRAMS = {
    "GANMF": ("ganmf_tpu.models.ganmf", "ganmf_epoch"),
    "DisGANMF": ("ganmf_tpu.models.disganmf", "disganmf_epoch"),
    "CFGAN": ("ganmf_tpu.models.cfgan", "cfgan_epoch"),
    "CAAE": ("ganmf_tpu.models.caae", "caae_epoch"),
}

_card = []


def require_card():
    """Refuse to time anything but a GPU; print the card's line once."""
    if not _card:
        from ganmf_tpu.utils.accelerator import card_line, require_gpu

        require_gpu()
        _card.append(card_line())
        print(_card[0], flush=True)
    return _card[0]


def timeit(fn, n=3, warmup=1):
    """Median wall time of ``fn()``, each call waited on with
    block_until_ready; ``warmup`` untimed calls compile first."""
    import jax

    require_card()
    for _ in range(warmup):
        jax.block_until_ready(fn())
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def epoch_time(make_model, fit_kwargs, n_epochs=5):
    """Median steady-state time of the jitted epoch program that
    ``make_model().fit(epochs=n_epochs, **fit_kwargs)`` runs. Each epoch
    call is waited on; the first (compiling) epoch is dropped, and fit's
    host-side set-up is not counted."""
    from ganmf_tpu.utils.profiling import timed_calls

    require_card()
    model = make_model()
    module, name = EPOCH_PROGRAMS[model.RECOMMENDER_NAME]
    with timed_calls(importlib.import_module(module), name) as calls:
        model.fit(epochs=n_epochs, **fit_kwargs)
    return statistics.median(calls[1:])


def atomic_json_dump(obj, path):
    """Write JSON via temp file + rename so a mid-write crash cannot
    truncate previously recorded results."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(obj, fh, indent=1)
    os.replace(tmp, path)
