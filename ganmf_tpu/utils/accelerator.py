"""The accelerator a measurement runs on.

Every timing this repository reports comes from an NVIDIA GPU and names
it: ``require_gpu`` refuses to measure anything else, and ``card_line``
reads the card's name and power limit, which bound what the card can
reach under load.
"""

from __future__ import annotations

import subprocess

import jax


def require_gpu():
    """The first JAX device, which must be a GPU. Raises SystemExit
    otherwise: a timing taken on the CPU is not a device measurement."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"needs an NVIDIA GPU; JAX's first device is {dev.platform!r}"
            f" ({dev.device_kind})")
    return dev


def card_line() -> str:
    """``nvidia-smi``'s name and power-limit line for the card(s), e.g.
    ``NVIDIA H100 80GB HBM3, 700.00 W``. Raises if it cannot be read."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    if not out:
        raise RuntimeError("nvidia-smi printed no name/power.limit line")
    return out
