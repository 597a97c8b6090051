"""Multi-process runtime initialization and the collective facade.

The reference is single-process (SURVEY §2.9/§5.8); this module is the
multi-process runtime layer it never had. ``initialize`` wires
``jax.distributed`` for multi-host runs — after it, every process sees the
global device set and ``make_mesh(n_slices=...)`` lays a (slice, data,
model) mesh whose slice axis spans the hosts. Single-process stays the
no-op default: nothing here needs calling for one host.

All cross-device communication in the framework goes through GSPMD
shardings or the named collectives below — never through backend-specific
primitives — so the same program runs on one device, one host, or several
hosts unchanged.
"""

from __future__ import annotations

import os
from typing import Optional

import jax

_initialized = False


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids=None,
) -> None:
    """Join a multi-process JAX runtime (no-op when single-process).

    Arguments mirror ``jax.distributed.initialize``; all of them default
    from the standard environment (``JAX_COORDINATOR_ADDRESS``,
    ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``) so launchers can configure
    the cluster purely through env vars. Calling with no configuration at all
    in a single-process run does nothing.
    """
    global _initialized
    if _initialized:
        return
    coordinator_address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return  # single-process default
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    _initialized = True


def is_initialized() -> bool:
    return _initialized


def process_count() -> int:
    return jax.process_count()


def process_index() -> int:
    return jax.process_index()


def shutdown() -> None:
    global _initialized
    if _initialized:
        jax.distributed.shutdown()
        _initialized = False


# -- named-axis collectives ----------------------------------------------------
# Thin facade so model code names the communication intent, not the
# primitive; usable inside shard_map bodies over a MeshPlan's axes.

def psum(x, axis):
    return jax.lax.psum(x, axis)


def pmean(x, axis):
    return jax.lax.pmean(x, axis)


def pmax(x, axis):
    return jax.lax.pmax(x, axis)


def all_gather(x, axis, *, tiled_axis: int = 0):
    return jax.lax.all_gather(x, axis, axis=tiled_axis, tiled=True)


def reduce_scatter(x, axis, *, scatter_axis: int = 0):
    return jax.lax.psum_scatter(x, axis, scatter_dimension=scatter_axis, tiled=True)


def ppermute_shift(x, axis, shift: int = 1):
    """Ring shift along a mesh axis (building block for pipelined merges)."""
    n = jax.lax.axis_size(axis)
    perm = [(i, (i + shift) % n) for i in range(n)]
    return jax.lax.ppermute(x, axis, perm)
