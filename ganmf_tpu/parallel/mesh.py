"""Device mesh construction and sharding plans.

The reference is strictly single-process/single-GPU (SURVEY §2.9) — this
layer is new capability: a 2D mesh with a ``data`` axis (users) for
gradient psums and a ``model`` axis (items) for sharding the item
dimension of the URM, the generator's item embeddings and the
discriminator's item-sized layers. The mesh follows the algorithm alone:
the cards of one host are joined all to all, so no axis needs to match a
physical link. An optional outer ``slice`` axis maps multi-process
deployments (several hosts), whose links between hosts are slower:
user-major tensors shard over (slice, data) so that only gradient psums
cross hosts while the item-axis collectives stay inside each host.
Single-device runs degenerate to no-op shardings.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

SLICE_AXIS = "slice"
DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass
class MeshPlan:
    """A mesh plus the canonical shardings of framework tensors."""

    mesh: Mesh

    # -- sharding constructors -------------------------------------------------
    def named(self, *spec) -> NamedSharding:
        return NamedSharding(self.mesh, P(*spec))

    @property
    def user_axes(self):
        """Mesh axes the user dimension shards over: (slice, data) or data."""
        if SLICE_AXIS in self.mesh.axis_names:
            return (SLICE_AXIS, DATA_AXIS)
        return DATA_AXIS

    @property
    def replicated(self) -> NamedSharding:
        return self.named()

    @property
    def urm(self) -> NamedSharding:
        """[U, I] interaction matrix: users x items over (data, model)."""
        return self.named(self.user_axes, MODEL_AXIS)

    @property
    def user_rows(self) -> NamedSharding:
        """[U, ...] user-major tensors (user embeddings) over data."""
        return self.named(self.user_axes)

    @property
    def item_rows(self) -> NamedSharding:
        """[I, ...] item-major tensors (item embeddings, encoder kernel)."""
        return self.named(MODEL_AXIS)

    @property
    def item_cols(self) -> NamedSharding:
        """[..., I] item-minor tensors (decoder kernel, item bias rows)."""
        return self.named(None, MODEL_AXIS)

    @property
    def batch(self) -> NamedSharding:
        """[B, ...] per-step user batches over data."""
        return self.named(self.user_axes)

    def put(self, x, sharding: NamedSharding):
        """``jax.device_put`` with graceful degradation: for every dimension
        whose size does not divide over its assigned mesh axes, keep only the
        longest prefix of axes that does divide (dropping to replicated for
        that dimension if none does). Oddly-sized tensors — e.g. a 50-user
        URM on a 4-way user axis — thus keep every compatible axis sharded
        instead of failing or falling back to full replication."""
        spec = list(sharding.spec)
        changed = False
        for dim, axes in enumerate(spec):
            if axes is None or dim >= x.ndim:
                continue
            names = axes if isinstance(axes, tuple) else (axes,)
            keep = []
            size = 1
            for nm in names:
                size *= self.mesh.shape[nm]
                if x.shape[dim] % size == 0:
                    keep.append(nm)
                else:
                    break
            if len(keep) != len(names):
                spec[dim] = tuple(keep) if keep else None
                changed = True
        if changed:
            sharding = self.named(*spec)
        return jax.device_put(x, sharding)

    @property
    def n_slices(self) -> int:
        return self.mesh.shape[SLICE_AXIS] if SLICE_AXIS in self.mesh.axis_names else 1

    @property
    def n_data(self) -> int:
        return self.mesh.shape[DATA_AXIS]

    @property
    def n_model(self) -> int:
        return self.mesh.shape[MODEL_AXIS]

    @property
    def n_user_shards(self) -> int:
        """Number of shards the user dimension splits into."""
        return self.n_data * self.n_slices


def make_mesh(
    n_data: Optional[int] = None,
    n_model: int = 1,
    n_slices: int = 1,
    devices: Optional[Sequence] = None,
) -> MeshPlan:
    """Build a (data, model) or (slice, data, model) mesh.

    Defaults to all devices on the data axis. ``n_slices * n_data *
    n_model`` must fit in the device count; extra devices are left unused.
    The slice axis is outermost so contiguous device ranges (one host
    each) land on one slice coordinate — collectives over data/model then
    stay inside a host.
    """
    devices = list(devices if devices is not None else jax.devices())
    if n_data is None:
        n_data = max(1, len(devices) // (n_model * n_slices))
    needed = n_slices * n_data * n_model
    if needed > len(devices):
        raise ValueError(
            f"mesh {n_slices}x{n_data}x{n_model} needs {needed} devices, have {len(devices)}"
        )
    if n_slices > 1:
        grid = np.asarray(devices[:needed]).reshape(n_slices, n_data, n_model)
        return MeshPlan(Mesh(grid, (SLICE_AXIS, DATA_AXIS, MODEL_AXIS)))
    grid = np.asarray(devices[:needed]).reshape(n_data, n_model)
    return MeshPlan(Mesh(grid, (DATA_AXIS, MODEL_AXIS)))
