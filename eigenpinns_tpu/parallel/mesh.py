"""Device meshes and sharding helpers.

The reference is single-device (`torch.device(...)`,
src/multigrid_model.py:20); scaling here follows the plan of
SURVEY.md section 2.3: a 1-D (or user-shaped) `jax.sharding.Mesh`, node /
collocation axes sharded across devices ("data" axis), model parameters
replicated, k x k Gram/Rayleigh reductions and gradient psums inserted by
XLA GSPMD from sharding constraints over ICI.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, axis_names=("data",),
              shape=None) -> Mesh:
    """A device mesh over the first n_devices (default: all)."""
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = np.asarray(devices[:n_devices])
    if shape is None:
        shape = (n_devices,)
    return Mesh(devices.reshape(shape), axis_names)


def node_sharding(mesh: Mesh, axis: str = "data") -> NamedSharding:
    """Shard the leading (node/collocation) axis across the mesh."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_to_multiple(x, m: int, axis: int = 0):
    """Pad axis length to a multiple of m (sharding needs even splits).

    Returns (padded, original_length).
    """
    import jax.numpy as jnp

    n = x.shape[axis]
    pad = (-n) % m
    if pad == 0:
        return x, n
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return jnp.pad(x, widths), n


def shard_array(x, mesh: Mesh, spec: P):
    """Place an array with an explicit sharding."""
    return jax.device_put(x, NamedSharding(mesh, spec))
