"""Device-mesh helpers for multi-chip execution.

The reference distributes SLAM across machines with a hand-rolled Qt TCP
protocol (src/tcp_slam/serverSocket.cpp:58-116: frontends stream scan
frames up, the backend pushes optimized poses down). The JAX-native
equivalent is SPMD over a ``jax.sharding.Mesh``: scan batches and graph
edges are sharded over a ``"data"`` axis, XLA inserts the ICI collectives
(psum/all-gather) for the reduced pose-graph solve, and "topology
folding" for tests (the role of src/oneThread/) is just running the same
program on a virtual CPU mesh.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"


def make_mesh(n_devices: int | None = None) -> Mesh:
    """1D data-parallel mesh over the first ``n_devices`` devices."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (DATA_AXIS,))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (batch) axis across the mesh."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(mesh: Mesh, tree):
    """Place every leaf of a pytree with its leading axis sharded."""
    s = batch_sharding(mesh)
    return jax.tree.map(lambda x: jax.device_put(x, s), tree)


def pad_to_multiple(tree, multiple: int, axis: int = 0):
    """Pad leading axis to a multiple (shardable size); returns
    ``(padded_tree, original_length)``."""
    lengths = {np.shape(x)[axis] for x in jax.tree.leaves(tree)}
    (n,) = lengths
    pad = (-n) % multiple
    if pad == 0:
        return tree, n

    def _pad(x):
        widths = [(0, 0)] * x.ndim
        widths[axis] = (0, pad)
        return np.pad(np.asarray(x), widths, mode="edge")

    return jax.tree.map(_pad, tree), n
