"""Multi-host execution entry point.

The reference scales across machines with a hand-rolled TCP split
(client frontends → server backend, src/tcp_slam/serverSocket.cpp:58-116
— still shipped here as :mod:`..runtime.tcp_slam` for wire-level
parity). The JAX-native way is single-controller JAX: every host runs
the *same* program, ``jax.distributed.initialize`` wires the processes
into one runtime, and the global mesh spans all hosts' devices; XLA
routes the collectives over the links between them.

Usage (same script on every host)::

    from laser_slam_tpu.parallel.multihost import initialize, global_mesh

    initialize(coordinator="10.0.0.1:8476", num_processes=2,
               process_id=int(os.environ["HOST_ID"]))
    mesh = global_mesh()                    # spans all hosts' chips
    # ... shard loop-verification batches / the graph solve over it

Under a cluster launcher JAX knows (Slurm, Open MPI), ``initialize()``
with no arguments autodetects everything; elsewhere pass all three.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

from .mesh import DATA_AXIS

_initialized = False


def initialize(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Join this process into a multi-host JAX runtime (idempotent).

    With no arguments, relies on the environment (cluster launcher /
    ``JAX_COORDINATOR_ADDRESS`` etc.); explicit arguments support bare
    clusters — the role of the reference's hand-entered server IP/port
    dialog (tcp_slam main_client/main_server).
    """
    global _initialized
    if _initialized:
        return
    kwargs = {}
    if coordinator is not None:
        kwargs["coordinator_address"] = coordinator
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)
    _initialized = True


def global_mesh() -> Mesh:
    """1D data mesh over every device of every participating host."""
    return Mesh(np.asarray(jax.devices()), (DATA_AXIS,))


def is_primary() -> bool:
    """True on the process that should do host-side orchestration / IO
    (the reference's 'server' role)."""
    return jax.process_index() == 0
