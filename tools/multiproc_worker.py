"""Worker for the two-process ``jax.distributed`` test.

Each process contributes its local CPU devices to one joint JAX runtime
(the JAX-native counterpart of the reference's cross-machine TCP split,
src/tcp_slam/serverSocket.cpp:58-116) and runs the full distributed SLAM
backend step — sharded scan matching feeding a replicated pose-graph
solve — across the joint mesh.

Usage: python tools/multiproc_worker.py <coordinator> <nprocs> <pid>
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> None:
    coordinator, nprocs, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=2"
    ).strip()

    import jax

    # Force the CPU platform via the config API too (env vars are
    # latched if jax was imported earlier), same as tests/conftest.py.
    jax.config.update("jax_platforms", "cpu")

    from laser_slam_tpu.parallel import multihost

    multihost.initialize(
        coordinator=coordinator, num_processes=nprocs, process_id=pid
    )
    assert jax.process_count() == nprocs, jax.process_count()
    n_global = len(jax.devices())
    n_local = len(jax.local_devices())
    assert n_global == nprocs * n_local, (n_global, n_local)

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    sys.path.insert(0, REPO)
    from __graft_entry__ import _synthetic_pairs
    from laser_slam_tpu.core import se2
    from laser_slam_tpu.core.scan import LMS211
    from laser_slam_tpu.graph.solve import PoseGraph
    from laser_slam_tpu.parallel.distributed import training_step
    from laser_slam_tpu.parallel.mesh import DATA_AXIS

    model = LMS211
    mesh = multihost.global_mesh()
    b = 2 * n_global

    # Identical deterministic data on every process; each contributes its
    # local slice of the globally-sharded batch.
    ref, cur, _ = _synthetic_pairs(model, b, seed=0)
    shard = NamedSharding(mesh, P(DATA_AXIS))

    def make_global(x):
        x = np.asarray(x)
        lo = pid * (b // nprocs)
        hi = lo + b // nprocs
        return jax.make_array_from_process_local_data(shard, x[lo:hi])

    ref = jax.tree.map(make_global, ref)
    cur = jax.tree.map(make_global, cur)

    # Replicated pose graph (chain), identical on every process.
    repl = NamedSharding(mesh, P())
    v = b + 4
    rng = np.random.default_rng(0)
    poses = np.cumsum(rng.normal(0, 0.1, (v, 3)).astype(np.float32), axis=0)
    e = 2 * b
    ei = np.arange(e, dtype=np.int32) % (v - 1)
    ej = ei + 1
    meas = np.asarray(
        se2.relative(jnp.asarray(poses[ei]), jnp.asarray(poses[ej]))
    ).astype(np.float32)
    info = np.tile(np.eye(3, dtype=np.float32) * 50.0, (e, 1, 1))

    def replicate(x):
        x = np.asarray(x)
        return jax.make_array_from_callback(
            x.shape, repl, lambda idx: x[idx]
        )

    graph = PoseGraph(
        poses=replicate(poses),
        v_active=replicate(np.ones(v, bool)),
        i=replicate(ei),
        j=replicate(ej),
        meas=replicate(meas),
        info=replicate(info),
        e_active=replicate(np.ones(e, bool)),
    )

    out_poses, chi, fail = training_step(mesh, model, ref, cur, graph)
    n_fail = jax.jit(
        lambda f: jnp.sum(f.astype(jnp.int32)), out_shardings=repl
    )(fail)
    jax.block_until_ready(out_poses)
    chi_v = float(np.asarray(jax.device_get(chi)))
    fails = int(np.asarray(jax.device_get(n_fail)))
    assert out_poses.shape == (v, 3)
    assert np.isfinite(chi_v)
    assert fails == 0, f"{fails}/{b} trivial pairs failed"
    print(
        f"MULTIPROC_OK pid={pid}/{nprocs} devices={n_global} "
        f"pairs={b} chi2={chi_v:.4f} fails={fails}",
        flush=True,
    )
    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
