"""Two-process ``jax.distributed`` integration test.

The reference proves its distribution story by actually running its TCP
client/server split on two processes (src/tcp_slam/main_server.cpp:10-31
binds localhost; oneThread/ folds the same classes into one process).
The JAX-native equivalent is two OS processes joining one JAX runtime
via ``laser_slam_tpu.parallel.multihost.initialize`` and executing the
distributed backend step across the joint 2×2-device CPU mesh.
"""

import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tools", "multiproc_worker.py")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_backend_step():
    coordinator = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    # Children configure their own platform/devices; drop the test
    # session's forced settings.
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_PLATFORMS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, coordinator, "2", str(pid)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
            cwd=REPO,
        )
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"MULTIPROC_OK pid={pid}/2 devices=4" in out, out
    # Both processes must agree on the replicated solve result.
    line0 = [l for l in outs[0].splitlines() if "MULTIPROC_OK" in l][0]
    line1 = [l for l in outs[1].splitlines() if "MULTIPROC_OK" in l][0]
    assert line0.split("chi2=")[1] == line1.split("chi2=")[1]
