"""Distributed SLAM over TCP: frontend/backend process split.

The reference's distributed topology (src/tcp_slam/): a client runs
scan-matching odometry and streams ``(pose, cov, scan)`` frames to a
server that rebuilds scans, maintains the pose graph, optimizes, and
pushes corrected poses back (serverSocket.cpp:58-116, 43-56). The
``oneThread`` variant folds both into one process for testing
(oneThread/main.cpp).

This module reimplements that topology over the native scan-frame
transport (:mod:`..native.api`): the frontend runs the jitted odometry
step per scan; the backend drives the SAME init-free correlative
loop-closure machinery as the in-process facade — the shared
:class:`..runtime.backend.IncrementalBackend` — exactly as the
reference compiles one ``CServerBackend`` into both its TCP and
in-process topologies (serverBackend.h:19-72). Pose updates flow back
and rebase the frontend trajectory (the updateLocalPose/synFromGlobal
back-edge). ``run_loopback`` is the oneThread-style fold (threads, same
wire protocol through localhost TCP).

Wire protocol detail: the frontend streams its RAW odometry pose
(never rebased) so the server's drift/PCM reference stays valid, and
ships the step confidence in the frame's covariance slot — var 0 =
normal, ≥``WEAK_STEP_VAR`` = weak/low-overlap, ≥``FRACTURE_STEP_VAR``
= unrecoverable fracture (the reference's clientFrontend streams
cov[6] the same way, clientFrontend.h:47-53).

For pod-scale SPMD (many chips, one program) see
:mod:`..parallel.distributed`; this module covers the *process/machine*
split with explicit messaging.
"""

from __future__ import annotations

import queue
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np

from ..core import se2
from ..core.scan import LaserModel
from ..native.api import ScanServer, ScanSocket
from ..ops.odometry import _OdoCarry, _step
from ..ops.preprocess import preprocess
from .backend import IncrementalBackend
from .slam import SlamConfig


WEAK_STEP_VAR = 1.0      # [m²] variance stamped on weak/deep-fallback steps
FRACTURE_STEP_VAR = 4.0  # [m²] variance stamped on fractured steps


class Frontend:
    """Client side: local odometry + scan streaming + pose rebase."""

    def __init__(self, sock: ScanSocket, model: LaserModel):
        self.sock = sock
        self.model = model
        self._step_fn = jax.jit(lambda c, s: _step(model, c, s))
        self._carry = None
        self.poses: list[np.ndarray] = []   # corrected trajectory
        self._odo: list[np.ndarray] = []    # raw odometry chain (no rebase)
        self._updates: "queue.Queue" = queue.Queue()
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()

    def _read_loop(self):
        while True:
            frame = self.sock.recv()
            if frame is None:
                break
            if frame[0] == "pose":
                self._updates.put(frame)

    def feed_scan(self, ranges, stamp: float = 0.0) -> np.ndarray:
        scan = preprocess(jnp.asarray(ranges, jnp.float32), self.model)
        weak = frac = False
        # Apply pending backend corrections BEFORE stepping: the rebase
        # shifts both the stored poses and the live carry, so the step
        # increment below is computed in one consistent frame. (Applying
        # after the step left the previous pose un-rebased against a
        # rebased carry — every correction injected a jump into the
        # streamed odometry chain, and the server's PCM/cycle checks run
        # through that chain: measured intel-lab loopback ATE 27-39 m
        # from exactly this.)
        self._apply_updates()
        if self._carry is None:
            zero = jnp.zeros(3, jnp.float32)
            self._carry = _OdoCarry(scan, scan, zero, zero, zero)
            pose = odo_pose = np.zeros(3, np.float32)
        else:
            prev = self.poses[-1]
            self._carry, (p, _, _, w, f) = self._step_fn(self._carry, scan)
            # One bulk fetch: three separate np.asarray/bool() casts pay
            # three synchronous device round-trips per scan.
            pose, w_np, f_np = jax.device_get((p, w, f))
            pose = np.asarray(pose)
            weak, frac = bool(w_np), bool(f_np)
            # Raw chain: integrate the step relative, ignoring rebases.
            rel = se2.np_relative(prev[None], pose[None])[0]
            odo_pose = se2.np_compose(
                self._odo[-1][None], rel[None]
            )[0].astype(np.float32)
        self.poses.append(pose)
        self._odo.append(odo_pose)
        var = (
            FRACTURE_STEP_VAR if frac else (WEAK_STEP_VAR if weak else 0.0)
        )
        cov = np.asarray([var, var, var, 0.0, 0.0, 0.0], np.float32)
        self.sock.send_scan(
            np.asarray(ranges, np.float32), pose=odo_pose, cov=cov,
            stamp=stamp,
        )
        return pose

    def _apply_updates(self):
        """Rebase on the newest backend correction (bigChange semantics:
        the delta between old and optimized anchor pose is applied to
        everything after the anchor, threadGlobal1.cpp:51-60)."""
        latest = None
        while not self._updates.empty():
            latest = self._updates.get_nowait()
        if latest is None or self._carry is None:
            return
        _, anchor_id, new_pose, _ = latest
        if anchor_id >= len(self.poses):
            return
        old = jnp.asarray(self.poses[anchor_id])
        new = jnp.asarray(new_pose)
        delta = se2.compose(new, se2.inverse(old))
        for t in range(anchor_id, len(self.poses)):
            self.poses[t] = np.asarray(
                se2.compose(delta, jnp.asarray(self.poses[t]))
            )
        self._carry = self._carry._replace(
            last_gpose=se2.compose(delta, self._carry.last_gpose),
            ref_gpose=se2.compose(delta, self._carry.ref_gpose),
        )

    def close(self):
        self.sock.close()


class Backend:
    """Server side: collect scans, close loops, push corrections.

    Runs the shared :class:`IncrementalBackend` — identical machinery
    (bank/tried persistence, drift-aware init-free correlative
    verification, robust solve) to ``OnlineSlam._backend_round``."""

    def __init__(self, conn: ScanSocket, model: LaserModel,
                 cfg: SlamConfig = SlamConfig(), optimize_every: int = 8):
        self.conn = conn
        self.model = model
        self.cfg = cfg
        self.optimize_every = optimize_every
        self._backend = IncrementalBackend(model, cfg)
        self.n_loops_total = 0

    def run(self, max_scans: int | None = None) -> np.ndarray:
        """Serve until EOF (or ``max_scans``); returns anchor poses."""
        all_scans, poses, odo = [], [], []
        weak: list[bool] = []
        frac: list[bool] = []
        t = 0
        stride = self.cfg.anchor_stride
        n_anchors = 0
        while max_scans is None or t < max_scans:
            frame = self.conn.recv()
            if frame is None or frame[0] != "scan":
                break
            _, ranges, pose, cov, _ = frame
            scan = preprocess(jnp.asarray(ranges), self.model)
            all_scans.append(scan)
            # The streamed pose is the client's RAW odometry pose; the
            # working estimate integrates its INCREMENTS onto the
            # corrected tail — appending the raw pose directly would mix
            # pre- and post-rebase frames after the first backend round
            # (measured: intel-lab ATE 27 m from exactly that).
            odo.append(np.asarray(pose))
            if len(odo) == 1:
                poses.append(odo[0])
            else:
                rel = se2.np_relative(odo[-2][None], odo[-1][None])[0]
                poses.append(
                    se2.np_compose(poses[-1][None], rel[None])[0].astype(
                        np.float32
                    )
                )
            var = (
                float(np.asarray(cov).reshape(-1)[0])
                if cov is not None else 0.0
            )
            weak.append(var >= 0.5 * WEAK_STEP_VAR)
            frac.append(var >= 0.5 * (WEAK_STEP_VAR + FRACTURE_STEP_VAR))
            if t % stride == 0:
                n_anchors += 1
                if (
                    n_anchors >= IncrementalBackend.MIN_GROUPS
                    and n_anchors % self.optimize_every == 0
                ):
                    rebased = self._backend.round(
                        all_scans, poses, odo, weak, frac
                    )
                    if rebased is not None:
                        poses = [rebased[i] for i in range(rebased.shape[0])]
                        self.n_loops_total = self._backend.n_loops
                        last_anchor = ((len(poses) - 1) // stride) * stride
                        self.conn.send_pose(last_anchor, poses[last_anchor])
            t += 1
        # Final full round over the complete session (the reference's
        # server keeps optimizing after the stream ends, main_server.cpp).
        rebased = self._backend.round(
            all_scans, poses, odo, weak, frac
        )
        if rebased is not None:
            poses = [rebased[i] for i in range(rebased.shape[0])]
            self.n_loops_total = self._backend.n_loops
        self.poses = np.stack(poses) if poses else np.zeros((0, 3))
        aidx = np.arange(0, len(poses), stride)
        return self.poses[aidx] if len(poses) else np.zeros((0, 3))


def run_loopback(
    model: LaserModel,
    ranges: np.ndarray,
    cfg: SlamConfig = SlamConfig(),
    port: int = 0,
    scan_walls: list | None = None,
) -> tuple[np.ndarray, int]:
    """oneThread-style fold: frontend and backend in one process,
    speaking the real wire protocol over localhost. Returns
    ``(backend trajectory [T, 3], backend loop count)`` — the backend's
    trajectory carries the loop-closure corrections (the frontend's
    local copy only sees the piggy-backed anchor updates). If given,
    ``scan_walls`` receives each scan's client-side wall [s], from
    ``feed_scan`` call to pose in hand."""
    import socket as pysock

    if port == 0:
        s = pysock.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()

    server = ScanServer(port)
    result = {}

    def backend_main():
        try:
            conn = server.accept(timeout_ms=10_000)
            be = Backend(conn, model, cfg)
            be.run(max_scans=len(ranges))
            result["poses"] = be.poses
            result["loops"] = be.n_loops_total
            conn.close()
        except BaseException as e:  # re-raised in the caller's thread
            result["error"] = e

    th = threading.Thread(target=backend_main)
    th.start()
    fe = Frontend(ScanSocket.connect("127.0.0.1", port), model)
    for r in ranges:
        t0 = time.perf_counter()
        fe.feed_scan(r)
        if scan_walls is not None:
            scan_walls.append(time.perf_counter() - t0)
    # The backend stops after len(ranges) scans; keep the client socket
    # open until then, since a backend that lags behind the stream still
    # sends pose corrections.
    th.join(timeout=600)
    fe.close()
    server.close()
    if th.is_alive():
        raise TimeoutError("loopback backend did not finish in 600 s")
    if "error" in result:
        raise RuntimeError("loopback backend failed") from result["error"]
    return result["poses"], result["loops"]
