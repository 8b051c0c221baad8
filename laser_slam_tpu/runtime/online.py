"""Online incremental SLAM facade.

The role of the reference's ``CSlam`` 3-thread pipeline (src/slam/slam.h,
threadLocal1/threadLocal2/threadGlobal1) and the deployable ``CSlamV1``
callback facade (src/version1/slam_v1.h:44-130): feed scans (and
optionally odometry/beacon readings) one at a time, get poses out, with
the backend (loop closure + graph solve) folded in periodically.

Where the reference moves data between Qt threads with mutex-guarded
buffer swaps, here the frontend step is one compiled device program and
the backend round is another; the host merely sequences them. Callbacks
mirror the ``SLAM_CallBack`` table entries that matter for the library
surface (pose, map update).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..core import se2
from ..core.scan import LaserModel, Scan
from ..fusion import ukf
from ..ops.odometry import _OdoCarry, _step
from ..ops.preprocess import preprocess
from ..runtime.slam import SlamConfig


@dataclasses.dataclass
class OnlineSlam:
    """Incremental SLAM session.

    Usage::

        slam = OnlineSlam(model)
        for ranges, t in sensor:
            pose = slam.feed_scan(ranges)
        grid = slam.render_map()
    """

    model: LaserModel
    cfg: SlamConfig = SlamConfig()
    optimize_every: int = 10            # anchors between backend rounds
    on_pose: Callable | None = None     # cbDataFusionResult analog
    use_fusion: bool = False
    incremental_map: bool = True        # live MapService grid (O(1)/scan)
    map_resolution: float = 0.1
    map_half_size: float = 60.0
    async_backend: bool = False         # run backend rounds on a host
    #                                     thread (the reference's
    #                                     ThreadGlobal1 overlap,
    #                                     slam.cpp:40-67): feed_scan
    #                                     never blocks on a round;
    #                                     corrections apply on completion

    def __post_init__(self):
        # Scheduler bookkeeping (deterministic — tests assert on these,
        # not on wall-clock): requested = backend rounds asked for;
        # started = worker rounds actually launched; applied = results
        # spliced back; coalesced = requests that found a round already
        # in flight and were folded into ONE pending follow-up (the
        # backlog is bounded at a single pending round by construction).
        self.async_stats = {
            "requested": 0, "started": 0, "applied": 0, "coalesced": 0,
            # Scans fed between a round's snapshot and its application —
            # > 0 proves the frontend ran while the backend was in
            # flight (the deterministic overlap witness; wall-clock
            # ratios flake on loaded CI hosts).
            "overlap_scans_max": 0,
        }
        self._pending_round = False
        self._carry: _OdoCarry | None = None
        self._step_fn = jax.jit(lambda c, s: _step(self.model, c, s))
        self._scans: list[Scan] = []        # anchor scans (host refs)
        self._poses: list[np.ndarray] = []  # per-scan poses
        self._weak: list[bool] = []
        self._fracture: list[bool] = []
        # Raw odometry chain (never rebased) — the PCM/drift reference
        # for the correlative backend, like slam_offline's
        # odo_anchor_poses.
        self._odo_chain: list[np.ndarray] = []
        # Correlative-backend session state (submap clouds, loop bank,
        # tried-pair matrix) lives in the shared incremental backend.
        from .backend import IncrementalBackend

        self._backend = IncrementalBackend(self.model, self.cfg)
        self._bg_thread = None              # in-flight async round
        self._bg_result = None              # (rebased, t_snapshot)
        self._t = 0
        self._fusion = ukf.init(jnp.zeros(3), 0.01) if self.use_fusion else None
        self._imap = None
        if self.incremental_map:
            from ..mapping.incremental import IncrementalMapper

            self._imap = IncrementalMapper(
                self.model,
                resolution=self.map_resolution,
                half_size=self.map_half_size,
            )

    # -- sensor inputs (receMainSickSLAM / receODO / receBN analogs) ----

    def feed_scan(self, ranges) -> np.ndarray:
        """Process one scan; returns the current global pose [3]."""
        if self.async_backend:
            self._poll_backend()
        scan = preprocess(jnp.asarray(ranges), self.model)
        # Cache the preprocessed scan so downstream consumers (local map,
        # obstacle layer) reuse it instead of re-running preprocess.
        self.last_scan = scan
        if self._carry is None:
            zero = jnp.zeros(3, jnp.float32)
            self._carry = _OdoCarry(
                ref=scan, last=scan, ref_gpose=zero, last_gpose=zero,
                prior_rel=zero,
            )
            self._poses.append(np.zeros(3, np.float32))
            self._weak.append(False)
            self._fracture.append(False)
            self._odo_chain.append(np.zeros(3, np.float32))
            self._maybe_anchor(scan, 0)
            self._t = 1
            if self._imap is not None:
                self._imap.add(scan, self._poses[-1])
            return self._poses[-1]

        self._carry, (pose, switched, discarded, weak, frac) = self._step_fn(
            self._carry, scan
        )
        # One bulk fetch per scan (separate casts pay a device
        # round-trip each), and the odometry chain update runs in host
        # numpy.
        pose_np, weak_np, frac_np = jax.device_get((pose, weak, frac))
        pose_np = np.asarray(pose_np)
        self._fracture.append(bool(frac_np))
        rel_step = se2.np_relative(self._poses[-1][None], pose_np[None])[0]
        self._odo_chain.append(
            se2.np_compose(
                self._odo_chain[-1][None], rel_step[None]
            )[0].astype(np.float32)
        )
        self._poses.append(pose_np)
        self._weak.append(bool(weak_np))
        self._maybe_anchor(scan, self._t)
        self._t += 1
        if self._imap is not None:
            self._imap.add(scan, pose_np)

        if self.use_fusion:
            rel = se2.relative(
                jnp.asarray(self._poses[-2]), jnp.asarray(pose_np)
            )
            self._fusion, self._fusion_t = ukf.fusion_step(
                self._fusion,
                ukf.FusionInputs(
                    odom_rel=rel,
                    odom_valid=jnp.asarray(True),
                    slam_pose=jnp.asarray(pose_np),
                    slam_valid=jnp.asarray(True),
                    beacon_xy=jnp.zeros(2),
                    beacon_valid=jnp.asarray(False),
                    slam_t=jnp.asarray(float(self._t)),
                ),
                filter_t=getattr(self, "_fusion_t", -jnp.inf),
            )
        if self.on_pose is not None:
            self.on_pose(pose_np)
        return pose_np

    def feed_beacon(self, xy) -> None:
        if self._fusion is not None:
            self._fusion = ukf.update_partial(
                self._fusion, (0, 1), jnp.asarray(xy), 0.25
            )

    def feed_gps(self, obs, r: float = 1.0) -> None:
        """GPS position observe with timestamp gating.

        ``obs`` is an :class:`..io.gps.GpsObservation` (ENU assumed
        aligned with the SLAM frame at session start) or a bare
        ``(east, north)`` pair. The reference feeds GPS into the UKF
        through threadFusion's freshness-gated observes
        (threadFusion.cpp:89-155, GPS model config.hpp:180-197); here a
        stale or out-of-order fix (timestamp ≤ the last consumed one)
        is skipped the same way.
        """
        if self._fusion is None:
            return
        t = None
        if hasattr(obs, "east"):
            xy = jnp.asarray([obs.east, obs.north], jnp.float32)
            t = float(obs.t)
        else:
            xy = jnp.asarray(obs, jnp.float32)[:2]
        if t is not None:
            if t <= getattr(self, "_gps_t", -float("inf")):
                return
            self._gps_t = t
        self._fusion = ukf.update_partial(self._fusion, (0, 1), xy, r)

    # -- state access ---------------------------------------------------

    @property
    def pose(self) -> np.ndarray:
        if self._fusion is not None:
            return np.asarray(self._fusion.mean)
        return self._poses[-1] if self._poses else np.zeros(3, np.float32)

    @property
    def trajectory(self) -> np.ndarray:
        return np.stack(self._poses) if self._poses else np.zeros((0, 3))

    def render_map(self, resolution: float = 0.05):
        from ..mapping.occupancy import (
            empty_grid, integrate_scans, spec_for_trajectory,
        )

        # The live incremental grid is already up to date — no rebuild —
        # but it has a fixed arena (center ± half_size, rebased past the
        # bigChange gate); a trajectory that left the arena would render
        # silently truncated, so fall back to a full-extent rebuild then
        # (ADVICE r2).
        if self._imap is not None and resolution == self.map_resolution:
            if self._imap.covers(self.trajectory):
                return self._imap.grid

        traj = self.trajectory
        spec = spec_for_trajectory(traj, self.model.max_range, resolution)
        scans = jax.tree.map(lambda *xs: jnp.stack(xs), *self._all_scans)
        return integrate_scans(
            empty_grid(spec), self.model, scans, jnp.asarray(traj)
        )

    def local_map(self, pose=None, half_cells: int = 64):
        """Egocentric window of the live grid (AmbientGridMap role);
        O(1) — a dynamic_slice, never a rebuild."""
        if self._imap is None:
            raise RuntimeError("incremental_map is disabled")
        if pose is None:
            pose = self.pose
        return self._imap.local_crop(pose, half_cells)

    # -- checkpoint / resume ---------------------------------------------
    # The reference has no checkpointing (persistence = final logs only);
    # here a session snapshots to one .npz and resumes mid-log.

    def save(self, path: str) -> None:
        from ..utils.checkpoint import save_pytree

        state = {
            "poses": np.stack(self._poses) if self._poses else np.zeros((0, 3)),
            "weak": np.asarray(self._weak, bool),
            "fracture": np.asarray(self._fracture, bool),
            "odo_chain": (
                np.stack(self._odo_chain) if self._odo_chain
                else np.zeros((0, 3))
            ),
            "carry": self._carry,
            "all_scans": (
                jax.tree.map(lambda *xs: jnp.stack(xs), *self._all_scans)
                if getattr(self, "_all_scans", None)
                else None
            ),
        }
        save_pytree(
            path, state,
            meta={
                "t": self._t,
                "n_anchors": len(self._scans),
                "anchor_stride": self.cfg.anchor_stride,
                "model": self.model.name,
            },
        )

    @classmethod
    def resume(cls, model: LaserModel, path: str, **kwargs) -> "OnlineSlam":
        from ..ops.odometry import _OdoCarry
        from ..utils.checkpoint import load_pytree

        flat, meta = load_pytree(path)
        if meta["model"] != model.name:
            raise ValueError(
                f"checkpoint is for model {meta['model']}, got {model.name}"
            )
        slam = cls(model, **kwargs)
        t = int(meta["t"])
        poses = flat["poses"]
        slam._poses = [poses[i] for i in range(poses.shape[0])]
        slam._weak = [bool(b) for b in flat["weak"]]
        slam._fracture = [bool(b) for b in flat.get(
            "fracture", np.zeros(poses.shape[0], bool)
        )]
        oc = flat.get("odo_chain")
        if oc is None or oc.shape[0] != poses.shape[0]:
            # Old checkpoints: fall back to the saved trajectory as the
            # odometry reference (pre-rebase detail is lost).
            oc = poses
        slam._odo_chain = [np.asarray(oc[i]) for i in range(oc.shape[0])]
        slam._t = t
        stride = int(meta["anchor_stride"])
        ranges = flat["all_scans/ranges"]
        scans = [
            Scan(
                ranges=jnp.asarray(ranges[i]),
                bad=jnp.asarray(flat["all_scans/bad"][i]),
                seg=jnp.asarray(flat["all_scans/seg"][i]),
            )
            for i in range(ranges.shape[0])
        ]
        slam._all_scans = scans
        slam._scans = [scans[i] for i in range(0, len(scans), stride)][
            : int(meta["n_anchors"])
        ]
        slam._carry = _OdoCarry(
            ref=Scan(
                jnp.asarray(flat["carry/ref/ranges"]),
                jnp.asarray(flat["carry/ref/bad"]),
                jnp.asarray(flat["carry/ref/seg"]),
            ),
            last=Scan(
                jnp.asarray(flat["carry/last/ranges"]),
                jnp.asarray(flat["carry/last/bad"]),
                jnp.asarray(flat["carry/last/seg"]),
            ),
            ref_gpose=jnp.asarray(flat["carry/ref_gpose"]),
            last_gpose=jnp.asarray(flat["carry/last_gpose"]),
            prior_rel=jnp.asarray(flat["carry/prior_rel"]),
        )
        return slam

    # -- internals ------------------------------------------------------

    def _maybe_anchor(self, scan: Scan, t: int) -> None:
        if t % self.cfg.anchor_stride == 0:
            self._scans.append(scan)
            if (
                len(self._scans) >= 8
                and (len(self._scans) % self.optimize_every) == 0
            ):
                if self.async_backend:
                    self._schedule_backend()
                else:
                    self._backend_round()
        if not hasattr(self, "_all_scans"):
            self._all_scans = []
        self._all_scans.append(scan)

    def _backend_round(self) -> None:
        """Init-free correlative loop closure + robust solve over the
        session so far — the SAME machinery as ``slam_offline``
        (run_correlative_rounds), driven incrementally through the
        shared :class:`..runtime.backend.IncrementalBackend` (also the
        TCP server's backend, matching the reference's one-backend-all-
        topologies structure, serverBackend.h:19-72): the loop bank and
        the tried-pair matrix persist across rounds, anchors live in
        power-of-two capacity buckets so compiled programs are reused as
        the session grows, and each round spends its candidate budget on
        pairs not yet verified. This replaces the round-1 ICP-only
        ``_loop_round`` (fixed 2 m radius — provably unable to close
        drift-sized loops); the reference's counterpart is the full loop
        search on every submap insert (threadGlobal1.cpp:62-128 →
        addMapNodeCov, MapGraph.cpp:1272-1484)."""
        rebased = self._backend.round(
            self._all_scans, self._poses, self._odo_chain,
            self._weak, self._fracture,
        )
        if rebased is None:
            return
        self.n_loops = self._backend.n_loops
        self._apply_rebased(rebased, rebased.shape[0])

    # -- async backend (frontend/backend overlap) -----------------------
    # The reference overlaps its frontend and backend threads
    # (ThreadLocal1 keeps matching while ThreadGlobal1 optimizes,
    # slam.cpp:40-67, with the synFromGlobal rebase back-edge). Here the
    # backend round runs on ONE host worker thread against an immutable
    # snapshot of the session (per-scan records only ever append, and
    # np arrays are never mutated in place); the main thread applies the
    # result at the next feed_scan and extends the correction to scans
    # that arrived while the round was in flight.

    def _schedule_backend(self) -> None:
        self.async_stats["requested"] += 1
        if self._bg_thread is not None and self._bg_thread.is_alive():
            # Single-flight with a BOUNDED backlog: fold this request
            # into one pending follow-up round launched when the
            # in-flight one completes. Plain skipping (r4) silently
            # searched fewer loops under load; queueing every request
            # would let the backlog grow without bound.
            self._pending_round = True
            self.async_stats["coalesced"] += 1
            return
        self._poll_backend()             # apply any finished result first
        self._launch_round()

    def _launch_round(self) -> None:
        import threading

        snap = (
            list(self._all_scans), list(self._poses),
            list(self._odo_chain), list(self._weak), list(self._fracture),
        )
        t_snap = len(snap[1])

        def work():
            rebased = self._backend.round(*snap)
            if rebased is not None:
                self._bg_result = (rebased, t_snap)

        self.async_stats["started"] += 1
        self._bg_thread = threading.Thread(target=work, daemon=True)
        self._bg_thread.start()

    def _poll_backend(self) -> None:
        res = self._bg_result
        if res is None:
            if (
                self._pending_round
                and self._bg_thread is not None
                and not self._bg_thread.is_alive()
            ):
                # The in-flight round finished without a correction;
                # honor the pending request now.
                self._pending_round = False
                self._launch_round()
            return
        self._bg_result = None
        rebased, t_snap = res
        self.n_loops = self._backend.n_loops
        self.async_stats["applied"] += 1
        self.async_stats["overlap_scans_max"] = max(
            self.async_stats["overlap_scans_max"], len(self._poses) - t_snap
        )
        self._apply_rebased(rebased, t_snap)
        if self._pending_round and not self._bg_thread.is_alive():
            self._pending_round = False
            self._launch_round()

    def flush(self, final_round: bool = True) -> None:
        """Wait for the in-flight async round (if any), apply it (plus
        the one pending follow-up, if a request was coalesced), then run
        one synchronous round over the complete session — scans fed
        while the last async round was in flight have not been searched
        for loops yet (the reference's server keeps optimizing after the
        stream ends, tcp_slam/main_server.cpp)."""
        while self._bg_thread is not None and (
            self._bg_thread.is_alive() or self._bg_result is not None
            or self._pending_round
        ):
            self._bg_thread.join()
            self._poll_backend()
        if final_round:
            self._backend_round()

    def _apply_rebased(self, rebased: np.ndarray, t_snap: int) -> None:
        """Splice an optimized trajectory back into the live session:
        scans the backend saw take its poses; scans that arrived later
        are shifted by the correction at the last snapshot pose (the
        bigChange delta, threadGlobal1.cpp:51-60)."""
        n_now = len(self._poses)
        if n_now > t_snap:
            old_last = self._poses[t_snap - 1]
            delta = se2.np_compose(
                rebased[t_snap - 1], se2.np_inverse(old_last)
            ).astype(np.float32)
            tail = se2.np_compose(
                delta[None], np.stack(self._poses[t_snap:n_now])
            ).astype(np.float32)
            new_poses = [rebased[t] for t in range(t_snap)] + [
                tail[i] for i in range(tail.shape[0])
            ]
        else:
            new_poses = [rebased[t] for t in range(rebased.shape[0])]
        self._poses = new_poses
        full = np.stack(self._poses)
        # Rebuild the live map only when the optimization actually moved
        # poses (bigChange gate) — per-scan map cost stays O(1).
        if self._imap is not None and self._imap.needs_rebase(full):
            self._imap.rebase(full)
        # Rebase the live frontend carry.
        if self._carry is not None:
            self._carry = self._carry._replace(
                last_gpose=jnp.asarray(self._poses[-1]),
                ref_gpose=jnp.asarray(
                    se2.compose(
                        jnp.asarray(self._poses[-1]),
                        se2.inverse(self._carry.prior_rel),
                    )
                ),
            )
