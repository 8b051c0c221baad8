"""Deployable SLAM facade with the reference's callback surface.

JAX equivalent of ``CSlamV1`` (src/version1/slam_v1.h:81-170):
the robot application hands over a callback table, pushes sensor
readings (dual SICK lasers, odometry, beacon, GPS), and receives fused
poses, localization results, obstacle-detection speed caps, maps, and
system error codes through those callbacks — the full 17-entry
``SLAM_CallBack`` table (slam_v1.h:44-63) mapped onto this framework:

==============================  =========================================
reference entry                  here
==============================  =========================================
cbOdometry / cbBNLocation        pull-style in the ref; push-style here
                                 (``feed_odometry`` / ``feed_beacon``)
cbMainSICKForSLAM / ...OD        ``feed_scan_main`` (SLAM + obstacle)
cbMinorSICKForSLAM / ...OD       ``feed_scan_minor`` (obstacle only)
cbSICKA / cbSICKB                ``on_scan_a`` / ``on_scan_b``
cbDataFusionResult               ``on_fused_pose``
cbLocalMap / cbGlobalMap         ``on_local_map`` / ``on_global_map``
cbErrList                        ``on_error`` (codes below)
cbOnlySLAMResult                 ``on_slam_pose``
cbOnlyOdoResult                  ``on_odo_pose``
cbOnlyBNResult                   ``on_beacon_pose``
cbDataFusionAndPC                ``on_pose_and_cloud``
cbLocalization                   ``on_localization``
==============================  =========================================

Work modes mirror ``m_work_model``: ``"mapping"`` runs the online SLAM
pipeline; ``"localization"`` runs the particle filter against a prebuilt
occupancy grid (the ``LocalV1`` thread, slam_v1.h:123-130).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..core import se2
from ..core.scan import LaserModel
from ..localization import particle_filter as pf
from ..localization.raycast import likelihood_field
from ..mapping.occupancy import OccupancyGrid
from ..nav.controller import security_speed_cap
from ..ops.preprocess import preprocess
from .online import OnlineSlam
from .slam import SlamConfig

# System error codes (slam_v1.h:16-22).
SYS_ERR_CTRL_BATTERY_LOW = 1
SYS_ERR_POWER_BATTERY_LOW = 2
SYS_LOST_CNC_SICK_A = 3
SYS_LOST_CNC_SICK_B = 4
SYS_LOST_BN_SERIAL = 5
SYS_LOST_LOW_CTRL_SERIAL = 6


@dataclasses.dataclass
class SlamCallbacks:
    """Optional observers; any subset may be set (SLAM_CallBack parity)."""

    on_fused_pose: Callable[[np.ndarray], None] | None = None
    on_slam_pose: Callable[[np.ndarray], None] | None = None
    on_odo_pose: Callable[[np.ndarray], None] | None = None
    on_beacon_pose: Callable[[np.ndarray], None] | None = None
    on_localization: Callable[[np.ndarray], None] | None = None
    on_pose_and_cloud: Callable[[np.ndarray, np.ndarray], None] | None = None
    on_scan_a: Callable[[np.ndarray], None] | None = None
    on_scan_b: Callable[[np.ndarray], None] | None = None
    on_local_map: Callable[[np.ndarray], None] | None = None
    on_global_map: Callable[[OccupancyGrid], None] | None = None
    on_obstacle: Callable[[float, int], None] | None = None
    on_error: Callable[[int], None] | None = None


@dataclasses.dataclass
class SlamV1:
    """Deployable facade: one object, push sensors in, callbacks out.

    ``work_mode``: ``"mapping"`` (online SLAM) or ``"localization"``
    (particle filter against ``localization_grid``).
    """

    model: LaserModel
    callbacks: SlamCallbacks = dataclasses.field(default_factory=SlamCallbacks)
    work_mode: str = "mapping"
    cfg: SlamConfig = SlamConfig()
    localization_grid: OccupancyGrid | None = None
    n_particles: int = 1024
    local_map_radius: float = 5.0
    seed: int = 0
    async_backend: bool = True  # the deployable surface overlaps
    #                             frontend and backend by default, like
    #                             the reference's thread topology
    #                             (slam.cpp:40-67); scan feeds never
    #                             block on a backend round

    def __post_init__(self):
        self._running = False
        self._odo_pose = np.zeros(3, np.float32)
        self._last_odo = None
        self._beacon_pose: np.ndarray | None = None
        self._slam: OnlineSlam | None = None
        self._pf_state: pf.ParticleState | None = None
        self._field = None
        self._key = jax.random.PRNGKey(self.seed)
        self._pending_rel = np.zeros(3, np.float32)

    # -- lifecycle (init/run/stop, slam_v1.h:87-101) ---------------------

    def start(self) -> None:
        if self.work_mode == "mapping":
            self._slam = OnlineSlam(
                self.model, cfg=self.cfg,
                on_pose=self.callbacks.on_slam_pose, use_fusion=True,
                async_backend=self.async_backend,
            )
        elif self.work_mode == "localization":
            if self.localization_grid is None:
                raise ValueError("localization mode needs localization_grid")
            self._field = likelihood_field(self.localization_grid)
            # One compiled tracking tick per scan, with the reference's
            # motion noise (globaldef.cpp:13-30).
            self._tick = jax.jit(functools.partial(
                pf.track_field, model=self.model,
                sigma_xy=pf.PREDICT_SIGMA_XY,
                sigma_theta=pf.PREDICT_SIGMA_THETA,
            ))
        else:
            raise ValueError(f"unknown work_mode {self.work_mode!r}")
        self._running = True

    def stop(self) -> None:
        # Drain the in-flight/pending async backend rounds before the
        # lights go out (the reference's shutdown cascade joins its
        # threads, slam.cpp:76-84); skip the final full-session round —
        # stop() is a lifecycle call, not a map-finalization request.
        if self._slam is not None:
            self._slam.flush(final_round=False)
        self._running = False

    # -- sensor inputs ----------------------------------------------------

    def feed_odometry(self, x: float, y: float, theta: float) -> None:
        """Wheel odometry pose (receODO, slam_v1.h:103). Accumulates the
        relative motion used as the PF predict / frontend prior."""
        new = np.asarray([x, y, theta], np.float32)
        if self._last_odo is not None:
            rel = np.asarray(
                se2.relative(jnp.asarray(self._last_odo), jnp.asarray(new))
            )
            self._pending_rel = np.asarray(
                se2.compose(jnp.asarray(self._pending_rel), jnp.asarray(rel))
            )
        self._last_odo = new
        self._odo_pose = new
        if self.callbacks.on_odo_pose:
            self.callbacks.on_odo_pose(new)

    def feed_beacon(self, x: float, y: float, theta: float) -> None:
        """Beacon triangulation fix (receBN, slam_v1.h:104)."""
        self._beacon_pose = np.asarray([x, y, theta], np.float32)
        if self._slam is not None:
            self._slam.feed_beacon(self._beacon_pose[:2])
        if self.callbacks.on_beacon_pose:
            self.callbacks.on_beacon_pose(self._beacon_pose)

    def feed_gps(self, obs) -> None:
        """GPS fix from :class:`..io.gps.GpsDriver` (the reference's GPS
        path feeds CSlamV1 through the callback table and the UKF's GPS
        observe, slam_v1.h:44-63 + config.hpp:180-197)."""
        if self._slam is not None:
            self._slam.feed_gps(obs)

    def feed_scan_main(self, ranges, timestamp: float = 0.0) -> np.ndarray | None:
        """Main laser frame: drives SLAM/localization *and* obstacle
        detection (cbMainSICKForSLAM + cbMainSICKForOD)."""
        if not self._running:
            return None
        ranges = np.asarray(ranges, np.float32)
        if self.callbacks.on_scan_a:
            self.callbacks.on_scan_a(ranges)
        self._obstacle_check(ranges)

        if self.work_mode == "mapping":
            pose = self._slam.feed_scan(ranges)
            fused = self._slam.pose
            if self.callbacks.on_fused_pose:
                self.callbacks.on_fused_pose(fused)
            if self.callbacks.on_pose_and_cloud:
                self.callbacks.on_pose_and_cloud(fused, ranges)
            self._emit_local_map(fused)
            return fused

        return self._localize_step(ranges)

    def feed_scan_minor(self, ranges, timestamp: float = 0.0) -> None:
        """Second laser: obstacle detection only (cbMinorSICKForOD)."""
        ranges = np.asarray(ranges, np.float32)
        if self.callbacks.on_scan_b:
            self.callbacks.on_scan_b(ranges)
        self._obstacle_check(ranges)

    def report_error(self, code: int) -> None:
        """Hardware/system error entry point (cbErrList; SICK reconnect
        codes CSICK.cpp:280-311, battery/serial codes slam_v1.h:16-22)."""
        if self.callbacks.on_error:
            self.callbacks.on_error(int(code))

    # -- outputs ----------------------------------------------------------

    @property
    def pose(self) -> np.ndarray:
        if self.work_mode == "mapping" and self._slam is not None:
            return self._slam.pose
        if self._pf_state is not None:
            return np.asarray(pf.estimate(self._pf_state))
        return self._odo_pose

    @property
    def last_scan(self):
        """The most recent preprocessed :class:`Scan` (device-resident),
        for consumers that would otherwise re-run preprocess on the hot
        sensor path (local map, obstacle layer)."""
        if self._slam is not None:
            return getattr(self._slam, "last_scan", None)
        return None

    def global_map(self, resolution: float = 0.05) -> OccupancyGrid:
        if self._slam is None:
            raise RuntimeError("global map only available in mapping mode")
        grid = self._slam.render_map(resolution)
        if self.callbacks.on_global_map:
            self.callbacks.on_global_map(grid)
        return grid

    # -- internals --------------------------------------------------------

    def _obstacle_check(self, ranges: np.ndarray) -> None:
        if self.callbacks.on_obstacle is None:
            return
        scan = jax.tree.map(
            lambda x: x[0], preprocess(jnp.asarray(ranges)[None, :], self.model)
        )
        speed, zone = security_speed_cap(self.model, scan)
        self.callbacks.on_obstacle(float(speed), int(zone))

    def _localize_step(self, ranges: np.ndarray) -> np.ndarray:
        scan = jax.tree.map(
            lambda x: x[0], preprocess(jnp.asarray(ranges)[None, :], self.model)
        )
        valid = ~scan.bad
        self._key, k1, k2 = jax.random.split(self._key, 3)
        if self._pf_state is None:
            # Global relocalization on first scan (globalize,
            # localization.cpp:483-540).
            state = pf.global_relocalize(
                k1, self.localization_grid, self._field, self.model,
                scan.ranges, valid, n_keep=self.n_particles,
            )
            state = pf.update_field(
                state, self._field, self.localization_grid,
                self.model, scan.ranges, valid,
            )
            self._pf_state = pf.maybe_resample(state, k2)
            est = pf.estimate(self._pf_state)
        else:
            rel = jnp.asarray(self._pending_rel)
            self._pf_state, est = self._tick(
                self._pf_state, rel, scan.ranges, valid, k2,
                self._field, self.localization_grid,
            )
            self._pending_rel = np.zeros(3, np.float32)
        est = np.asarray(est)
        if self.callbacks.on_localization:
            self.callbacks.on_localization(est)
        if self.callbacks.on_fused_pose:
            self.callbacks.on_fused_pose(est)
        return est

    def _emit_local_map(self, pose: np.ndarray) -> None:
        """Egocentric occupancy patch around the robot (cbLocalMap — the
        robot app's obstacle-avoidance input, MapService semantics).
        O(1) per scan: a window of the live incremental grid, never a
        map rebuild (the round-1 O(T)-per-scan rebuild is gone)."""
        if self.callbacks.on_local_map is None or self._slam is None:
            return
        if getattr(self._slam, "_imap", None) is not None:
            half_cells = max(
                int(self.local_map_radius / self._slam.map_resolution), 1
            )
            win, _ = self._slam.local_map(pose, half_cells)
            self.callbacks.on_local_map(np.asarray(jax.nn.sigmoid(win)))
            return
        grid = self._slam.render_map(0.1)
        spec = grid.spec
        c = np.asarray(spec.world_to_cell(jnp.asarray(pose[:2])))
        r = int(self.local_map_radius / spec.resolution)
        prob = np.asarray(grid.probability)
        y0, y1 = max(c[1] - r, 0), min(c[1] + r, prob.shape[0])
        x0, x1 = max(c[0] - r, 0), min(c[0] + r, prob.shape[1])
        self.callbacks.on_local_map(prob[y0:y1, x0:x1])
