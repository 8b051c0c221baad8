"""Live SLAM viewer — the role of the reference's Qt/OpenGL windows.

The reference wires its 3-thread pipeline into interactive Qt widgets
(src/ui/main.cpp:20-38 — map/point/trajectory GL views; src/ui_/ and
src/rawseed/ add RawSeed ground-truth/odometry overlays; the
localization UI shows the particle cloud). A batch accelerator job is
normally driven headless, so the equivalent here is a matplotlib-based viewer
that works in both modes:

- **interactive**: ``LiveViewer(interactive=True)`` opens a window and
  redraws every ``update()`` (any matplotlib GUI backend);
- **headless**: with the default Agg backend, ``update()`` renders
  off-screen; ``save_frame()``/``save_video()`` write PNGs or an
  animated GIF — the artifact a remote accelerator job ships home.

Content matches the reference UIs: occupancy map underlay, optimized
trajectory, current pose marker, the live scan in world frame, and an
optional particle cloud / ground-truth overlay.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..mapping.occupancy import OccupancyGrid
from .render import grid_to_image


class LiveViewer:
    """Incremental map/trajectory/scan display.

    All arrays are host numpy; call it from the host pipeline loop at
    whatever rate is convenient (the reference's UI thread redraws per
    emitted node, ui/runPFGLocal.h:28-52).
    """

    def __init__(
        self,
        title: str = "laser_slam_tpu",
        interactive: bool = False,
        figsize: tuple[float, float] = (8.0, 8.0),
    ):
        import matplotlib

        if not interactive and matplotlib.get_backend().lower() != "agg":
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        self._plt = plt
        self.interactive = interactive
        self.fig, self.ax = plt.subplots(figsize=figsize)
        self.ax.set_title(title)
        self.ax.set_aspect("equal")
        self._img = None
        (self._traj,) = self.ax.plot([], [], "r-", lw=1.0, label="trajectory")
        (self._gt,) = self.ax.plot([], [], "g--", lw=0.8, label="ground truth")
        self._scan = self.ax.scatter([], [], s=1.5, c="tab:blue", label="scan")
        self._particles = self.ax.scatter(
            [], [], s=2.0, c="tab:orange", alpha=0.5, label="particles"
        )
        (self._pose,) = self.ax.plot([], [], "r^", ms=8.0)
        self._frames: list[np.ndarray] = []
        if interactive:
            plt.ion()
            self.fig.show()

    # -- updates -----------------------------------------------------------

    def set_map(self, grid: OccupancyGrid) -> None:
        img = grid_to_image(grid)
        spec = grid.spec
        extent = (
            spec.origin_x,
            spec.origin_x + spec.width * spec.resolution,
            spec.origin_y,
            spec.origin_y + spec.height * spec.resolution,
        )
        if self._img is None:
            self._img = self.ax.imshow(
                img, cmap="gray", origin="lower", extent=extent, vmin=0, vmax=255
            )
        else:
            self._img.set_data(img)
            self._img.set_extent(extent)

    def update(
        self,
        poses: np.ndarray | None = None,
        scan_xy: np.ndarray | None = None,
        grid: OccupancyGrid | None = None,
        particles: np.ndarray | None = None,
        gt: np.ndarray | None = None,
    ) -> None:
        if grid is not None:
            self.set_map(grid)
        if poses is not None and len(poses):
            p = np.asarray(poses)
            self._traj.set_data(p[:, 0], p[:, 1])
            self._pose.set_data([p[-1, 0]], [p[-1, 1]])
        if gt is not None and len(gt):
            g = np.asarray(gt)
            self._gt.set_data(g[:, 0], g[:, 1])
        if scan_xy is not None:
            self._scan.set_offsets(np.asarray(scan_xy).reshape(-1, 2))
        if particles is not None:
            self._particles.set_offsets(np.asarray(particles)[:, :2])
        self.ax.relim()
        # relim() ignores scatter PathCollections — fold the scan /
        # particle extents in explicitly so points stay in view even
        # with no map underlay or spanning trajectory.
        for coll in (self._scan, self._particles):
            pts = coll.get_offsets()
            if pts is not None and len(pts):
                self.ax.update_datalim(np.asarray(pts))
        self.ax.autoscale_view()
        if self.interactive:
            self.fig.canvas.draw_idle()
            self.fig.canvas.flush_events()
            self._plt.pause(0.001)

    # -- headless artifacts --------------------------------------------------

    def capture(self) -> np.ndarray:
        """Rasterize the current figure to an RGB array and keep it as a
        video frame."""
        self.fig.canvas.draw()
        buf = np.asarray(self.fig.canvas.buffer_rgba())[..., :3].copy()
        self._frames.append(buf)
        return buf

    def save_frame(self, path: str) -> None:
        self.fig.savefig(path, dpi=110)

    def save_video(self, path: str, fps: int = 10) -> None:
        """Write captured frames as an animated GIF (PillowWriter ships
        with matplotlib; no ffmpeg dependency)."""
        if not self._frames:
            self.capture()
        from matplotlib import animation

        fig = self._plt.figure(figsize=(6, 6))
        ax = fig.add_axes([0, 0, 1, 1])
        ax.axis("off")
        im = ax.imshow(self._frames[0])

        def frame(i):
            im.set_data(self._frames[i])
            return (im,)

        anim = animation.FuncAnimation(
            fig, frame, frames=len(self._frames), interval=1000 / fps
        )
        anim.save(path, writer=animation.PillowWriter(fps=fps))
        self._plt.close(fig)

    def close(self) -> None:
        self._plt.close(self.fig)


def scan_to_world(model, ranges: np.ndarray, pose: np.ndarray) -> np.ndarray:
    """Project one scan's valid beams into the world frame (host-side;
    the viewer's analog of the reference's translate2GlobalFrame,
    src/drawmap/drawmap.cpp:59-95)."""
    ranges = np.asarray(ranges, np.float32)
    fi = np.arange(model.n_beams) * model.dfi + model.fi_min
    ok = (ranges > model.min_range) & (ranges < model.max_range)
    a = pose[2] + fi[ok]
    return np.stack(
        [pose[0] + ranges[ok] * np.cos(a), pose[1] + ranges[ok] * np.sin(a)],
        axis=-1,
    )


def replay_log(
    log,
    poses: np.ndarray,
    out: str | None = None,
    stride: int = 20,
    grid: OccupancyGrid | None = None,
    gt: np.ndarray | None = None,
    interactive: bool = False,
) -> "LiveViewer":
    """Replay a loaded log along ``poses`` (the rawseed/ui viewer role):
    map underlay if given, trajectory + live scan per frame. Returns the
    viewer; with ``out`` also writes a GIF."""
    v = LiveViewer(interactive=interactive)
    if grid is not None:
        v.set_map(grid)
    poses = np.asarray(poses)[: log.n_scans]
    t = 0
    for t in range(0, len(poses), max(1, stride)):
        v.update(
            poses=poses[: t + 1],
            scan_xy=scan_to_world(log.model, log.ranges[t], poses[t]),
            gt=gt[: t + 1] if gt is not None else None,
        )
        if out:
            v.capture()
    if out:
        v.save_video(out)
    return v
