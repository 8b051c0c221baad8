"""Seeded synthetic CARMEN log: a world carved around a recorded path.

The real CARMEN logs are not part of the repository, but the ground-truth
trajectory of intel-lab is (``gt`` in ``diag/r5_intel-lab.npz``, 2672
poses over a ~30 x 27 m building). This module turns that trajectory into
a complete log the normal entry points read:

1. **World.** An occupancy raster (5 cm cells) that is solid everywhere
   except a free tube carved around the trajectory, whose radius wanders
   smoothly between ~0.9 and ~2.1 m, plus seeded box clutter kept clear
   of the path, so revisits see the same distinctive geometry and are
   not pure corridor aliases.
2. **Scans.** LMS211 scans (181 beams over 180 degrees) ray-cast from each
   ground-truth pose: sphere tracing on the free-space distance
   transform, then a bisection onto the first solid cell. Gaussian range
   noise (1 cm) and dropouts (0.5 % of beams read 0, which the reader
   tags as invalid).
3. **Log.** ``ROBOTLASER1`` records with a drifting odometry pose and
   timestamps (0.15 s median, jittered, with frame-drop gaps of 12x the
   median at the steepest turns and at a few seeded steps), plus one
   ``VERTEX2`` ground-truth line per scan, in the layout
   :func:`laser_slam_tpu.io.carmen.read_carmen` parses.

Everything is NumPy (plus SciPy's distance transform) driven by one
seed, so the same seed gives the same bytes on every machine. The world
is always carved around the whole trajectory; ``n_scans`` only limits
how many scans are rendered, so a short log is a prefix of the long one.

Usage::

    python tools/synth_log.py OUT.log [--scans N] [--seed S]
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np
from scipy import ndimage

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAJECTORY = os.path.join(REPO, "diag", "r5_intel-lab.npz")

RES = 0.05             # [m] world raster cell
MARGIN = 3.0           # [m] solid border around the carved tube
TUBE_MIN, TUBE_MAX = 0.9, 2.1   # [m] free radius around the path
CLUTTER = 160          # boxes placed in the free space
CLUTTER_CLEARANCE = 0.6  # [m] least distance from a box to the path
RANGE_SIGMA = 0.01     # [m] range noise
DROPOUT = 0.005        # fraction of beams that read 0
DT_MEDIAN = 0.15       # [s] scan period
N_GAPS = 6             # frame-drop gaps (half at the steepest turns)
GAP_FACTOR = 12.0      # gap length in scan periods

# LMS211 as the real intel-lab log's header gives it.
N_BEAMS = 181
FOV = math.pi
START = -math.pi / 2
MAX_RANGE = 50.0


def load_trajectory(path: str = TRAJECTORY) -> np.ndarray:
    """``[T, 3]`` ground-truth poses (x, y, theta) of the recorded log."""
    with np.load(path) as d:
        return d["gt"].astype(np.float64)


class World:
    """Solid/free raster with its free-space distance transform."""

    def __init__(self, solid: np.ndarray, origin: np.ndarray, res: float):
        self.solid = solid                        # [H, W] bool
        self.origin = origin                      # [2] world xy of cell (0, 0)
        self.res = res
        # Distance [m] from each cell centre to the nearest solid cell centre.
        self.clear = ndimage.distance_transform_edt(~solid) * res

    def cells(self, xy: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        ij = np.floor((xy - self.origin) / self.res).astype(np.int64)
        h, w = self.solid.shape
        return np.clip(ij[..., 1], 0, h - 1), np.clip(ij[..., 0], 0, w - 1)

    def is_solid(self, xy: np.ndarray) -> np.ndarray:
        return self.solid[self.cells(xy)]


def carve_world(traj: np.ndarray, rng: np.random.Generator,
                res: float = RES) -> World:
    """Solid raster with a wandering free tube around ``traj`` and
    seeded box clutter that keeps ``CLUTTER_CLEARANCE`` off the path."""
    lo = traj[:, :2].min(0) - TUBE_MAX - MARGIN
    hi = traj[:, :2].max(0) + TUBE_MAX + MARGIN
    w, h = np.ceil((hi - lo) / res).astype(int)
    solid = np.ones((h, w), bool)

    # Smooth radius along the path: a random walk low-passed over ~60 poses.
    walk = np.cumsum(rng.normal(0.0, 1.0, traj.shape[0]))
    walk = np.convolve(walk - walk.mean(), np.ones(60) / 60, mode="same")
    span = np.ptp(walk) or 1.0
    radius = TUBE_MIN + (TUBE_MAX - TUBE_MIN) * (walk - walk.min()) / span

    k = int(math.ceil(TUBE_MAX / res)) + 1
    dy, dx = np.mgrid[-k:k + 1, -k:k + 1] * res
    for (x, y, _), r in zip(traj, radius):
        cx, cy = int((x - lo[0]) / res), int((y - lo[1]) / res)
        disc = dx * dx + dy * dy <= r * r
        solid[cy - k:cy + k + 1, cx - k:cx + k + 1] &= ~disc

    # Clutter: boxes centred in free cells far enough from every pose.
    path = np.zeros_like(solid)
    pi = ((traj[:, :2] - lo) / res).astype(int)
    path[pi[:, 1], pi[:, 0]] = True
    to_path = ndimage.distance_transform_edt(~path) * res
    cand = np.argwhere(~solid & (to_path >= CLUTTER_CLEARANCE + 0.35))
    for cy, cx in cand[rng.choice(len(cand), CLUTTER, replace=False)]:
        half = rng.uniform(0.1, 0.35, 2)
        hx = int(min(half[0], to_path[cy, cx] - CLUTTER_CLEARANCE) / res)
        hy = int(min(half[1], to_path[cy, cx] - CLUTTER_CLEARANCE) / res)
        solid[cy - hy:cy + hy + 1, cx - hx:cx + hx + 1] = True
    return World(solid, lo, res)


def cast_rays(world: World, origins: np.ndarray, angles: np.ndarray,
              max_range: float = MAX_RANGE, max_iter: int = 800) -> np.ndarray:
    """Range [m] to the first solid cell along each ray; ``max_range``
    where none is found. ``origins [R, 2]``, ``angles [R]``."""
    d = np.stack([np.cos(angles), np.sin(angles)], -1)
    t = np.zeros(len(angles))
    hit = np.zeros(len(angles), bool)
    active = np.arange(len(angles))
    for _ in range(max_iter):
        if active.size == 0:
            break
        p = origins[active] + t[active, None] * d[active]
        now_solid = world.is_solid(p)
        hit[active[now_solid]] = True
        free = active[~now_solid]
        # A point inside a free cell is at least clear - res*sqrt(2) from
        # any solid cell, so that step cannot jump past one.
        step = np.maximum(world.clear[world.cells(p[~now_solid])] - 1.5 * world.res,
                          0.7 * world.res)
        t[free] += step
        active = free[t[free] < max_range]
    # Bisect each hit onto the free/solid boundary (to ~1 mm).
    h = np.nonzero(hit)[0]
    a = np.maximum(t[h] - 2.0 * world.res, 0.0)
    b = t[h]
    for _ in range(6):
        m = 0.5 * (a + b)
        s = world.is_solid(origins[h] + m[:, None] * d[h])
        b = np.where(s, m, b)
        a = np.where(s, a, m)
    r = np.full(len(angles), max_range)
    r[h] = b
    return r


def render_scans(world: World, poses: np.ndarray, seed: int) -> np.ndarray:
    """``[T, N_BEAMS]`` float32 noisy ranges seen from ``poses``. Noise
    and dropouts are drawn row by row, so fewer poses give a prefix."""
    bearings = START + np.arange(N_BEAMS) * (FOV / (N_BEAMS - 1))
    ang = (poses[:, 2:3] + bearings[None]).reshape(-1)
    org = np.repeat(poses[:, :2], N_BEAMS, axis=0)
    r = cast_rays(world, org, ang).reshape(len(poses), N_BEAMS)
    r = r + np.random.default_rng([seed, 3]).normal(0.0, RANGE_SIGMA, r.shape)
    r = np.clip(r, 0.0, MAX_RANGE)
    r[np.random.default_rng([seed, 4]).random(r.shape) < DROPOUT] = 0.0
    return r.astype(np.float32)


def timestamps(traj: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Scan times: jittered period plus frame-drop gaps."""
    n = traj.shape[0]
    dt = DT_MEDIAN * rng.uniform(0.85, 1.15, n - 1)
    dth = np.abs((np.diff(traj[:, 2]) + np.pi) % (2 * np.pi) - np.pi)
    steep = np.argsort(dth)[-(N_GAPS // 2):]
    seeded = rng.choice(n - 1, N_GAPS - steep.size, replace=False)
    dt[np.concatenate([steep, seeded])] = GAP_FACTOR * DT_MEDIAN
    return np.concatenate([[0.0], np.cumsum(dt)]) + 1000.0


def odometry(traj: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Wheel-odometry-like pose: ground-truth increments with 2 % / 1 deg
    noise, integrated (drifts like a real robot's record)."""
    c, s = np.cos(traj[:-1, 2]), np.sin(traj[:-1, 2])
    d = np.diff(traj, axis=0)
    rel = np.stack([c * d[:, 0] + s * d[:, 1], -s * d[:, 0] + c * d[:, 1],
                    d[:, 2]], -1)
    rel[:, :2] *= 1.0 + rng.normal(0.0, 0.02, (len(rel), 1))
    rel[:, 2] += rng.normal(0.0, math.radians(1.0), len(rel))
    out = np.zeros_like(traj)
    out[0] = traj[0]
    for i, (x, y, th) in enumerate(rel):
        c0, s0 = math.cos(out[i, 2]), math.sin(out[i, 2])
        out[i + 1] = (out[i, 0] + c0 * x - s0 * y,
                      out[i, 1] + s0 * x + c0 * y, out[i, 2] + th)
    out[:, 2] = (out[:, 2] + np.pi) % (2 * np.pi) - np.pi
    return out


def write_carmen(path: str, ranges: np.ndarray, odo: np.ndarray,
                 stamps: np.ndarray, gt: np.ndarray) -> None:
    """Write ``ROBOTLASER1`` + ``VERTEX2`` records (CARMEN layout)."""
    header = (f"ROBOTLASER1 0 {START:.16g} {FOV:.16g} {FOV / (N_BEAMS - 1):.6f} "
              f"{MAX_RANGE:.1f} 0.01 0 {N_BEAMS}")
    with open(path, "w") as f:
        f.write("# synthetic CARMEN log (tools/synth_log.py)\n")
        for i, (r, (x, y, th), ts, g) in enumerate(zip(ranges, odo, stamps, gt)):
            f.write(f"VERTEX2 {i} {g[0]:.6f} {g[1]:.6f} {g[2]:.6f}\n")
            rs = " ".join(f"{v:.3f}" for v in r)
            pose = f"{x:.6f} {y:.6f} {th:.6f}"
            f.write(f"{header} {rs} 0 {pose} {pose} 0 0 0 0 0 "
                    f"{ts:.6f} synth {ts:.6f}\n")


def make_log(path: str, n_scans: int | None = None, seed: int = 0) -> str:
    """Generate the synthetic log at ``path`` and return ``path``."""
    traj = load_trajectory()
    world = carve_world(traj, np.random.default_rng([seed, 0]))
    stamps = timestamps(traj, np.random.default_rng([seed, 1]))
    odo = odometry(traj, np.random.default_rng([seed, 2]))
    n = traj.shape[0] if n_scans is None else min(n_scans, traj.shape[0])
    ranges = render_scans(world, traj[:n], seed)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    write_carmen(path, ranges, odo[:n], stamps[:n], traj[:n])
    return path


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("out")
    p.add_argument("--scans", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    print(make_log(a.out, a.scans, a.seed))


if __name__ == "__main__":
    main()
