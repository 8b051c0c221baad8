"""Rolling egocentric local map (the reference's MapService).

The reference robot layer keeps an "ambient grid map" around the robot,
fed by double-buffered raw scan data and rebuilt as a tiled probability
graph (src/Main-Ctrl/MapService/AmbientGridMap.{h,cpp} — FastProbability
Graph over buffered bearings), plus a ``LocalMapBuilder`` that ingests a
local-map stream from the SLAM layer (LocalMapBuilder.h:6-11, the
``cbLocalMap`` callback in SLAM.h:19-36). The obstacle-avoidance and
path-planning modules consume this map.

Fixed-shape redesign: one fixed-shape ``[H, W]`` log-odds block that
*scrolls* with the robot. Re-centering is a ``jnp.roll`` plus a mask
that blanks the revealed strip, and scan integration is the same
two-scatter-add inverse sensor model as the global mapper — every step
has static shapes, so the whole update jits once and runs at sensor
rate on-device. The double-buffer/ingest thread of the reference is
unnecessary: updates are pure array ops the host pipeline calls inline.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..core.scan import LaserModel, Scan
from ..mapping.occupancy import LO_FREE, LO_MAX, LO_MIN, LO_OCC

Array = jnp.ndarray


class LocalMap(NamedTuple):
    """Egocentric rolling grid. ``origin_cell`` is the world-grid index
    (in cells, resolution-quantized) of array cell ``(0, 0)`` — dynamic,
    unlike the static origin of :class:`..mapping.occupancy.GridSpec2D`,
    so the same compiled update serves the whole run."""

    log_odds: Array     # [H, W]
    origin_cell: Array  # [2] int32 (cx, cy) of cell (0, 0)
    resolution: float   # static

    @property
    def shape(self) -> tuple[int, int]:
        return self.log_odds.shape

    def probability(self) -> Array:
        return 1.0 - 1.0 / (1.0 + jnp.exp(self.log_odds))

    def occupied(self, threshold: float = 0.0) -> Array:
        return self.log_odds > threshold

    def origin_world(self) -> Array:
        return self.origin_cell.astype(jnp.float32) * self.resolution


def empty_local_map(
    size: int = 128, resolution: float = 0.1, pose=None, dtype=jnp.float32
) -> LocalMap:
    """~12.8 m square window at 10 cm by default — the scale the
    reference's ambient map covers for obstacle avoidance. The window
    starts centered on ``pose`` (origin if None)."""
    xy = jnp.zeros(2) if pose is None else jnp.asarray(pose)[:2]
    origin = jnp.floor(xy / resolution).astype(jnp.int32) - size // 2
    return LocalMap(
        log_odds=jnp.zeros((size, size), dtype),
        origin_cell=origin,
        resolution=float(resolution),
    )


def recenter(lmap: LocalMap, pose: Array) -> LocalMap:
    """Scroll the window so ``pose`` sits at the center cell; cells that
    scroll in are reset to unknown (log-odds 0)."""
    h, w = lmap.shape
    res = lmap.resolution
    want = (
        jnp.floor(pose[:2] / res).astype(jnp.int32)
        - jnp.asarray([w // 2, h // 2], jnp.int32)
    )
    shift = want - lmap.origin_cell  # [dx, dy] in cells
    lo = jnp.roll(lmap.log_odds, shift=(-shift[1], -shift[0]), axis=(0, 1))
    # blank the strip that wrapped around
    iy = jnp.arange(h)[:, None]
    ix = jnp.arange(w)[None, :]
    fresh_y = jnp.where(
        shift[1] >= 0, iy >= h - shift[1], iy < -shift[1]
    )
    fresh_x = jnp.where(
        shift[0] >= 0, ix >= w - shift[0], ix < -shift[0]
    )
    lo = jnp.where(fresh_y | fresh_x, 0.0, lo)
    return LocalMap(lo, want, lmap.resolution)


def update_local_map(
    lmap: LocalMap,
    model: LaserModel,
    scan: Scan,
    pose: Array,
    n_free_samples: int = 64,
) -> LocalMap:
    """Recenter on ``pose`` and fuse one scan (inverse sensor model,
    endpoint + free-space scatter-adds). Jittable; call at sensor rate."""
    lmap = recenter(lmap, pose)
    h, w = lmap.shape
    res = lmap.resolution

    fi = model.bearings(scan.ranges.dtype)
    r = scan.ranges
    valid = ~scan.bad & (r < model.max_range) & (r > model.min_range)
    ang = pose[2] + fi
    dx, dy = jnp.cos(ang), jnp.sin(ang)

    def to_cell(x, y):
        cx = jnp.floor(x / res).astype(jnp.int32) - lmap.origin_cell[0]
        cy = jnp.floor(y / res).astype(jnp.int32) - lmap.origin_cell[1]
        inb = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
        return jnp.where(inb, cy * w + cx, 0), inb

    lo = lmap.log_odds.reshape(-1)

    flat, inb = to_cell(pose[0] + r * dx, pose[1] + r * dy)
    lo = lo.at[flat].add(jnp.where(inb & valid, LO_OCC, 0.0))

    frac = (jnp.arange(n_free_samples, dtype=r.dtype) + 0.5) / n_free_samples
    rs = jnp.maximum(r[:, None] - res, 0.0) * frac          # [N, S]
    fflat, finb = to_cell(
        pose[0] + rs * dx[:, None], pose[1] + rs * dy[:, None]
    )
    per = LO_FREE * (r[:, None] / (n_free_samples * res))
    lo = lo.at[fflat.reshape(-1)].add(
        jnp.where(finb & valid[:, None], per, 0.0).reshape(-1)
    )

    lo = jnp.clip(lo, LO_MIN, LO_MAX).reshape(h, w)
    return LocalMap(lo, lmap.origin_cell, lmap.resolution)


def obstacle_distance_field(lmap: LocalMap, threshold: float = 0.0) -> Array:
    """Per-cell **exact Euclidean** distance in meters to the nearest
    occupied cell — what the reference's IOA consults its ambient map
    for. Separable two-stage transform: exact 1D distance along rows
    via doubling min-plus passes (log₂ W), then a ``fori_loop`` min
    over row offsets with squared costs — O(H) passes of static-shape
    elementwise ops, which XLA fuses into one pass for a 128² window."""
    import jax.lax as lax

    h, w = lmap.shape
    occ = lmap.occupied(threshold)
    big = jnp.asarray(1e6, jnp.float32)

    # stage 1: exact per-row distance along x (in cells)
    d = jnp.where(occ, 0.0, big)
    ix = jnp.arange(w)[None, :]
    k = 1
    while k < w:
        plus = jnp.where(ix >= k, jnp.roll(d, k, axis=1) + k, big)
        minus = jnp.where(ix < w - k, jnp.roll(d, -k, axis=1) + k, big)
        d = jnp.minimum(d, jnp.minimum(plus, minus))
        k *= 2
    g2 = jnp.minimum(d, big) ** 2  # squared row distance, [H, W]

    # stage 2: D²(i,j) = min_dy g2(i+dy, j) + dy²
    iy = jnp.arange(h)[:, None]

    def body(dy, best):
        up = jnp.where(iy >= dy, jnp.roll(g2, dy, axis=0), big) + dy * dy
        dn = jnp.where(iy < h - dy, jnp.roll(g2, -dy, axis=0), big) + dy * dy
        return jnp.minimum(best, jnp.minimum(up, dn))

    d2 = lax.fori_loop(1, h, body, g2)
    return jnp.sqrt(jnp.minimum(d2, big)) * lmap.resolution


class LocalMapService:
    """Host-side convenience owning the jitted update (the role of the
    reference's ``LocalMapBuilder``/``AmbientGridMap`` thread pair):
    ``stream_in`` a posed scan, read ``map``/``distance_field``."""

    def __init__(self, model: LaserModel, size: int = 128, resolution: float = 0.1):
        import jax

        self.model = model
        self.map = empty_local_map(size, resolution)
        self._update = jax.jit(
            lambda m, s, p: update_local_map(m, model, s, p)
        )

    def stream_in(self, scan: Scan, pose: Array) -> LocalMap:
        self.map = self._update(self.map, scan, jnp.asarray(pose, jnp.float32))
        return self.map

    def distance_field(self) -> Array:
        return obstacle_distance_field(self.map)
