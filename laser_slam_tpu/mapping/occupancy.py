"""Occupancy-grid mapping with log-odds scatter updates.

Batched JAX replacement for the reference's hit/sum counting grid
(``CPMap::updateMap`` with Bresenham ray traversal,
src/mapGraph/PMap.cpp:47-129, and the drawmap renderer,
src/drawmap/drawmap.cpp:59-130). Differences by design:

- standard **log-odds** cell state instead of hit/sum ratios (numerically
  stable, additive, trivially batched);
- ray free-space carving via a fixed number of samples per beam instead
  of data-dependent Bresenham walks — every beam contributes the same
  static shape, which XLA turns into one big gather/scatter;
- the whole scan batch updates the grid in one ``scatter_add``.

The grid is a pure array; all updates are functional (returns new grid).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import se2
from ..core.scan import LaserModel, Scan

Array = jnp.ndarray

# Log-odds increments (standard inverse sensor model values).
LO_OCC = 0.85     # log odds added at the beam endpoint
LO_FREE = -0.4    # log odds added along the free-space ray
LO_MIN, LO_MAX = -10.0, 10.0
# Reference grid resolutions: 5 cm submaps (MapNode.cpp:702),
# 2 cm localization maps (localization/globaldef.cpp:7).
SUBMAP_RESOLUTION = 0.05
LOCALIZATION_RESOLUTION = 0.02


@dataclasses.dataclass(frozen=True)
class GridSpec2D:
    """Static grid geometry: ``origin`` is the world position of cell
    (0, 0)'s corner; cells are square with side ``resolution``."""

    origin_x: float
    origin_y: float
    resolution: float
    width: int    # cells along x
    height: int   # cells along y

    def world_to_cell(self, xy: Array) -> Array:
        """``[..., 2]`` world points → integer cell indices ``(ix, iy)``."""
        gx = (xy[..., 0] - self.origin_x) / self.resolution
        gy = (xy[..., 1] - self.origin_y) / self.resolution
        return jnp.stack(
            [jnp.floor(gx).astype(jnp.int32), jnp.floor(gy).astype(jnp.int32)],
            axis=-1,
        )

    def cell_centers_world(self, cells: Array) -> Array:
        return jnp.stack(
            [
                (cells[..., 0] + 0.5) * self.resolution + self.origin_x,
                (cells[..., 1] + 0.5) * self.resolution + self.origin_y,
            ],
            axis=-1,
        )

    def contains(self, cells: Array) -> Array:
        return (
            (cells[..., 0] >= 0)
            & (cells[..., 0] < self.width)
            & (cells[..., 1] >= 0)
            & (cells[..., 1] < self.height)
        )


@dataclasses.dataclass
class OccupancyGrid:
    """Log-odds occupancy grid ``[H, W]`` (row = y, col = x).

    Registered as a pytree with the static :class:`GridSpec2D` as aux
    data, so grids flow through ``jit``/``scan`` like arrays.
    """

    log_odds: Array
    spec: GridSpec2D

    @property
    def probability(self) -> Array:
        return jax.nn.sigmoid(self.log_odds)

    @property
    def occupied(self) -> Array:
        return self.log_odds > 0.0

    @property
    def known(self) -> Array:
        return jnp.abs(self.log_odds) > 1e-6


jax.tree_util.register_pytree_node(
    OccupancyGrid,
    lambda g: ((g.log_odds,), g.spec),
    lambda spec, children: OccupancyGrid(children[0], spec),
)


def empty_grid(spec: GridSpec2D, dtype=jnp.float32) -> OccupancyGrid:
    return OccupancyGrid(
        log_odds=jnp.zeros((spec.height, spec.width), dtype), spec=spec
    )


def spec_for_trajectory(
    poses: np.ndarray,
    max_range: float,
    resolution: float = SUBMAP_RESOLUTION,
    margin: float = 1.0,
) -> GridSpec2D:
    """Grid covering a trajectory plus sensor range (host-side helper)."""
    xy = np.asarray(poses)[:, :2]
    lo = xy.min(axis=0) - max_range - margin
    hi = xy.max(axis=0) + max_range + margin
    w = int(np.ceil((hi[0] - lo[0]) / resolution))
    h = int(np.ceil((hi[1] - lo[1]) / resolution))
    return GridSpec2D(float(lo[0]), float(lo[1]), resolution, w, h)


def integrate_scans(
    grid: OccupancyGrid,
    model: LaserModel,
    scans: Scan,
    poses: Array,
    n_free_samples: int = 128,
) -> OccupancyGrid:
    """Fuse a batch of scans ``[T, N]`` posed at ``poses [T, 3]`` into the
    grid with two scatter-adds (endpoints + free-space samples).

    Free space: each beam drops ``n_free_samples`` samples uniformly in
    ``(0, r)``; each sample adds ``LO_FREE · r / (n_samples · res)`` so the
    expected total decrement per traversed cell matches a Bresenham walk
    (the reference increments ``m_mapsum`` per traversed cell,
    PMap.cpp:61-88) while keeping a fixed shape.
    """
    spec = grid.spec
    fi = model.bearings(scans.ranges.dtype)                     # [N]
    r = scans.ranges
    valid = ~scans.bad & (r < model.max_range) & (r > model.min_range)

    ang = poses[:, 2:3] + fi[None, :]                           # [T, N]
    dx, dy = jnp.cos(ang), jnp.sin(ang)
    ex = poses[:, 0:1] + r * dx                                 # endpoints
    ey = poses[:, 1:2] + r * dy

    lo = grid.log_odds

    # --- occupied endpoints ---
    cells = spec.world_to_cell(jnp.stack([ex, ey], axis=-1))    # [T, N, 2]
    inb = spec.contains(cells) & valid
    flat = cells[..., 1] * spec.width + cells[..., 0]
    flat = jnp.where(inb, flat, 0)
    upd = jnp.where(inb, LO_OCC, 0.0)
    lo_flat = lo.reshape(-1).at[flat.reshape(-1)].add(upd.reshape(-1))

    # --- free-space samples ---
    frac = (jnp.arange(n_free_samples, dtype=r.dtype) + 0.5) / n_free_samples
    # Sample slightly short of the endpoint to avoid eroding the surface.
    rs = (r[..., None] - spec.resolution) * frac                # [T, N, S]
    rs = jnp.maximum(rs, 0.0)
    fx = poses[:, 0, None, None] + rs * dx[..., None]
    fy = poses[:, 1, None, None] + rs * dy[..., None]
    fcells = spec.world_to_cell(jnp.stack([fx, fy], axis=-1))
    finb = spec.contains(fcells) & valid[..., None]
    fflat = jnp.where(finb, fcells[..., 1] * spec.width + fcells[..., 0], 0)
    per_sample = LO_FREE * (r[..., None] / (n_free_samples * spec.resolution))
    fupd = jnp.where(finb, per_sample, 0.0)
    lo_flat = lo_flat.at[fflat.reshape(-1)].add(fupd.reshape(-1))

    lo = jnp.clip(lo_flat, LO_MIN, LO_MAX).reshape(spec.height, spec.width)
    return OccupancyGrid(log_odds=lo, spec=spec)


def occupied_points(grid: OccupancyGrid, max_points: int) -> tuple[Array, Array]:
    """Extract up to ``max_points`` occupied cell centers as world points
    ``([P, 2], [P] valid-mask)`` — fixed-shape replacement for
    ``CPMap::getPointCloud`` (PMap.cpp:131-142)."""
    occ = grid.log_odds > 0.0
    flat = occ.reshape(-1)
    score = jnp.where(flat, grid.log_odds.reshape(-1), -jnp.inf)
    vals, idx = jax.lax.top_k(score, max_points)
    valid = jnp.isfinite(vals)
    iy = idx // grid.spec.width
    ix = idx % grid.spec.width
    pts = grid.spec.cell_centers_world(jnp.stack([ix, iy], axis=-1))
    return pts, valid
