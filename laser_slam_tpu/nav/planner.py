"""Grid path planning as iterated stencil relaxation.

Batched JAX replacement for the reference robot layer's grid planner
(src/Main-Ctrl/PathPlanning.cpp:24-42: seed-growing wavefront over an
occupancy grid with milestone extraction). The wavefront — a chamfer
distance-to-goal propagated around obstacles — is an iterated 3×3
min-plus stencil: pure dense array ops, no queues, no data-dependent
control flow, trivially batched over multiple goals.

Path extraction follows the wavefront downhill with a fixed-step
``lax.scan`` (no while loops on device).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..mapping.occupancy import OccupancyGrid

Array = jnp.ndarray

BIG = 1e6


def inflate_obstacles(grid: OccupancyGrid, robot_radius: float) -> Array:
    """Boolean obstacle mask inflated by the robot radius (the
    reference's security-zone footprint, MainCtrl_Define.h:26-39) via
    iterated 3×3 dilation."""
    occ = grid.log_odds > 0.0
    n_iter = max(int(robot_radius / grid.spec.resolution), 1)

    def body(_, m):
        p = jnp.pad(m, 1)
        return (
            m
            | p[:-2, 1:-1] | p[2:, 1:-1] | p[1:-1, :-2] | p[1:-1, 2:]
            | p[:-2, :-2] | p[:-2, 2:] | p[2:, :-2] | p[2:, 2:]
        )

    return jax.lax.fori_loop(0, n_iter, body, occ)


def wavefront(
    obstacles: Array, goal_cell: Array, resolution: float, n_iter: int
) -> Array:
    """Distance-to-goal field ``[H, W]`` propagated around obstacles.

    ``n_iter`` bounds the wavefront radius in cells (one stencil pass
    extends the front by one cell). Unknown-as-obstacle is the caller's
    choice via the mask.
    """
    h, w = obstacles.shape
    d0 = jnp.full((h, w), BIG)
    d0 = d0.at[goal_cell[1], goal_cell[0]].set(0.0)
    blocked = jnp.where(obstacles, BIG, 0.0)
    c, cd = resolution, resolution * 1.41421356

    def body(_, d):
        p = jnp.pad(d, 1, constant_values=BIG)
        best = jnp.minimum(
            jnp.minimum(
                jnp.minimum(p[:-2, 1:-1], p[2:, 1:-1]) + 0,
                jnp.minimum(p[1:-1, :-2], p[1:-1, 2:]),
            )
            + c,
            jnp.minimum(
                jnp.minimum(p[:-2, :-2], p[:-2, 2:]),
                jnp.minimum(p[2:, :-2], p[2:, 2:]),
            )
            + cd,
        )
        return jnp.minimum(d, best + blocked)

    return jax.lax.fori_loop(0, n_iter, body, d0)


class PlanResult(NamedTuple):
    path: Array      # [K, 2] world waypoints (padded with the last point)
    length: Array    # [] path length [m]
    reached: Array   # [] bool — goal connected to start
    n_valid: Array   # [] int32 — number of real waypoints


def plan_path(
    grid: OccupancyGrid,
    start_xy: Array,
    goal_xy: Array,
    robot_radius: float = 0.3,
    max_steps: int = 1024,
    max_wave_iters: int | None = None,
) -> PlanResult:
    """Plan a collision-free path start→goal on the occupancy grid.

    Fully jittable: wavefront from the goal, then downhill descent from
    the start with 8-neighbor steps under ``lax.scan``.
    """
    spec = grid.spec
    res = spec.resolution
    if max_wave_iters is None:
        max_wave_iters = spec.width + spec.height

    obstacles = inflate_obstacles(grid, robot_radius)

    def to_cell(xy):
        return jnp.stack(
            [
                jnp.clip(((xy[0] - spec.origin_x) / res).astype(jnp.int32), 0, spec.width - 1),
                jnp.clip(((xy[1] - spec.origin_y) / res).astype(jnp.int32), 0, spec.height - 1),
            ]
        )

    goal_c = to_cell(goal_xy)
    start_c = to_cell(start_xy)
    dist = wavefront(obstacles, goal_c, res, max_wave_iters)

    offs = jnp.asarray(
        [[-1, -1], [0, -1], [1, -1], [-1, 0], [1, 0], [-1, 1], [0, 1], [1, 1]],
        jnp.int32,
    )

    def step(carry, _):
        cell, done = carry
        nbrs = cell[None, :] + offs                         # [8, 2]
        nx = jnp.clip(nbrs[:, 0], 0, spec.width - 1)
        ny = jnp.clip(nbrs[:, 1], 0, spec.height - 1)
        vals = dist[ny, nx]
        k = jnp.argmin(vals)
        better = vals[k] < dist[cell[1], cell[0]]
        new_cell = jnp.where(better & ~done, nbrs[k], cell)
        at_goal = jnp.all(new_cell == goal_c)
        return (new_cell, done | at_goal | ~better), new_cell

    (_, _), cells = jax.lax.scan(
        step, (start_c, jnp.asarray(False)), None, length=max_steps
    )
    path = jnp.stack(
        [
            (cells[:, 0] + 0.5) * res + spec.origin_x,
            (cells[:, 1] + 0.5) * res + spec.origin_y,
        ],
        axis=-1,
    )
    reached_mask = jnp.all(cells == goal_c[None, :], axis=1)
    reached = jnp.any(reached_mask)
    n_valid = jnp.where(
        reached, jnp.argmax(reached_mask) + 1, max_steps
    ).astype(jnp.int32)
    seg = jnp.linalg.norm(jnp.diff(path, axis=0), axis=-1)
    live = jnp.arange(max_steps - 1) < (n_valid - 1)
    length = jnp.sum(jnp.where(live, seg, 0.0))
    start_dist = dist[start_c[1], start_c[0]]
    return PlanResult(
        path=path,
        length=length,
        reached=reached & (start_dist < BIG),
        n_valid=n_valid,
    )
