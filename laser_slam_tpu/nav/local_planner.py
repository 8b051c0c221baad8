"""Egocentric local planner: seed-grow reachability + milestone dodge.

The reference robot's obstacle-dodge planner (src/Main-Ctrl/Task/
PathPlanning.cpp) works on a small egocentric "instant view" grid built
from the live scan: flood-fill the free space reachable from the robot
(``SeedGrowing``, PathPlanning.cpp:27-55), erode it by the robot
footprint (``MergeGridsBasedOnRobotSize``, 58-104), pick a *milestone*
— the centroid of the farthest reachable free row — and walk a straight
line toward it, lowering the target row until the line is obstacle-free
(``MileStoneSlct``, PathPlanning.cpp:24-42, 318-448); the dodge path is
a short waypoint list the trajectory tracker consumes.

Fixed-shape re-design: the flood fill becomes an iterated masked-dilation
stencil (pure dense ops — the reference's explicit stack is
data-dependent control flow XLA can't tile), the erosion a min-pool,
and the lower-the-row search is *vectorized*: line-of-sight freeness is
evaluated for EVERY candidate row in one batched gather, then the best
row is an argmax — no while loop at all.

Frame convention: the instant view is robot-centric, x to the right
(column), y forward (row), cell (H_ROBOT, W/2) is the robot.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.scan import LaserModel, Scan

Array = jnp.ndarray

# Instant-view geometry (reference: IOA_VIEWWIDTH=20, IOA_VIEWHEIGHT=50
# cells at 0.1 m ⇒ 2 m × 5 m forward window, PathPlanning.h:11-14).
VIEW_W = 20
VIEW_H = 50
VIEW_RES = 0.1
ROBOT_ROW = 0          # robot sits at the bottom row, centre column


def instant_view(model: LaserModel, scan: Scan) -> Array:
    """Rasterize the live scan into the egocentric free/obstacle grid
    (the reference's ``InstantView``, PathPlanning.cpp:107-205).

    Returns ``[VIEW_H, VIEW_W]`` bool — True = obstacle. Beams landing
    inside the window mark their endpoint cell; cells beyond every beam
    stay free (the reference's coarse polyline fill is replaced by
    endpoint scatter — at 0.1 m cells every hit cell is marked)."""
    fi = model.bearings(scan.ranges.dtype)
    ok = (
        ~scan.bad
        & (scan.ranges > model.min_range)
        & (scan.ranges < model.max_range)
    )
    x = scan.ranges * jnp.cos(fi)          # forward
    y = scan.ranges * jnp.sin(fi)          # left
    row = jnp.floor(x / VIEW_RES).astype(jnp.int32)
    col = jnp.floor(y / VIEW_RES).astype(jnp.int32) + VIEW_W // 2
    inside = ok & (row >= 0) & (row < VIEW_H) & (col >= 0) & (col < VIEW_W)
    flat = jnp.where(inside, row * VIEW_W + col, VIEW_H * VIEW_W)
    grid = jnp.zeros(VIEW_H * VIEW_W + 1, bool).at[flat].set(
        True, mode="drop"
    )
    return grid[:-1].reshape(VIEW_H, VIEW_W)


def seed_grow(obstacle: Array, seed_rc: tuple[int, int] | None = None) -> Array:
    """Free space *reachable* from the seed cell: iterated 4-neighbour
    dilation masked by free cells (SeedGrowing, PathPlanning.cpp:27-55,
    re-designed from an explicit DFS stack to a dense stencil whose
    iteration count is the grid diameter)."""
    h, w = obstacle.shape
    if seed_rc is None:
        seed_rc = (ROBOT_ROW, w // 2)
    free = ~obstacle
    reach = jnp.zeros_like(free).at[seed_rc].set(free[seed_rc])

    def body(_, m):
        p = jnp.pad(m, 1)
        grown = (
            m | p[:-2, 1:-1] | p[2:, 1:-1] | p[1:-1, :-2] | p[1:-1, 2:]
        )
        return grown & free

    return jax.lax.fori_loop(0, h + w, body, reach)


def erode_by_robot(reach: Array, robot_cells: int = 2) -> Array:
    """Shrink the reachable region by the robot half-width: a cell stays
    traversable only if its (2r+1)² neighbourhood is fully reachable
    (MergeGridsBasedOnRobotSize, PathPlanning.cpp:58-104, with the 5×5
    mask generalized)."""
    m = reach

    def body(_, m):
        # Edge padding: the window boundary is not an obstacle — only
        # observed obstacle cells erode (the reference's 5×5 mask skips
        # out-of-array indices, PathPlanning.cpp:87-99).
        p = jnp.pad(m, 1, mode="edge")
        return (
            m & p[:-2, 1:-1] & p[2:, 1:-1] & p[1:-1, :-2] & p[1:-1, 2:]
            & p[:-2, :-2] & p[:-2, 2:] & p[2:, :-2] & p[2:, 2:]
        )

    return jax.lax.fori_loop(0, robot_cells, body, m)


class Milestone(NamedTuple):
    ok: Array          # [] bool — a dodge path exists
    target_rc: Array   # [2] float cell coords of the line target
    milestone_rc: Array  # [2] float cell coords of the milestone
    path_xy: Array     # [4, 2] waypoints in robot frame [m]


def milestone_select(traversable: Array) -> Milestone:
    """Milestone + obstacle-free approach line, fully vectorized.

    The reference finds the farthest row containing reachable free
    space, takes the centroid of its free run as the milestone, then
    repeatedly lowers the line end row until the straight line from the
    robot is collision-free (MileStoneSlct, PathPlanning.cpp:318-448 —
    a data-dependent retry loop). Here the line test runs for ALL
    candidate end rows at once: sample each line at 2×H points with a
    bilinear-free gather, reduce, and argmax the farthest free line."""
    h, w = traversable.shape
    dtype = jnp.float32
    rows = jnp.arange(h)
    cols = jnp.arange(w)

    free_per_row = traversable.sum(axis=1)
    has_free = free_per_row > 0
    # Farthest reachable row and its free-run centroid (milestone).
    far_row = jnp.max(jnp.where(has_free, rows, -1))
    ok = far_row > 0
    far_row_c = jnp.clip(far_row, 0, h - 1)
    row_mask = traversable[far_row_c]
    mid_col = jnp.where(
        row_mask.sum() > 0,
        jnp.sum(jnp.where(row_mask, cols, 0)) / jnp.maximum(
            row_mask.sum(), 1
        ),
        w / 2.0,
    ).astype(dtype)

    # Candidate line targets: (row r, column mid_col) for every r.
    # March each line from the robot cell; free iff every sample lands
    # on a traversable cell.
    n_s = 2 * h
    t = jnp.linspace(0.0, 1.0, n_s, dtype=dtype)[None, :]      # [1, S]
    r0 = jnp.asarray(ROBOT_ROW, dtype)
    c0 = jnp.asarray(w // 2, dtype)
    rr = r0 + (rows.astype(dtype)[:, None] - r0) * t            # [H, S]
    cc = c0 + (mid_col - c0) * t                                # [1, S]
    ri = jnp.clip(jnp.round(rr).astype(jnp.int32), 0, h - 1)
    ci = jnp.clip(jnp.round(cc).astype(jnp.int32), 0, w - 1)
    ci = jnp.broadcast_to(ci, ri.shape)
    line_free = jnp.all(traversable[ri, ci], axis=1)            # [H]
    # Only rows at-or-below the milestone row qualify as line targets.
    cand = line_free & (rows <= far_row) & (rows > 0)
    end_row = jnp.max(jnp.where(cand, rows, 0)).astype(dtype)
    ok = ok & jnp.any(cand)

    def rc_to_xy(r, c):
        return jnp.stack(
            [(r - r0) * VIEW_RES, (c - c0) * VIEW_RES]
        ).astype(dtype)

    # 4-waypoint dodge path like the reference (PathPlanning.cpp:432-448):
    # robot → short nudge → line target → milestone. The nudge waypoint
    # lies ON the verified robot→target line (interpolated at the nudge
    # row) — a column-c0 nudge would traverse cells the vectorized
    # line-of-sight test never checked (ADVICE r4).
    p0 = jnp.zeros(2, dtype)
    nudge_row = jnp.minimum(end_row, 5.0)
    t_n = (nudge_row - r0) / jnp.maximum(end_row - r0, 1e-6)
    p1 = rc_to_xy(nudge_row, c0 + (mid_col - c0) * t_n)
    p2 = rc_to_xy(end_row, mid_col)
    p3 = rc_to_xy(far_row.astype(dtype), mid_col)
    path = jnp.stack([p0, p1, p2, p3])
    return Milestone(
        ok=ok,
        target_rc=jnp.stack([end_row, mid_col]),
        milestone_rc=jnp.stack([far_row.astype(dtype), mid_col]),
        path_xy=path,
    )


def dodge_path(
    model: LaserModel, scan: Scan, robot_cells: int = 2
) -> Milestone:
    """Full local dodge: instant view → seed-grow → erode → milestone.
    One jittable program (DodgePath, PathPlanning.cpp:210-214 — there a
    stub calling the same chain). ``path_xy`` is in the ROBOT frame;
    compose with the robot pose for world-frame waypoints."""
    view = instant_view(model, scan)
    reach = seed_grow(view)
    trav = erode_by_robot(reach, robot_cells)
    # The robot's own footprint neighbourhood survives erosion even when
    # an obstacle is adjacent — keep the seed traversable so lines can
    # start.
    trav = trav.at[ROBOT_ROW, view.shape[1] // 2].set(
        reach[ROBOT_ROW, view.shape[1] // 2]
    )
    return milestone_select(trav)
