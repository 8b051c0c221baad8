"""Correlative scan matching: exhaustive pose-grid search.

The reference handles hard alignments (fast rotation, loop closures with
unknown relative pose) with FLIRT interest points + RANSAC
(src/mapGraph/FlirterNode.cpp:394-482) and MRPT ICP over submap clouds
(MapNode.cpp:625-655). An accelerator-first redesign replaces both with
*correlative* matching: rasterize the reference scan into a blurred
likelihood grid and score **every** pose in a (θ, tx, ty) search volume
by summing grid lookups of the transformed current scan — a dense
gather/reduce with no data-dependent control flow that finds the global
optimum over its window (no local minima, unlike ICP). The rotation axis
is processed with ``lax.map`` so the live score volume stays small even
when the matcher is vmapped over hundreds of candidate pairs; a trimmed
point-ICP polish recovers sub-cell accuracy.

This is the robust front for:
- odometry fallback on aggressive rotation (PSM's ±window search fails),
- loop-closure verification from drift-sized initial errors.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import se2
from ..core.scan import LaserModel, Scan
from .icp_points import match_icp_points, scan_to_points

Array = jnp.ndarray

GRID_RES = 0.10          # [m] cell size of the likelihood grid
GRID_HALF_EXTENT = 12.8  # [m] half-width of the grid (256 cells at 10 cm)
BLUR_SIGMA_CELLS = 1.0   # Gaussian blur of the hit grid, in cells
MIN_SCORE = 0.25         # acceptance floor on mean point likelihood


class CorrelativeResult(NamedTuple):
    pose: Array    # [3] best relative pose (cur in ref frame)
    score: Array   # [] mean per-point likelihood of the best pose (0..1)
    fail: Array    # [] bool


def build_likelihood_grid_points(
    pts: Array,
    ok: Array,
    res: float = GRID_RES,
    half_extent: float = GRID_HALF_EXTENT,
    blur_sigma: float = BLUR_SIGMA_CELLS,
) -> Array:
    """Rasterize masked points ``[N, 2]`` into a blurred
    occupancy-likelihood grid ``[G, G]`` (origin at the center), values
    in [0, 1]."""
    g = int(round(2 * half_extent / res))
    dtype = pts.dtype
    ix = jnp.floor((pts[:, 0] + half_extent) / res).astype(jnp.int32)
    iy = jnp.floor((pts[:, 1] + half_extent) / res).astype(jnp.int32)
    inb = ok & (ix >= 0) & (ix < g) & (iy >= 0) & (iy < g)
    flat = jnp.where(inb, iy * g + ix, 0)
    hits = jnp.zeros(g * g, dtype).at[flat].add(jnp.where(inb, 1.0, 0.0))
    grid = jnp.clip(hits.reshape(g, g), 0.0, 1.0)

    # Separable Gaussian blur (5-cell kernel, peak 1).
    r = jnp.arange(-2, 3, dtype=dtype)
    k = jnp.exp(-0.5 * (r / blur_sigma) ** 2)
    blur1 = jax.vmap(lambda row: jnp.correlate(row, k, mode="same"))(grid)
    blur2 = jax.vmap(lambda col: jnp.correlate(col, k, mode="same"))(blur1.T).T
    return jnp.clip(blur2, 0.0, 1.0)


def build_likelihood_grid(
    model: LaserModel,
    scan: Scan,
    res: float = GRID_RES,
    half_extent: float = GRID_HALF_EXTENT,
    blur_sigma: float = BLUR_SIGMA_CELLS,
) -> Array:
    """Rasterize a scan's endpoints into a blurred occupancy-likelihood
    grid ``[G, G]`` (sensor at the center), values in [0, 1]."""
    pts, ok = scan_to_points(model, scan)
    return build_likelihood_grid_points(pts, ok, res, half_extent, blur_sigma)


def _score_theta(
    grid: Array,
    res: float,
    half_extent: float,
    pts: Array,      # [N, 2]
    valid: Array,    # [N]
    theta: Array,    # []
    steps: Array,    # [T] translation offsets (multiples of res)
    base_xy: Array,  # [2]
) -> Array:
    """Score grid ``[T, T]`` for one rotation: mean point likelihood at
    every (tx, ty) shift. The shift moves whole cells, so one floor +
    integer offsets covers the entire translation window."""
    g = grid.shape[0]
    c, s = jnp.cos(theta), jnp.sin(theta)
    rx = pts[:, 0] * c - pts[:, 1] * s + base_xy[0]
    ry = pts[:, 0] * s + pts[:, 1] * c + base_xy[1]
    ix = jnp.floor((rx + half_extent) / res).astype(jnp.int32)   # [N]
    iy = jnp.floor((ry + half_extent) / res).astype(jnp.int32)
    off = jnp.round(steps / res).astype(jnp.int32)               # [T]

    gx = ix[:, None] + off[None, :]                              # [N, Tx]
    gy = iy[:, None] + off[None, :]                              # [N, Ty]
    okx = (gx >= 0) & (gx < g)
    oky = (gy >= 0) & (gy < g)
    gxc = jnp.clip(gx, 0, g - 1)
    gyc = jnp.clip(gy, 0, g - 1)

    flat = gyc[:, None, :] * g + gxc[:, :, None]                 # [N, Tx, Ty]
    vals = jnp.take(grid.reshape(-1), flat)
    ok = valid[:, None, None] & okx[:, :, None] & oky[:, None, :]
    vals = jnp.where(ok, vals, 0.0)
    n = jnp.maximum(jnp.sum(valid), 1).astype(vals.dtype)
    return jnp.sum(vals, axis=0) / n                             # [Tx, Ty]


def match_correlative(
    model: LaserModel,
    ref: Scan,
    cur: Scan,
    init_pose: Array | None = None,
    search_xy: float = 2.4,
    search_theta: float = float(jnp.pi),
    n_theta: int = 72,
    res: float = GRID_RES,
    refine: bool = True,
    prior_xy: float = 0.02,
    prior_theta: float = 0.005,
    conv: bool = True,
) -> CorrelativeResult:
    """Correlative match of ``cur`` against ``ref`` over the search
    volume ``±search_xy [m] × ±search_theta [rad]`` centered on
    ``init_pose``, followed by a trimmed point-ICP polish.

    ``prior_xy``/``prior_theta`` add a quadratic penalty on distance from
    ``init_pose`` — far below real peak contrast, but enough to break the
    ties a corridor's translation-invariant (or a symmetric room's
    rotation-invariant) score plateau produces.
    """
    dtype = cur.ranges.dtype
    if init_pose is None:
        init_pose = jnp.zeros(3, dtype)

    grid = build_likelihood_grid(model, ref, res=res)
    pts, valid = scan_to_points(model, cur)

    thetas = init_pose[2] + jnp.linspace(
        -search_theta, search_theta, n_theta, dtype=dtype
    )
    n_steps = int(search_xy / res)
    steps = jnp.arange(-n_steps, n_steps + 1, dtype=dtype) * res

    if conv:
        # Convolution path: the whole (θ, ty, tx) volume as one dense
        # convolution instead of a per-rotation gather loop. The sums match the
        # gather formulation except at the grid boundary: a point whose
        # rotated base cell falls outside the raster is dropped for ALL
        # shifts, while the gather path still credits it at shifts that
        # bring it back in bounds — scores can differ slightly for
        # boundary points (ADVICE r4), which only matters on marginal
        # pairs.
        score = jnp.swapaxes(
            correlative_score_volume(
                grid, pts, valid, thetas, n_steps, res,
                GRID_HALF_EXTENT, init_pose[:2],
            ),
            1, 2,
        )                                                       # [K, Tx, Ty]
    else:
        score = jax.lax.map(
            lambda th: _score_theta(
                grid, res, GRID_HALF_EXTENT, pts, valid, th, steps,
                init_pose[:2]
            ),
            thetas,
        )                                                       # [K, T, T]
    dth_pen = se2.normalize_angle(thetas - init_pose[2]) ** 2
    penalty = (
        prior_theta * dth_pen[:, None, None]
        + prior_xy * (steps**2)[None, :, None]
        + prior_xy * (steps**2)[None, None, :]
    )
    score = score - penalty
    k = jnp.argmax(score)
    kk, ka, kb = jnp.unravel_index(k, score.shape)
    pose = jnp.stack(
        [
            init_pose[0] + steps[ka],
            init_pose[1] + steps[kb],
            se2.normalize_angle(thetas[kk]),
        ]
    )
    best = score[kk, ka, kb]

    if refine:
        ref_pts, ref_ok = scan_to_points(model, ref)
        icp = match_icp_points(
            ref_pts, ref_ok, pts, valid, pose, iters=15, max_corr=3.0 * res
        )
        pose = jnp.where(icp.fail, pose, icp.pose)

    return CorrelativeResult(pose=pose, score=best, fail=best < MIN_SCORE)


def correlative_score_volume(
    grid: Array,
    pts: Array,
    ok: Array,
    thetas: Array,
    n_steps: int,
    res: float,
    half_extent: float,
    base_xy: Array,
    overlap_norm: bool = False,
    overlap_floor: float = 0.35,
    overlap_radius: float = 1.5,
) -> Array:
    """Score volume ``[K, T, T]`` (θ, y-shift, x-shift) of mean point
    likelihood, computed as one convolution.

    The per-point gather formulation (:func:`_score_theta`) is bound by
    scattered memory reads. Observing that
    ``score(θ, t) = Σ_points grid(p_θ + t)`` is exactly the
    cross-correlation of the likelihood grid with the rotated cloud's
    raster, the whole translation window for all rotations becomes a
    ``lax.conv`` of the zero-padded grid with ``K`` raster kernels —
    dense multiply-adds with regular access. Under ``vmap`` (batched
    loop candidates) XLA lowers this to one grouped convolution.

    ``overlap_norm`` divides by the number of query points that land in
    *ref-covered* territory (the occupied raster dilated by
    ``overlap_radius``) instead of by all valid points. With wide
    (±wing-submap) clouds on both sides, a cross- or opposite-heading
    revisit only overlaps where the two passes actually cross; mean-
    over-all-points dilutes the true alignment by every point the ref
    never saw, and corridor aliases that keep more raw wall mass inside
    the grid outscore it (measured on mit-cscail's uncovered revisit
    pairs: score at the GT pose reached 0.10-0.83× the volume max and
    the true basin was absent from the top-32 peaks on 9 of 12 pairs).
    ``overlap_floor`` keeps the denominator ≥ that fraction of the
    valid-point count so a tiny accidental overlap cannot claim a high
    normalized score. Both convolutions ride the same kernel raster
    (one batch-2 conv).
    """
    g = grid.shape[0]
    dtype = grid.dtype
    k = thetas.shape[0]
    n = pts.shape[0]

    # Rotate the cloud by every theta (+ base offset) and rasterize into
    # K kernels of point counts.
    c, s = jnp.cos(thetas), jnp.sin(thetas)               # [K]
    rx = pts[None, :, 0] * c[:, None] - pts[None, :, 1] * s[:, None]
    ry = pts[None, :, 0] * s[:, None] + pts[None, :, 1] * c[:, None]
    rx = rx + base_xy[0]
    ry = ry + base_xy[1]
    ix = jnp.floor((rx + half_extent) / res).astype(jnp.int32)   # [K, N]
    iy = jnp.floor((ry + half_extent) / res).astype(jnp.int32)
    inb = ok[None, :] & (ix >= 0) & (ix < g) & (iy >= 0) & (iy < g)
    kk = jnp.broadcast_to(jnp.arange(k, dtype=jnp.int32)[:, None], (k, n))
    flat = jnp.where(inb, (kk * g + iy) * g + ix, 0)
    raster = jnp.zeros(k * g * g, dtype).at[flat.reshape(-1)].add(
        jnp.where(inb, 1.0, 0.0).reshape(-1)
    ).reshape(k, 1, g, g)

    n_valid = jnp.maximum(jnp.sum(ok), 1).astype(dtype)
    if not overlap_norm:
        pad = jnp.pad(grid, n_steps)[None, None]          # [1, 1, G+2W, G+2W]
        vol = jax.lax.conv_general_dilated(
            pad,
            raster,
            window_strides=(1, 1),
            padding="VALID",
            dimension_numbers=("NCHW", "OIHW", "NCHW"),
        )[0]                                              # [K, T, T] (y, x)
        return vol / n_valid

    # Coverage mask: dilated occupancy (any cell within overlap_radius
    # of ref mass counts as territory the ref observed).
    w = 2 * max(int(round(overlap_radius / res)), 1) + 1
    cover = jax.lax.reduce_window(
        (grid > 0.05).astype(dtype), 0.0, jax.lax.max,
        (w, w), (1, 1), "SAME",
    )
    both = jnp.stack([grid, cover])
    pad = jnp.pad(both, ((0, 0), (n_steps, n_steps), (n_steps, n_steps)))
    out = jax.lax.conv_general_dilated(
        pad[:, None],                                     # [2, 1, G+2W, G+2W]
        raster,
        window_strides=(1, 1),
        padding="VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
    )                                                     # [2, K, T, T]
    vol, n_overlap = out[0], out[1]
    denom = jnp.maximum(n_overlap, overlap_floor * n_valid)
    return vol / denom


def correlative_top_peaks(
    ref_pts: Array,
    ref_ok: Array,
    cur_pts: Array,
    cur_ok: Array,
    init_pose: Array,
    n_peaks: int = 4,
    search_xy: float = 5.0,
    search_theta: float = float(jnp.pi),
    n_theta: int = 72,
    res: float = 0.3,
    half_extent: float = 12.8,
    blur_sigma: float = 1.0,
    overlap_norm: bool = False,
    grid: Array | None = None,
) -> tuple[Array, Array]:
    """Top ``n_peaks`` non-max-suppressed local maxima of the correlative
    score volume: ``(poses [K, 3], scores [K])``, best first. Pass a
    prebuilt ``grid`` to amortize rasterization across several query
    clouds against the same reference.

    Partial-overlap matching (loop closure between submaps that share
    only part of their coverage) routinely puts the *true* alignment at
    a secondary peak — a corridor alignment that overlaps more wall mass
    wins argmax. Measured on intel-lab revisits, the true pose is the
    global peak only ~25-70% of the time (narrow vs wide reference) but
    inside the top-4 peaks ~75%: every peak must be polished and gated,
    not just the winner. NMS window: ±2 rotation samples × ±1 cell.
    """
    dtype = cur_pts.dtype
    if grid is None:
        grid = build_likelihood_grid_points(
            ref_pts, ref_ok, res=res, half_extent=half_extent,
            blur_sigma=blur_sigma,
        )
    thetas = init_pose[2] + jnp.linspace(
        -search_theta, search_theta, n_theta, dtype=dtype
    )
    n_steps = int(round(search_xy / res))
    steps = jnp.arange(-n_steps, n_steps + 1, dtype=dtype) * res

    vol = correlative_score_volume(
        grid, cur_pts, cur_ok, thetas, n_steps, res, half_extent,
        init_pose[:2], overlap_norm=overlap_norm,
    )                                                     # [K, Ty, Tx]
    pooled = jax.lax.reduce_window(
        vol, -jnp.inf, jax.lax.max, (5, 3, 3), (1, 1, 1), "SAME"
    )
    is_peak = vol >= pooled
    flat = jnp.where(is_peak, vol, -jnp.inf).reshape(-1)
    scores, idx = jax.lax.top_k(flat, n_peaks)
    kk, ka, kb = jnp.unravel_index(idx, vol.shape)
    poses = jnp.stack(
        [
            init_pose[0] + steps[kb],
            init_pose[1] + steps[ka],
            se2.normalize_angle(thetas[kk]),
        ],
        axis=-1,
    )
    scores = jnp.where(jnp.isfinite(scores), scores, 0.0)
    return poses, scores


def match_correlative_points(
    ref_pts: Array,
    ref_ok: Array,
    cur_pts: Array,
    cur_ok: Array,
    init_pose: Array,
    search_xy: float = 8.0,
    search_theta: float = 0.8,
    n_theta: int = 33,
    res: float = 0.3,
    half_extent: float = 20.0,
    blur_sigma: float = 1.0,
    min_score: float = MIN_SCORE,
) -> CorrelativeResult:
    """Coarse correlative match of one masked point cloud against another
    over ``±search_xy × ±search_theta`` centered on ``init_pose``.

    This is the init-free loop-closure front: where ICP needs a guess
    inside its convergence basin (< ~1 m), this searches the whole
    drift-sized window exhaustively, so candidates proposed from a
    badly drifted trajectory still verify (the role the reference fills
    with RANSAC feature matching, FlirterNode.cpp:394-423). The result
    is cell-quantized — polish with :func:`..ops.icp_points.
    match_icp_points` for metric accuracy. Single pair; ``vmap``/chunk
    for batches (the score volume lowers to one grouped conv).
    """
    dtype = cur_pts.dtype
    grid = build_likelihood_grid_points(
        ref_pts, ref_ok, res=res, half_extent=half_extent,
        blur_sigma=blur_sigma,
    )
    thetas = init_pose[2] + jnp.linspace(
        -search_theta, search_theta, n_theta, dtype=dtype
    )
    n_steps = int(round(search_xy / res))
    steps = jnp.arange(-n_steps, n_steps + 1, dtype=dtype) * res

    score = correlative_score_volume(
        grid, cur_pts, cur_ok, thetas, n_steps, res, half_extent,
        init_pose[:2],
    )                                                     # [K, Ty, Tx]
    k = jnp.argmax(score)
    kk, ka, kb = jnp.unravel_index(k, score.shape)
    pose = jnp.stack(
        [
            init_pose[0] + steps[kb],                     # x from last axis
            init_pose[1] + steps[ka],                     # y from middle axis
            se2.normalize_angle(thetas[kk]),
        ]
    )
    best = score[kk, ka, kb]
    return CorrelativeResult(pose=pose, score=best, fail=best < min_score)
