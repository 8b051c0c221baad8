"""Submap hierarchy: keyframe groups reduced to fixed-shape local clouds.

Fixed-shape JAX redesign of the reference's ``CMapNode`` (src/mapGraph/
MapNode.{h,cpp}): a session of ~10 pose nodes is reduced into one submap
(``reduceIntoMapNode`` MapNode.cpp:473-566, ``g_session_size``
MapGraph.cpp:725), rasterized into a 5 cm occupancy grid
(``computePMAP`` MapNode.cpp:726-759, RESOLUTION MapNode.cpp:702) whose
occupied cells become the point cloud matched submap-vs-submap with MRPT
ICP for loop closure (``matchNodePairICP`` MapNode.cpp:625-655).

Here the whole hierarchy is three batched array programs:

- **reduction**: all beam endpoints of a group are expressed in the
  group-anchor frame and deduplicated at submap resolution by voxel key
  (sort + first-occurrence mask — the grid rasterization without the
  grid), compacted to a fixed ``P`` points per submap. One ``vmap`` over
  submaps replaces the per-node feature-dedup loops.
- **bounding boxes**: recomputed from the stored local clouds under the
  *current* anchor poses (the role of ``updateObsRange`` MapNode.cpp:150),
  so gating stays correct after every optimization round.
- **verification**: submap-vs-submap trimmed point ICP, one ``vmap``
  over all loop candidates (shardable across chips).

Everything is fixed-shape: groups with fewer valid points carry masks,
never ragged arrays.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import se2
from ..core.scan import LaserModel, Scan
from ..ops.icp_points import PointIcpResult, match_icp_points
from .loop_closure import LoopCandidates, VerifiedLoops

Array = jnp.ndarray

# Reference: 5 cm submap grids (MapNode.cpp:702).
SUBMAP_RESOLUTION = 0.05
DEFAULT_MAX_POINTS = 768


class Submaps(NamedTuple):
    """A batch of ``S`` submaps with fixed ``P`` points each.

    ``points`` live in each submap's **anchor frame** (the first keyframe
    of its group), so they never need rebuilding when the graph solver
    moves the anchors — the analog of the reference storing per-node
    relative poses inside a MapNode (``m_relative_T`` MapNode.h).
    """

    points: Array       # [S, P, 2] anchor-frame deduped endpoints
    valid: Array        # [S, P] bool
    anchor_idx: Array   # [S] index of the anchor scan in the full log


def reduce_group(
    pts_local: Array,
    valid: Array,
    rel_poses: Array,
    max_points: int = DEFAULT_MAX_POINTS,
    resolution: float = SUBMAP_RESOLUTION,
) -> tuple[Array, Array]:
    """Reduce one group of ``K`` scans into ≤ ``max_points`` anchor-frame
    points.

    ``pts_local [K, N, 2]`` are sensor-frame endpoints, ``rel_poses
    [K, 3]`` the scan poses in the anchor frame. Deduplication at
    ``resolution`` mirrors the reference's feature-position dedup +
    grid rasterization (MapNode.cpp:473-566, 726-759) with a sort
    instead of a scatter grid.
    """
    k, n, _ = pts_local.shape
    pts = se2.transform_points(rel_poses, pts_local)  # [K, N, 2]
    pts = pts.reshape(k * n, 2)
    ok = valid.reshape(k * n)

    # Voxel key at submap resolution; invalid points get a sentinel key
    # that sorts last. Anchor-frame coords are bounded by the sensor
    # range (≤ ~64 m), so 13 bits per axis fit an int32 key.
    q = jnp.clip(
        jnp.floor(pts / resolution).astype(jnp.int32) + 4096, 0, 8191
    )
    sentinel = jnp.int32(1 << 30)
    key = q[:, 0] * 8192 + q[:, 1]
    key = jnp.where(ok, key, sentinel)

    order = jnp.argsort(key)
    key_s = key[order]
    pts_s = pts[order]
    first = jnp.concatenate(
        [jnp.ones(1, bool), key_s[1:] != key_s[:-1]]
    ) & (key_s < sentinel)

    # Compact the first-occurrence points to the front (stable: argsort of
    # the negated mask keeps voxel order among survivors).
    rank = jnp.argsort(~first, stable=True)
    take = rank[:max_points]
    out_pts = pts_s[take]
    out_ok = first[take]
    out_pts = jnp.where(out_ok[:, None], out_pts, 0.0)
    return out_pts, out_ok


def build_submaps(
    model: LaserModel,
    scans: Scan,
    poses: Array,
    stride: int,
    max_points: int = DEFAULT_MAX_POINTS,
    resolution: float = SUBMAP_RESOLUTION,
) -> Submaps:
    """Group a ``[T, N]`` scan log into ``S = T // stride`` submaps of
    ``stride`` consecutive scans each (the reference's session size,
    MapGraph.cpp:725) and reduce every group in one ``vmap``."""
    t = scans.ranges.shape[0]
    s = t // stride
    anchor_idx = jnp.arange(s, dtype=jnp.int32) * stride

    fi = model.bearings(scans.ranges.dtype)
    pts = jnp.stack(
        [scans.ranges * jnp.cos(fi), scans.ranges * jnp.sin(fi)], axis=-1
    )
    ok = (
        ~scans.bad
        & (scans.ranges < model.max_range)
        & (scans.ranges > model.min_range)
    )

    cut = s * stride
    pts_g = pts[:cut].reshape(s, stride, -1, 2)
    ok_g = ok[:cut].reshape(s, stride, -1)
    poses_g = poses[:cut].reshape(s, stride, 3)
    rel_g = se2.relative(poses_g[:, :1, :], poses_g)  # anchor-frame poses

    red = jax.vmap(
        lambda p, v, r: reduce_group(p, v, r, max_points, resolution)
    )
    out_pts, out_ok = red(pts_g, ok_g, rel_g)
    return Submaps(points=out_pts, valid=out_ok, anchor_idx=anchor_idx)


def wide_clouds(
    submaps: Submaps,
    odo_anchor_poses: Array,
    wing: int = 4,
    max_points: int = 1536,
    resolution: float = 2.0 * SUBMAP_RESOLUTION,
    block_id: Array | None = None,
) -> tuple[Array, Array]:
    """Per-anchor *wide* clouds: submaps ``i-wing..i+wing`` merged into
    anchor ``i``'s frame via the (locally accurate) odometry relatives —
    ``(points [S, max_points, 2], valid [S, max_points])``.

    Loop verification against a single 10-scan submap suffers partial
    overlap: an opposite-direction revisit's submap extends away from
    the anchor in the opposite direction, so the overlapping fraction is
    small and aliased alignments outscore the true one. Matching the
    *narrow* query submap against this wide local context (±40 scans ≈
    ±10 m of travel) restores full containment — on intel-lab revisits
    it lifts the true alignment from the top-4 peak set in 28% of pairs
    to 75%. This is the richer-map-side asymmetry the reference gets
    from matching a scan group against an accumulated MapNode grid
    (computePMAP, MapNode.cpp:726-759), taken further.
    """
    s, p, _ = submaps.points.shape
    offs = jnp.arange(-wing, wing + 1)
    raw = jnp.arange(s)[:, None] + offs[None, :]         # [S, K]
    idx = jnp.clip(raw, 0, s - 1)
    in_range = (raw >= 0) & (raw < s)
    if block_id is not None:
        # Never merge context across an odometry fracture: the relative
        # pose between blocks is unknown (can be >90° wrong), so a wing
        # crossing the break would smear exactly the reference clouds
        # the cross-block loop verification depends on.
        in_range = in_range & (block_id[idx] == block_id[:, None])
    pts_g = submaps.points[idx]                          # [S, K, P, 2]
    ok_g = submaps.valid[idx] & in_range[..., None]
    rel_g = se2.relative(
        odo_anchor_poses[:, None, :], odo_anchor_poses[idx]
    )                                                    # [S, K, 3]
    red = jax.vmap(
        lambda pp, vv, rr: reduce_group(pp, vv, rr, max_points, resolution)
    )
    out_pts, out_ok = red(pts_g, ok_g, rel_g)
    return out_pts, out_ok


def submap_bboxes(
    submaps: Submaps, anchor_poses: Array
) -> tuple[Array, Array]:
    """World-frame AABBs ``(lo [S,2], hi [S,2])`` of each submap under the
    current anchor poses (updateObsRange, MapNode.cpp:150)."""
    w = se2.transform_points(anchor_poses, submaps.points)
    big = 1e9
    ok = submaps.valid[..., None]
    lo = jnp.min(jnp.where(ok, w, big), axis=1)
    hi = jnp.max(jnp.where(ok, w, -big), axis=1)
    return lo, hi


def verify_loops_submap(
    submaps: Submaps,
    anchor_poses: Array,
    cand: LoopCandidates,
    max_corr: float | Array = 1.5,
) -> VerifiedLoops:
    """Batch-verify loop candidates submap-vs-submap (the role of
    ``matchNodePairICP`` MapNode.cpp:625-655 inside ``addMapNodeCov``
    MapGraph.cpp:1272-1484), with the same reciprocal-consistency and
    bounded-correction acceptance gates as scan-level verification."""
    from .loop_closure import (
        MATCH_ERR_MAX,
        MAX_ANGLE_DELTA,
        MAX_TRANSFORM_DELTA,
        QUALITY_MIN,
    )

    ref_pts = submaps.points[cand.src]
    ref_ok = submaps.valid[cand.src]
    cur_pts = submaps.points[cand.dst]
    cur_ok = submaps.valid[cand.dst]
    init = se2.relative(anchor_poses[cand.src], anchor_poses[cand.dst])

    fwd: PointIcpResult = jax.vmap(
        lambda rp, ro, cp, co, p: match_icp_points(
            rp, ro, cp, co, p, max_corr=max_corr
        )
    )(ref_pts, ref_ok, cur_pts, cur_ok, init)
    bwd: PointIcpResult = jax.vmap(
        lambda cp, co, rp, ro, p: match_icp_points(
            cp, co, rp, ro, p, max_corr=max_corr
        )
    )(cur_pts, cur_ok, ref_pts, ref_ok, se2.inverse(init))

    cycle = se2.compose(fwd.pose, bwd.pose)
    reciprocal = (jnp.linalg.norm(cycle[:, :2], axis=-1) < 0.10) & (
        jnp.abs(se2.normalize_angle(cycle[:, 2])) < 0.035
    )
    delta = se2.relative(init, fwd.pose)
    small_corr = (
        jnp.linalg.norm(delta[:, :2], axis=-1) < MAX_TRANSFORM_DELTA
    ) & (jnp.abs(se2.normalize_angle(delta[:, 2])) < MAX_ANGLE_DELTA)
    accept = (
        cand.valid
        & ~fwd.fail
        & ~bwd.fail
        & reciprocal
        & small_corr
        & (fwd.goodness >= QUALITY_MIN)
        & (fwd.err < MATCH_ERR_MAX)
    )
    rel = jnp.where(accept[:, None], jnp.nan_to_num(fwd.pose), 0.0)
    return VerifiedLoops(
        src=cand.src,
        dst=cand.dst,
        rel=rel,
        quality=fwd.goodness,
        accept=accept,
    )
