"""Polar-windowed ICP as a fixed-shape JAX program.

Fixed-shape JAX redesign of ``pm_icp`` (src/zhpsm/ZHPolar_Match.cpp:1653-2021):

- correspondence search restricted to a ±W bearing-index band becomes a
  dense gathered ``[N, 2W]`` distance matrix + argmin (ref 1785-1822),
- the 20 % worst-match trimming replaces the reference's partial bubble
  sort (1836-1857) with an exact quantile cut via ``jnp.sort``,
- point-to-segment refinement projects each matched point onto the two
  reference segments adjacent to its match (1859-1927),
- the pose update is the closed-form 2D rigid alignment from cross-sums
  (atan2 of covariance terms, 1936-1991) about the current laser center,
- the iteration runs under ``lax.while_loop`` with a failure flag instead
  of ``throw`` (1831).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.scan import LaserModel, Scan
from ..core import se2
from .project import scan_project
from .psm import MatchResult, MAX_ERROR

Array = jnp.ndarray

MAX_ITER_ICP = 60       # PM_MAX_ITER_ICP (PolarParameter.h:22)
STOP_COND_ICP = 0.1     # PM_STOP_COND_ICP, on 100·(|dx|+|dy|) + deg(|dθ|)
TRIM_FRACTION = 0.2     # worst 20 % of matches dropped (ZHPolar_Match.cpp:1836)


def _point_segment_projection(p0, p1, q):
    """Project points ``q [N,2]`` onto segments ``p0→p1 [N,2]``.

    Returns ``(proj [N,2], dist [N], inside [N])`` — mirroring
    ``point_line_distance`` (ZHPolar_Match.cpp:2024-2060), whose -1 return
    for projections outside the segment becomes the ``inside`` mask.
    """
    d = p1 - p0
    len2 = jnp.sum(d * d, axis=-1)
    t = jnp.sum((q - p0) * d, axis=-1) / jnp.where(len2 < 1e-12, 1.0, len2)
    inside = (t >= 0.0) & (t <= 1.0) & (len2 >= 1e-12)
    proj = p0 + t[:, None] * d
    dist = jnp.linalg.norm(q - proj, axis=-1)
    return proj, dist, inside


def _correspondences(model: LaserModel, ref: Scan, nx, ny, cur_ok):
    """Banded nearest-neighbour search. Returns ``(j_idx, dist, valid)``
    per current beam (ref 1785-1822: window is ``[i-W, i+W)``)."""
    n, w = model.n_beams, model.window
    fi = model.bearings(nx.dtype)
    ref_x = ref.ranges * jnp.cos(fi)
    ref_y = ref.ranges * jnp.sin(fi)

    off = jnp.arange(-w, w)                                 # [2W]
    idx = jnp.arange(n)[:, None] + off[None, :]             # [N, 2W]
    inb = (idx >= 0) & (idx < n)
    idx_c = jnp.clip(idx, 0, n - 1)
    cand_ok = inb & ~jnp.take(ref.bad, idx_c)
    dx = nx[:, None] - jnp.take(ref_x, idx_c)
    dy = ny[:, None] - jnp.take(ref_y, idx_c)
    d2 = jnp.where(cand_ok, dx * dx + dy * dy, jnp.inf)
    k = jnp.argmin(d2, axis=1)                              # [N]
    best = jnp.take_along_axis(d2, k[:, None], axis=1)[:, 0]
    j_idx = jnp.take_along_axis(idx_c, k[:, None], axis=1)[:, 0]
    dist = jnp.sqrt(best)
    valid = cur_ok & jnp.isfinite(best) & (dist < MAX_ERROR)
    return j_idx, jnp.where(valid, dist, jnp.inf), valid


class _IcpCarry(NamedTuple):
    pose: Array
    corr: Array
    it: Array
    small_cnt: Array
    fail: Array
    err: Array
    n_valid: Array


def match_icp(
    model: LaserModel, ref: Scan, cur: Scan, init_pose: Array | None = None
) -> MatchResult:
    """Polar-windowed trimmed ICP between two preprocessed scans ``[N]``."""
    dtype = cur.ranges.dtype
    n = model.n_beams
    if init_pose is None:
        init_pose = jnp.zeros(3, dtype)

    fi = model.bearings(dtype)
    cx = cur.ranges * jnp.cos(fi)
    cy = cur.ranges * jnp.sin(fi)
    ref_x = ref.ranges * jnp.cos(fi)
    ref_y = ref.ranges * jnp.sin(fi)
    ref_pts = jnp.stack([ref_x, ref_y], axis=-1)            # [N, 2]
    jm1 = jnp.maximum(jnp.arange(n) - 1, 0)
    jp1 = jnp.minimum(jnp.arange(n) + 1, n - 1)

    def body(c: _IcpCarry) -> _IcpCarry:
        measure = (
            100.0 * (jnp.abs(c.corr[0]) + jnp.abs(c.corr[1]))
            + jnp.abs(c.corr[2]) * 180.0 / jnp.pi
        )
        small_cnt = jnp.where(measure < STOP_COND_ICP, c.small_cnt + 1, 0)

        ax, ay, ath = c.pose[0], c.pose[1], c.pose[2]
        # Projection supplies the per-bin validity the reference uses to
        # gate current points (ZHPolar_Match.cpp:1750, 1789).
        proj = scan_project(model, cur, c.pose)
        co, si = jnp.cos(ath), jnp.sin(ath)
        nx = cx * co - cy * si + ax
        ny = cx * si + cy * co + ay

        j_idx, dist, valid = _correspondences(model, ref, nx, ny, ~proj.bad)
        n_match = jnp.sum(valid)
        fail = n_match < model.min_valid_points

        # Exact 80 % trim: keep matches below the (1-TRIM) quantile.
        sorted_d = jnp.sort(dist)                            # invalid = inf, at end
        n_keep = (n_match.astype(jnp.float32) * (1.0 - TRIM_FRACTION)).astype(jnp.int32)
        n_keep = jnp.maximum(n_keep, 1)
        thresh = sorted_d[jnp.clip(n_keep - 1, 0, n - 1)]
        keep = valid & (dist <= thresh)

        # Point-to-segment refinement around each matched ref point.
        q = jnp.stack([nx, ny], axis=-1)                     # [N, 2]
        pj = ref_pts[j_idx]                                  # [N, 2]
        d0 = jnp.linalg.norm(q - pj, axis=-1)
        p_prev = ref_pts[jm1[j_idx]]
        p_next = ref_pts[jp1[j_idx]]
        proj1, d1, in1 = _point_segment_projection(p_prev, pj, q)
        proj2, d2, in2 = _point_segment_projection(pj, p_next, q)
        use1 = in1 & (j_idx > 0) & (d1 < d0)
        tgt = jnp.where(use1[:, None], proj1, pj)
        dbest = jnp.where(use1, d1, d0)
        use2 = in2 & (j_idx < n - 1) & (d2 < dbest)
        tgt = jnp.where(use2[:, None], proj2, tgt)
        dbest = jnp.where(use2, d2, dbest)

        # Closed-form rigid update about the laser center (1936-1991).
        wk = keep.astype(dtype)
        m = jnp.maximum(jnp.sum(wk), 1.0)
        mean_p = jnp.sum(q * wk[:, None], axis=0) / m
        mean_t = jnp.sum(tgt * wk[:, None], axis=0) / m
        dp = (q - mean_p) * wk[:, None]
        dt = tgt - mean_t
        sxx = jnp.sum(dp[:, 0] * dt[:, 0])
        sxy = jnp.sum(dp[:, 0] * dt[:, 1])
        syx = jnp.sum(dp[:, 1] * dt[:, 0])
        syy = jnp.sum(dp[:, 1] * dt[:, 1])
        dth = jnp.arctan2(sxy - syx, sxx + syy)
        cd, sd = jnp.cos(dth), jnp.sin(dth)
        dx = mean_t[0] - ax - (cd * (mean_p[0] - ax) - sd * (mean_p[1] - ay))
        dy = mean_t[1] - ay - (sd * (mean_p[0] - ax) + cd * (mean_p[1] - ay))

        dx = jnp.where(fail, 0.0, dx)
        dy = jnp.where(fail, 0.0, dy)
        dth = jnp.where(fail, 0.0, dth)
        pose = jnp.stack(
            [ax + dx, ay + dy, se2.normalize_angle(ath + dth)]
        )
        err = jnp.sum(jnp.where(keep, dbest, 0.0)) / m
        return _IcpCarry(
            pose=pose,
            corr=jnp.stack([dx, dy, dth]),
            it=c.it + 1,
            small_cnt=small_cnt,
            fail=c.fail | fail,
            err=jnp.where(fail, c.err, err),
            n_valid=n_match,
        )

    init = _IcpCarry(
        pose=init_pose.astype(dtype),
        corr=jnp.full((3,), 1e6, dtype),
        it=jnp.asarray(0, jnp.int32),
        small_cnt=jnp.asarray(0, jnp.int32),
        fail=jnp.asarray(False),
        err=jnp.asarray(1e6, dtype),
        n_valid=jnp.asarray(0, jnp.int32),
    )
    # Fixed-trip loop with a freeze mask instead of a data-dependent
    # ``while_loop`` — a batched while-cond runs every lane until the
    # slowest converges anyway, and a fixed trip count compiles to one
    # dense batched program; frozen lanes preserve the reference's early exit
    # (pm_icp stop condition, ZHPolar_Match.cpp:1729-1733).
    def step(_, c: _IcpCarry) -> _IcpCarry:
        done = (c.small_cnt >= 3) | c.fail
        nxt = body(c)
        return jax.tree.map(lambda old, new: jnp.where(done, old, new), c, nxt)

    out = jax.lax.fori_loop(0, MAX_ITER_ICP, step, init)
    return MatchResult(pose=out.pose, err=out.err, fail=out.fail, n_valid=out.n_valid)
