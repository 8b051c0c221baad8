"""Free-form point-cloud ICP (trimmed, full correspondence search).

Batched JAX replacement for the reference's MRPT CICP wrapper
(src/zhicp/ZHIcp_Warpper.cpp: icpClassic over two float point clouds,
100 iterations, returning pose, 3×3 covariance and a *goodness* score —
the fraction of matched points — used to accept loop closures at
thresholds 0.8/0.45, MapGraph.cpp:42-43, and as the particle-filter
observation likelihood, VPmap.cpp:485-503).

Unlike the bearing-banded polar ICP in :mod:`.icp` (an odometry matcher
that assumes nearly-aligned scans), correspondences here are an
unrestricted masked ``[N, M]`` distance matrix — for typical scan sizes
(≤ 541²·4 B ≈ 1.2 MB/pair) this is one fused kernel per iteration
and stays batched over pairs/particles via ``vmap``. The correspondence
distance threshold anneals from ``max_corr`` down to ``min_corr``
(MRPT's ALFA-style threshold ramp) so distant initializations still
converge.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import se2

Array = jnp.ndarray

DEFAULT_ITERS = 40
MAX_CORR = 1.0       # [m] starting correspondence gate
MIN_CORR = 0.10      # [m] final correspondence gate (2× grid resolution)
CORR_DECAY = 0.85    # per-iteration threshold decay (MRPT ALFA=0.5 per ramp)
TRIM_FRACTION = 0.1  # drop the worst matches each iteration
MIN_POINTS = 20


class PointIcpResult(NamedTuple):
    pose: Array      # [3] relative pose: cur → ref frame
    err: Array       # [] mean matched distance [m]
    goodness: Array  # [] fraction of cur points matched at the final gate
    fail: Array      # [] bool
    n_matched: Array # [] int32
    cov: Array | None = None  # [3, 3] Censi-style pose covariance


def match_icp_points(
    ref_pts: Array,
    ref_valid: Array,
    cur_pts: Array,
    cur_valid: Array,
    init_pose: Array | None = None,
    iters: int = DEFAULT_ITERS,
    max_corr: float = MAX_CORR,
    min_corr: float = MIN_CORR,
    steps_per_nn: int = 1,
) -> PointIcpResult:
    """Align ``cur_pts [N, 2]`` onto ``ref_pts [M, 2]`` (masked points
    excluded). Single pair; ``vmap`` for batches.

    ``steps_per_nn > 1`` reuses each correspondence search (the ``[N, M]``
    distance pass, the bulk of the per-pair cost) for that many pose
    updates: the nearest-segment
    endpoints stay fixed while the projection target, gate, trim and
    closed-form update are recomputed per step (all ``[N]``-sized). The
    total number of pose updates and the gate-decay schedule are
    unchanged — ``iters`` still counts pose updates."""
    dtype = cur_pts.dtype
    if init_pose is None:
        init_pose = jnp.zeros(3, dtype)
    n = cur_pts.shape[0]

    def body(it, state):
        pose, err, nm, match = state
        q = se2.transform_points(pose, cur_pts)              # [N, 2]
        d2 = jnp.sum((q[:, None, :] - ref_pts[None, :, :]) ** 2, axis=-1)
        d2 = jnp.where(ref_valid[None, :], d2, jnp.inf)      # [N, M]
        j = jnp.argmin(d2, axis=1)
        nn_ok = jnp.isfinite(
            jnp.take_along_axis(d2, j[:, None], axis=1)[:, 0]
        )

        # Point-to-segment target: project onto the segment between the
        # two nearest reference points. Kills the sampling bias of pure
        # point-to-point matching on sparsely sampled walls (the role of
        # the reference's interpolation, ZHPolar_Match.cpp:1859-1927).
        d2b = d2.at[jnp.arange(n), j].set(jnp.inf)
        j2 = jnp.argmin(d2b, axis=1)
        p1 = ref_pts[j]
        p2 = ref_pts[j2]
        seg = p2 - p1
        len2 = jnp.sum(seg * seg, axis=-1)
        len2_safe = jnp.where(len2 < 1e-12, 1.0, len2)
        # Only use the segment when its two endpoints are close together
        # (adjacent samples of one surface, not a gap across objects).
        seg_ok = len2 < (4.0 * min_corr) ** 2

        for s in range(steps_per_nn):
            if s:
                q = se2.transform_points(pose, cur_pts)
            tproj = jnp.clip(
                jnp.sum((q - p1) * seg, axis=-1) / len2_safe, 0.0, 1.0
            )
            proj = p1 + tproj[:, None] * seg
            target = jnp.where(seg_ok[:, None], proj, p1)
            dist = jnp.where(
                seg_ok,
                jnp.linalg.norm(q - proj, axis=-1),
                jnp.linalg.norm(q - p1, axis=-1),
            )

            step = it.astype(dtype) * steps_per_nn + s
            gate = jnp.maximum(max_corr * CORR_DECAY ** step, min_corr)
            match = cur_valid & nn_ok & (dist < gate)

            # Trim the worst TRIM_FRACTION of matches (quantile cut).
            dist_m = jnp.where(match, dist, jnp.inf)
            srt = jnp.sort(dist_m)
            nm = jnp.sum(match)
            k = jnp.clip(
                (nm.astype(dtype) * (1.0 - TRIM_FRACTION)).astype(jnp.int32)
                - 1,
                0,
                n - 1,
            )
            keep = match & (dist <= srt[k])

            tgt = target                                     # [N, 2]
            wk = keep.astype(dtype)
            m = jnp.maximum(jnp.sum(wk), 1.0)
            mean_q = jnp.sum(q * wk[:, None], axis=0) / m
            mean_t = jnp.sum(tgt * wk[:, None], axis=0) / m
            dq = (q - mean_q) * wk[:, None]
            dt = tgt - mean_t
            sxx = jnp.sum(dq[:, 0] * dt[:, 0])
            sxy = jnp.sum(dq[:, 0] * dt[:, 1])
            syx = jnp.sum(dq[:, 1] * dt[:, 0])
            syy = jnp.sum(dq[:, 1] * dt[:, 1])
            dth = jnp.arctan2(sxy - syx, sxx + syy)
            cd, sd = jnp.cos(dth), jnp.sin(dth)
            # Rotate the moved cloud about its matched centroid, then
            # translate.
            dx = mean_t[0] - (cd * mean_q[0] - sd * mean_q[1])
            dy = mean_t[1] - (sd * mean_q[0] + cd * mean_q[1])
            upd = jnp.stack([dx, dy, dth])
            pose = se2.compose(upd, pose)

            err = jnp.sum(jnp.where(keep, dist, 0.0)) / m
        return pose, err, nm, match

    init_state = (
        init_pose.astype(dtype),
        jnp.asarray(1e6, dtype),
        jnp.asarray(0, jnp.int32),
        jnp.zeros(n, bool),
    )
    n_outer = max((iters + steps_per_nn - 1) // steps_per_nn, 1)
    pose, err, nm, match = jax.lax.fori_loop(0, n_outer, body, init_state)

    n_cur = jnp.maximum(jnp.sum(cur_valid), 1)
    goodness = nm.astype(dtype) / n_cur.astype(dtype)
    fail = nm < MIN_POINTS

    # Censi-style pose covariance from the final correspondence set
    # (the role of CSM's cov_x_m consumed via FMatchKeyFrame2/setCov,
    # src/zhcsm/ZHCanonical_Matcher.cpp:287-298, 79-81): residual
    # r_k = R(θ)p_k + t − tgt_k, J_k = [I₂ | R'(θ)p_k], so the Fisher
    # information is H = Σ J_kᵀJ_k / σ² with σ² the matched-residual
    # variance. Returned as cov = H⁻¹ (floored σ so a perfect overlap
    # does not claim zero uncertainty).
    q = se2.transform_points(pose, cur_pts)
    c, s = jnp.cos(pose[2]), jnp.sin(pose[2])
    dpx = -s * cur_pts[:, 0] - c * cur_pts[:, 1]          # R'(θ) p
    dpy = c * cur_pts[:, 0] - s * cur_pts[:, 1]
    w = match.astype(dtype)
    m = jnp.maximum(jnp.sum(w), 1.0)
    h00 = m
    h11 = m
    h02 = jnp.sum(w * dpx)
    h12 = jnp.sum(w * dpy)
    h22 = jnp.sum(w * (dpx * dpx + dpy * dpy))
    H = jnp.array(
        [[h00, 0.0, h02], [0.0, h11, h12], [h02, h12, h22]], dtype
    )
    sigma2 = jnp.maximum(err * err, (0.5 * min_corr) ** 2)
    cov = sigma2 * jnp.linalg.inv(
        H + 1e-3 * jnp.eye(3, dtype=dtype)
    )
    return PointIcpResult(
        pose=pose, err=err, goodness=goodness, fail=fail, n_matched=nm,
        cov=cov,
    )


def scan_to_points(model, scan) -> tuple[Array, Array]:
    """Valid beam endpoints of a :class:`..core.scan.Scan` as a masked
    point cloud ``([N, 2], [N] bool)`` in the sensor frame."""
    fi = model.bearings(scan.ranges.dtype)
    pts = jnp.stack(
        [scan.ranges * jnp.cos(fi), scan.ranges * jnp.sin(fi)], axis=-1
    )
    valid = ~scan.bad & (scan.ranges < model.max_range) & (
        scan.ranges > model.min_range
    )
    return pts, valid
