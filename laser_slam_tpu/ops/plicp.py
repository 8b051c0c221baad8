"""Point-to-line ICP (PL-ICP) with Gauss-Newton and covariance.

JAX equivalent of the reference's CSM wrapper
(src/zhcsm/ZHCanonical_Matcher.cpp:83-157 configures Censi's ``sm_icp``
with PL-ICP on, 10 iterations, ε = 1 mm / 1 mrad, max correspondence
distance 2 m, adaptive outlier trimming at the 70th percentile ×2).

Instead of wrapping a C library with jump-table correspondence tricks, we
fan the banded correspondence search out as a dense ``[N, 2W]`` gather
(the accelerator-friendly shape), take the two nearest reference points to form a
line segment, and solve the linearized point-to-line least squares in
closed form per iteration. Returns a 3×3 covariance from the Gauss-Newton
normal matrix scaled by the residual variance (the role of Censi's
``cov_x_m``, ZHCanonical_Matcher.cpp:287-298).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import se2
from ..core.scan import LaserModel, Scan

Array = jnp.ndarray

MAX_ITERATIONS = 10           # input->max_iterations
EPSILON_XY = 0.001            # [m] input->epsilon_xy
EPSILON_THETA = 0.001         # [rad] input->epsilon_theta
MAX_CORR_DIST = 2.0           # [m] input->max_correspondence_dist
OUTLIER_MAX_PERC = 0.95       # input->outliers_maxPerc
ADAPTIVE_ORDER = 0.7          # input->outliers_adaptive_order
ADAPTIVE_MULT = 2.0           # input->outliers_adaptive_mult
SENSOR_SIGMA = 0.04           # [m] input->sigma


class PlIcpResult(NamedTuple):
    pose: Array      # [3]
    cov: Array       # [3, 3]
    err: Array       # mean squared point-to-line residual
    fail: Array      # bool
    n_valid: Array   # int32


def _two_nearest(model: LaserModel, ref_pts: Array, ref_bad: Array, q: Array):
    """For each query point ``q[i]`` find the two nearest valid reference
    points within a ±W bearing band. Returns ``(j1, j2, d1)``."""
    n, w = model.n_beams, model.window
    off = jnp.arange(-w, w + 1)
    idx = jnp.arange(n)[:, None] + off[None, :]
    inb = (idx >= 0) & (idx < n)
    idx_c = jnp.clip(idx, 0, n - 1)
    ok = inb & ~ref_bad[idx_c]
    diff = q[:, None, :] - ref_pts[idx_c]                       # [N, K, 2]
    d2 = jnp.where(ok, jnp.sum(diff * diff, axis=-1), jnp.inf)
    k1 = jnp.argmin(d2, axis=1)
    d1 = jnp.take_along_axis(d2, k1[:, None], axis=1)[:, 0]
    d2_masked = d2.at[jnp.arange(n), k1].set(jnp.inf)
    k2 = jnp.argmin(d2_masked, axis=1)
    j1 = jnp.take_along_axis(idx_c, k1[:, None], axis=1)[:, 0]
    j2 = jnp.take_along_axis(idx_c, k2[:, None], axis=1)[:, 0]
    return j1, j2, jnp.sqrt(d1)


class _Carry(NamedTuple):
    pose: Array
    it: Array
    done: Array
    fail: Array
    err: Array
    n_valid: Array
    hess: Array


def match_plicp(
    model: LaserModel, ref: Scan, cur: Scan, init_pose: Array | None = None
) -> PlIcpResult:
    """PL-ICP between two preprocessed scans ``[N]``; ``vmap`` to batch."""
    dtype = cur.ranges.dtype
    n = model.n_beams
    if init_pose is None:
        init_pose = jnp.zeros(3, dtype)

    fi = model.bearings(dtype)
    cur_pts = jnp.stack(
        [cur.ranges * jnp.cos(fi), cur.ranges * jnp.sin(fi)], axis=-1
    )
    ref_pts = jnp.stack(
        [ref.ranges * jnp.cos(fi), ref.ranges * jnp.sin(fi)], axis=-1
    )
    cur_ok = ~cur.bad
    ref_bad = ref.bad

    def body(c: _Carry) -> _Carry:
        q = se2.transform_points(c.pose, cur_pts)               # [N, 2]
        j1, j2, d1 = _two_nearest(model, ref_pts, ref_bad, q)

        p1 = ref_pts[j1]
        p2 = ref_pts[j2]
        seg = p2 - p1
        seg_len = jnp.linalg.norm(seg, axis=-1)
        # Line normal of the (j1, j2) segment.
        nx = -seg[:, 1] / jnp.where(seg_len < 1e-9, 1.0, seg_len)
        ny = seg[:, 0] / jnp.where(seg_len < 1e-9, 1.0, seg_len)
        resid = nx * (q[:, 0] - p1[:, 0]) + ny * (q[:, 1] - p1[:, 1])

        valid = (
            cur_ok
            & jnp.isfinite(d1)
            & (d1 < MAX_CORR_DIST)
            & (seg_len > 1e-9)
        )
        # Adaptive trimming: threshold = mult × (order-quantile of |resid|),
        # capped at the max-percentile cut (CSM's outlier filter).
        a = jnp.where(valid, jnp.abs(resid), jnp.inf)
        srt = jnp.sort(a)
        nv = jnp.sum(valid)
        qi = jnp.clip((nv.astype(dtype) * ADAPTIVE_ORDER).astype(jnp.int32), 0, n - 1)
        pi = jnp.clip((nv.astype(dtype) * OUTLIER_MAX_PERC).astype(jnp.int32) - 1, 0, n - 1)
        thresh = jnp.minimum(srt[qi] * ADAPTIVE_MULT, srt[pi])
        keep = valid & (jnp.abs(resid) <= thresh)
        wk = keep.astype(dtype)
        m = jnp.sum(wk)
        fail = m < model.min_valid_points

        # Linearized point-to-line GN step. Jacobian of n·(R p + t - p1)
        # wrt (dx, dy, dθ) at the current estimate:
        #   J_i = [nx, ny, n · d(R p)/dθ] with rotation about the origin.
        th = c.pose[2]
        dqx = -cur_pts[:, 0] * jnp.sin(th) - cur_pts[:, 1] * jnp.cos(th)
        dqy = cur_pts[:, 0] * jnp.cos(th) - cur_pts[:, 1] * jnp.sin(th)
        jth = nx * dqx + ny * dqy
        J = jnp.stack([nx, ny, jth], axis=-1)                   # [N, 3]
        Jw = J * wk[:, None]
        H = Jw.T @ J                                            # [3, 3]
        g = Jw.T @ resid                                        # [3]
        H_reg = H + 1e-9 * jnp.eye(3, dtype=dtype)
        delta = -jnp.linalg.solve(H_reg, g)
        delta = jnp.where(fail, jnp.zeros(3, dtype), delta)

        pose = jnp.stack(
            [
                c.pose[0] + delta[0],
                c.pose[1] + delta[1],
                se2.normalize_angle(c.pose[2] + delta[2]),
            ]
        )
        done = (
            (jnp.abs(delta[0]) < EPSILON_XY)
            & (jnp.abs(delta[1]) < EPSILON_XY)
            & (jnp.abs(delta[2]) < EPSILON_THETA)
        )
        err = jnp.sum(jnp.where(keep, resid * resid, 0.0)) / jnp.maximum(m, 1.0)
        return _Carry(
            pose=pose,
            it=c.it + 1,
            done=done,
            fail=c.fail | fail,
            err=jnp.where(fail, c.err, err),
            n_valid=m.astype(jnp.int32),
            hess=jnp.where(fail, c.hess, H),
        )

    init = _Carry(
        pose=init_pose.astype(dtype),
        it=jnp.asarray(0, jnp.int32),
        done=jnp.asarray(False),
        fail=jnp.asarray(False),
        err=jnp.asarray(1e6, dtype),
        n_valid=jnp.asarray(0, jnp.int32),
        hess=jnp.eye(3, dtype=dtype),
    )
    # Fixed-trip loop with a freeze mask instead of a data-dependent
    # ``while_loop`` — a batched while-cond runs every lane until the
    # slowest converges anyway, and a fixed trip count compiles to one
    # dense batched program; frozen lanes preserve sm_icp's termination
    # (epsilon_xy/epsilon_theta, ZHCanonical_Matcher.cpp:99-101).
    def step(_, c: _Carry) -> _Carry:
        frozen = c.done | c.fail
        nxt = body(c)
        return jax.tree.map(lambda old, new: jnp.where(frozen, old, new), c, nxt)

    out = jax.lax.fori_loop(0, MAX_ITERATIONS, step, init)

    # Covariance ≈ σ² (JᵀJ)⁻¹ from the final normal matrix — the quantity
    # the reference obtains from Censi's cov_x_m and feeds to the graph
    # as edge information (ZHCanonical_Matcher.cpp:287-298).
    sigma2 = jnp.maximum(out.err, SENSOR_SIGMA**2)
    cov = sigma2 * jnp.linalg.inv(out.hess + 1e-6 * jnp.eye(3, dtype=dtype))
    return PlIcpResult(
        pose=out.pose, cov=cov, err=out.err, fail=out.fail, n_valid=out.n_valid
    )
