"""Polar Scan Matching (PSM) as a fixed-shape JAX program.

Fixed-shape JAX redesign of the reference PSM matcher
(src/zhpsm/ZHPolar_Match.cpp): the exception-driven, per-beam serial
iteration becomes a ``lax.while_loop`` over pure array ops with a failure
*flag* instead of ``throw`` (ZHPolar_Match.cpp:1095, 1106, 1239), so the
whole matcher is jittable, vmappable over pairs, and differentiable-shaped.

Stages per iteration (pm_psm, ZHPolar_Match.cpp:890-1003):
- scan projection (see :mod:`.project`),
- orientation search: a ``[2W+1]``-shift masked cross-correlation with
  parabolic refinement (pm_orientation_search 1152-1261),
- translation: closed-form weighted least squares with Cauchy-like weights
  ``w = C / (dr² + C)`` (pm_translation_estimation 1015-1131).

The reference alternates orientation on even iterations and translation on
odd ones; we fuse one of each into a single loop step (same work per two
reference iterations, half the control overhead).

Units are meters/radians; the reference's cm-based thresholds are scaled
accordingly (noted per constant).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.scan import LaserModel, Scan
from ..core import se2
from .project import Projection, scan_project, scan_project_banded

Array = jnp.ndarray

# --- constants (src/zhpsm/PolarParameter.h:12-24, cm→m where relevant) ---
MAX_ERROR = 1.0                  # PM_MAX_ERROR = 100 cm
WEIGHTING_FACTOR = 0.70 * 0.70   # PM_WEIGHTING_FACTOR = 70²cm² → (0.70 m)²
CHANGE_WEIGHT_ITER = 10          # PM_CHANGE_WEIGHT_ITER (reference iters)
STOP_COND = 0.4                  # PM_STOP_COND, on 100·(|dx|+|dy|) + |dθ|
MAX_ITER = 30                    # PM_MAX_ITER (reference iterations)
LARGE_ERR = 100.0                # orientation-search sentinel (10000 cm)


class MatchResult(NamedTuple):
    """Common result of every matcher in this framework."""

    pose: Array      # [..., 3] relative pose of cur in ref frame (m, rad)
    err: Array       # [...] average residual (matcher-specific, meters)
    fail: Array      # [...] bool — degenerate geometry, do not trust pose
    n_valid: Array   # [...] int32 — points supporting the estimate


def orientation_search(
    model: LaserModel, ref: Scan, proj: Projection
) -> tuple[Array, Array]:
    """One orientation-alignment step; returns ``(dtheta, fail)``.

    Shifting the projected scan by ``di`` bins approximates rotating it by
    ``di·dfi``; pick the shift minimizing the mean absolute range residual,
    then refine with a parabola through the minimum and its neighbours
    (pm_orientation_search, ZHPolar_Match.cpp:1152-1261).
    """
    n = model.n_beams
    w = model.window
    di = jnp.arange(-w, w + 1)                                  # [K]
    idx = jnp.arange(n)[None, :] + di[:, None]                  # [K, N]
    inb = (idx >= 0) & (idx < n)
    idx_c = jnp.clip(idx, 0, n - 1)

    ref_r = jnp.take(ref.ranges, idx_c)                         # [K, N]
    ref_bad = jnp.take(ref.bad, idx_c)
    new_bad = proj.bad
    valid = inb & ~new_bad[None, :] & ~ref_bad
    delta = jnp.abs(proj.new_r[None, :] - ref_r)

    cnt = jnp.sum(valid, axis=1)
    e = jnp.sum(jnp.where(valid, delta, 0.0), axis=1)
    err = jnp.where(cnt > 0, e / jnp.maximum(cnt, 1), LARGE_ERR)  # [K]

    imin = jnp.argmin(err)
    emin = err[imin]
    fail = emin >= LARGE_ERR
    dth = (imin - w).astype(err.dtype) * model.dfi

    # Parabolic refinement (ZHPolar_Match.cpp:1243-1253); 0.01 cm → 1e-4 m.
    k = 2 * w + 1
    em1 = err[jnp.clip(imin - 1, 0, k - 1)]
    ep1 = err[jnp.clip(imin + 1, 0, k - 1)]
    curv = em1 + ep1 - 2.0 * emin
    interior = (imin >= 1) & (imin < k - 1)
    ok = interior & (jnp.abs(curv) > 1e-4) & (em1 > emin) & (ep1 > emin)
    d = jnp.where(ok, (em1 - ep1) / jnp.where(ok, curv, 1.0) / 2.0, 0.0)
    dth = dth + jnp.where(jnp.abs(d) < 1.0, d, 0.0) * model.dfi
    return dth, fail


def translation_estimation(
    model: LaserModel, ref: Scan, proj: Projection, C: Array
) -> tuple[Array, Array, Array, Array]:
    """One weighted-least-squares translation step.

    Linearizes range residuals along beam directions and solves the 2×2
    normal equations in closed form (pm_translation_estimation,
    ZHPolar_Match.cpp:1015-1131). Returns ``(dx, dy, avg_err, fail)``.
    """
    fi = model.bearings(proj.new_r.dtype)
    co, si = jnp.cos(fi), jnp.sin(fi)
    dr = ref.ranges - proj.new_r
    valid = (
        ~ref.bad
        & ~proj.bad
        & (proj.new_r < model.max_range)
        & (proj.new_r > model.min_range)
        & (jnp.abs(dr) < MAX_ERROR)
    )
    wgt = jnp.where(valid, C / (dr * dr + C), 0.0)
    n = jnp.sum(valid)

    hw1 = jnp.sum(wgt * co * dr)
    hw2 = jnp.sum(wgt * si * dr)
    h11 = jnp.sum(wgt * co * co)
    h12 = jnp.sum(wgt * co * si)
    h22 = jnp.sum(wgt * si * si)

    det = h11 * h22 - h12 * h12
    fail = (n < model.min_valid_points) | (det < 1e-3)
    det_safe = jnp.where(fail, 1.0, det)
    dx = (h22 * hw1 - h12 * hw2) / det_safe
    dy = (-h12 * hw1 + h11 * hw2) / det_safe
    # Reference averages |dr| over *all* beams but divides by the valid
    # count (ZHPolar_Match.cpp:1031-1034, 1131) — mirrored for parity.
    avg_err = jnp.sum(jnp.abs(dr)) / jnp.maximum(n, 1)
    return dx, dy, avg_err, fail


class _PsmCarry(NamedTuple):
    pose: Array        # (ax, ay, ath) in ref frame
    corr: Array        # (dx, dy, dth) last corrections
    C: Array
    it: Array
    small_cnt: Array
    fail: Array
    avg_err: Array


def match_psm(
    model: LaserModel,
    ref: Scan,
    cur: Scan,
    init_pose: Array | None = None,
    banded: bool = False,
) -> MatchResult:
    """Match ``cur`` against ``ref``; both must be preprocessed single
    scans ``[N]``. Returns the relative pose of ``cur`` in ``ref``'s frame.

    One loop step = one orientation + one translation update (two
    reference iterations); the stop counter is advanced at both
    half-steps like pm_psm's per-iteration check (ZHPolar_Match.cpp:934-938).

    ``banded=True`` uses the O(N·2K) banded projection (see
    :func:`..project.scan_project_banded`) — ~30%% faster end to end,
    bit-identical on all bundled logs' pairs.
    """
    project = scan_project_banded if banded else scan_project
    dtype = cur.ranges.dtype
    if init_pose is None:
        init_pose = jnp.zeros(3, dtype)

    def small_step(small_cnt, corr):
        measure = 100.0 * (jnp.abs(corr[0]) + jnp.abs(corr[1])) + jnp.abs(corr[2])
        return jnp.where(measure < STOP_COND, small_cnt + 1, 0)

    def body(c: _PsmCarry) -> _PsmCarry:
        # -- orientation half-step (even reference iterations) --
        small_cnt = small_step(c.small_cnt, c.corr)
        proj = project(model, cur, c.pose)
        dth, fail_o = orientation_search(model, ref, proj)
        ath = c.pose[2] + dth
        pose = jnp.stack([c.pose[0], c.pose[1], ath])
        corr = jnp.stack([c.corr[0], c.corr[1], dth])
        small_cnt = small_step(small_cnt, corr)

        # -- translation half-step (odd reference iterations) --
        C = jnp.where(c.it * 2 + 1 == CHANGE_WEIGHT_ITER + 1, c.C / 50.0, c.C)
        proj = project(model, cur, pose)
        dx, dy, avg_err, fail_t = translation_estimation(model, ref, proj, C)
        fail = fail_o | fail_t
        dx = jnp.where(fail, 0.0, dx)
        dy = jnp.where(fail, 0.0, dy)
        pose = jnp.stack([pose[0] + dx, pose[1] + dy, ath])
        corr = jnp.stack([dx, dy, dth])
        return _PsmCarry(
            pose=pose,
            corr=corr,
            C=C,
            it=c.it + 1,
            small_cnt=small_cnt,
            fail=fail,
            avg_err=jnp.where(fail, c.avg_err, avg_err),
        )

    init = _PsmCarry(
        pose=init_pose.astype(dtype),
        corr=jnp.full((3,), 1e6, dtype),
        C=jnp.asarray(WEIGHTING_FACTOR, dtype),
        it=jnp.asarray(0, jnp.int32),
        small_cnt=jnp.asarray(0, jnp.int32),
        fail=jnp.asarray(False),
        avg_err=jnp.asarray(LARGE_ERR, dtype),
    )

    # Fixed-trip loop with a freeze mask instead of a data-dependent
    # ``while_loop``: under ``vmap`` a batched while-cond runs every lane
    # until the slowest converges anyway and adds a per-iteration
    # predicate reduction; a masked ``fori_loop`` with a static trip
    # count compiles to one dense batched program. Converged/failed lanes keep
    # their carry, which is exactly the reference's early exit
    # (pm_psm stop condition, ZHPolar_Match.cpp:934-938).
    def step(_, c: _PsmCarry) -> _PsmCarry:
        done = (c.small_cnt >= 3) | c.fail
        nxt = body(c)
        return jax.tree.map(
            lambda old, new: jnp.where(done, old, new), c, nxt
        )

    out = jax.lax.fori_loop(0, MAX_ITER // 2, step, init)
    pose = out.pose.at[2].set(se2.normalize_angle(out.pose[2]))
    return MatchResult(
        pose=pose, err=out.avg_err, fail=out.fail, n_valid=jnp.asarray(0, jnp.int32)
    )


def error_index(
    model: LaserModel, ref: Scan, cur: Scan, rel_pose: Array
) -> tuple[Array, Array, Array]:
    """Post-match alignment quality (pm_error_index2,
    ZHPolar_Match.cpp:1279-1339): project ``cur`` at ``rel_pose`` onto
    ``ref`` and average squared beam-direction residual components over
    beams agreeing within 1 m. Returns ``(err_x, err_y, n)`` in m².
    """
    proj = scan_project(model, cur, rel_pose)
    fi = model.bearings(cur.ranges.dtype)
    delta = jnp.abs(proj.new_r - ref.ranges)
    valid = ~proj.bad & ~ref.bad & (delta < 1.0)
    n = jnp.sum(valid)
    nf = jnp.maximum(n, 1).astype(delta.dtype)
    ex = jnp.sum(jnp.where(valid, (delta * jnp.cos(fi)) ** 2, 0.0)) / nf
    ey = jnp.sum(jnp.where(valid, (delta * jnp.sin(fi)) ** 2, 0.0)) / nf
    # No overlapping beams at all ⇒ worst error, not zero (the zero-count
    # case would otherwise read as a perfect match).
    bad = n == 0
    big = jnp.asarray(1e6, delta.dtype)
    return jnp.where(bad, big, ex), jnp.where(bad, big, ey), n
