"""Velocity-profile trajectory generation (Trajectory.cpp parity).

The reference's trajectory layer (src/Main-Ctrl/Task/Trajectory.cpp,
1687 LoC) converts a waypoint path into fixed-rate wheel-velocity
command schedules: per-segment trapezoidal speed profiles with
accel/decel limits (``NewSegmentRectilinear``/``CalMidSpd``,
Trajectory.cpp:1310-1513), cubic blending between segments
(``NewSegmentBlend``, 1515+), in-place spins (``Spin``, 1666), emitted
as ``CMD_SLICE_LEN`` = 0.05 s slices for the motor link
(MainCtrl_Define.h:131-139: MAX_ACC 0.8, MAX_DEACC −0.4, MAX_SPD 0.7).

XLA-idiomatic re-design: each profile is a CLOSED-FORM function of time
sampled onto a fixed-length slice grid with a validity mask — no
branch-per-slice loops; one jittable program covers every segment and
the whole schedule batches under ``vmap``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

Array = jnp.ndarray

# Reference constants (MainCtrl_Define.h:131-189).
MAX_ACC = 0.8        # [m/s²]
MAX_DEC = 0.4        # [m/s²] magnitude
MAX_SPD = 0.7        # [m/s]
CMD_SLICE = 0.05     # [s] command slice length
MAX_SLICES = 512     # fixed schedule capacity (25.6 s per segment)


class Profile(NamedTuple):
    v: Array         # [MAX_SLICES] speed at each slice [m/s]
    valid: Array     # [MAX_SLICES] bool — slice is part of the segment
    v_end: Array     # [] achieved end speed (may undershoot the request
    #                  when the segment is too short — the reference
    #                  recomputes fEndSpd the same way)
    t_total: Array   # [] profile duration [s]


def trapezoid_profile(
    dist: Array,
    v0: Array,
    v_end: Array,
    v_max: float = MAX_SPD,
    acc: float = MAX_ACC,
    dec: float = MAX_DEC,
    dt: float = CMD_SLICE,
) -> Profile:
    """Trapezoidal speed profile over a straight segment of ``dist`` m.

    Closed form of NewSegmentRectilinear's case ladder: clamp the
    requested end speed to what the distance allows, find the peak
    (``CalMidSpd``) or cruise speed, and sample accel/cruise/decel
    phases onto the slice grid.
    """
    dtype = jnp.result_type(jnp.asarray(dist).dtype, jnp.float32)
    dist = jnp.asarray(dist, dtype)
    v0 = jnp.asarray(v0, dtype)
    v_end = jnp.asarray(v_end, dtype)

    # Reachable end-speed band over this distance.
    v_up = jnp.sqrt(jnp.maximum(v0 * v0 + 2.0 * acc * dist, 0.0))
    v_dn = jnp.sqrt(jnp.maximum(v0 * v0 - 2.0 * dec * dist, 0.0))
    ve = jnp.clip(v_end, v_dn, v_up)

    # Peak speed of the accel-then-decel triangle (CalMidSpd closed
    # form), capped by v_max into a cruise phase.
    v_peak_sq = (2.0 * acc * dec * dist + dec * v0 * v0 + acc * ve * ve) / (
        acc + dec
    )
    v_peak = jnp.sqrt(jnp.maximum(v_peak_sq, 0.0))
    v_cruise = jnp.minimum(v_peak, jnp.asarray(v_max, dtype))
    v_cruise = jnp.maximum(v_cruise, jnp.maximum(v0, ve))  # pure ramp cases

    t1 = (v_cruise - v0) / acc                       # accel duration
    t3 = (v_cruise - ve) / dec                       # decel duration
    s1 = (v_cruise * v_cruise - v0 * v0) / (2.0 * acc)
    s3 = (v_cruise * v_cruise - ve * ve) / (2.0 * dec)
    s2 = jnp.maximum(dist - s1 - s3, 0.0)
    t2 = jnp.where(v_cruise > 1e-6, s2 / jnp.maximum(v_cruise, 1e-6), 0.0)
    t_total = t1 + t2 + t3

    t = (jnp.arange(MAX_SLICES, dtype=dtype) + 0.5) * dt
    v_t = jnp.where(
        t < t1,
        v0 + acc * t,
        jnp.where(
            t < t1 + t2,
            v_cruise,
            jnp.maximum(v_cruise - dec * (t - t1 - t2), ve),
        ),
    )
    valid = t < t_total
    return Profile(
        v=jnp.where(valid, v_t, 0.0), valid=valid, v_end=ve,
        t_total=t_total,
    )


def spin_profile(
    angle: Array,
    omega_max: float = 1.0,
    alpha: float = 2.0,
    dt: float = CMD_SLICE,
) -> Profile:
    """In-place turn schedule (Spin, Trajectory.cpp:1666): triangular /
    trapezoidal angular-rate profile through ``angle`` rad; ``v`` holds
    the SIGNED angular rate."""
    dtype = jnp.float32
    a = jnp.abs(jnp.asarray(angle, dtype))
    sgn = jnp.sign(jnp.asarray(angle, dtype))
    w_peak = jnp.minimum(jnp.sqrt(alpha * a), omega_max)
    t1 = w_peak / alpha
    s1 = w_peak * w_peak / (2.0 * alpha)
    t2 = jnp.where(w_peak > 1e-6,
                   jnp.maximum(a - 2.0 * s1, 0.0) / jnp.maximum(w_peak, 1e-6),
                   0.0)
    t_total = 2.0 * t1 + t2
    t = (jnp.arange(MAX_SLICES, dtype=dtype) + 0.5) * dt
    w = jnp.where(
        t < t1,
        alpha * t,
        jnp.where(t < t1 + t2, w_peak,
                  jnp.maximum(w_peak - alpha * (t - t1 - t2), 0.0)),
    )
    valid = t < t_total
    return Profile(
        v=jnp.where(valid, sgn * w, 0.0), valid=valid,
        v_end=jnp.zeros((), dtype), t_total=t_total,
    )


def wheel_velocities(v: Array, omega: Array, wheel_base: float) -> tuple:
    """Differential-drive wheel speeds ``(vL, vR)`` from (v, ω) — the
    CalWheelVel conversion (Trajectory.cpp:349)."""
    half = 0.5 * wheel_base
    return v - half * omega, v + half * omega


class BlendedCorner(NamedTuple):
    xy: Array        # [S, 2] sampled blended positions (world frame)
    ok: Array        # [] bool — corner was blendable (non-degenerate)


def blend_corner(
    p0: Array, p1: Array, p2: Array, n_slices: int = 100,
    blend_lo: float = 0.1, blend_hi: float = 0.9,
) -> BlendedCorner:
    """Cubic corner blend through waypoint triple ``(p0, p1, p2)`` —
    the role of ``NewSegmentBlend`` (Trajectory.cpp:1515-1640): rotate
    into the chord frame (p0→p2 along x), follow the p0→p1 line to 10%
    of the chord, a cubic matching position+slope of both lines to 90%,
    then the p1→p2 line. The reference walks a per-slice if/else ladder;
    here the piecewise curve is evaluated for ALL slices at once with
    masks — one jittable program, batchable over corners with ``vmap``.

    Degenerate corners (p0≈p2 U-turns, or a leg parallel to the chord
    normal making a line slope infinite) report ``ok=False`` — the
    caller keeps the sharp corner and lets the schedule's corner-speed
    drop / spin handle it, as the reference falls back to Spin.
    """
    dtype = jnp.float32
    p0 = jnp.asarray(p0, dtype)
    p1 = jnp.asarray(p1, dtype)
    p2 = jnp.asarray(p2, dtype)
    chord = p2 - p0
    clen = jnp.linalg.norm(chord)
    theta = jnp.arctan2(chord[1], chord[0])
    c, s = jnp.cos(-theta), jnp.sin(-theta)

    def to_local(p):
        d = p - p0
        return jnp.stack([c * d[0] - s * d[1], s * d[0] + c * d[1]])

    q1 = to_local(p1)
    q2 = jnp.stack([clen, jnp.zeros((), dtype)])

    # Line slopes in the chord frame (y as a function of x).
    dx1 = jnp.maximum(jnp.abs(q1[0]), 1e-6) * jnp.sign(
        jnp.where(q1[0] == 0, 1.0, q1[0])
    )
    dx2 = q2[0] - q1[0]
    dx2 = jnp.maximum(jnp.abs(dx2), 1e-6) * jnp.sign(
        jnp.where(dx2 == 0, 1.0, dx2)
    )
    k1 = q1[1] / dx1
    k2 = (q2[1] - q1[1]) / dx2
    b2 = q1[1] - k2 * q1[0]

    xl = q2[0]
    x0 = blend_lo * xl
    y0 = k1 * x0
    x1 = blend_hi * xl
    y1 = k2 * x1 + b2
    xd = jnp.maximum(x1 - x0, 1e-6)
    # Cubic a0 + a1 t + a2 t² + a3 t³ over t = x - x0, matching value
    # and slope at both blend points (the reference's fA0..fA3).
    a0 = y0
    a1 = k1
    a2 = 3.0 * (y1 - y0) / xd**2 - (2.0 * k1 + k2) / xd
    a3 = -2.0 * (y1 - y0) / xd**3 + (k1 + k2) / xd**2

    x = jnp.linspace(0.0, 1.0, n_slices, dtype=dtype) * xl
    t = x - x0
    y = jnp.where(
        x < x0,
        k1 * x,
        jnp.where(
            x <= x1,
            a0 + a1 * t + a2 * t * t + a3 * t**3,
            k2 * x + b2,
        ),
    )
    # Rotate back to world.
    cb, sb = jnp.cos(theta), jnp.sin(theta)
    xy = jnp.stack(
        [p0[0] + cb * x - sb * y, p0[1] + sb * x + cb * y], axis=-1
    )
    # Blendable: chord long enough, both legs advance monotonically
    # along the chord (a backtracking leg means a U-turn).
    ok = (clen > 0.05) & (q1[0] > 0.02) & (q2[0] - q1[0] > 0.02)
    return BlendedCorner(xy=xy, ok=ok)


class WheelSchedule(NamedTuple):
    v_l: Array       # [S] left wheel speed per CMD_SLICE [m/s]
    v_r: Array       # [S] right wheel speed
    valid: Array     # [S]


def wheel_schedule_along(
    xy: np.ndarray,
    v_max: float = MAX_SPD,
    acc: float = MAX_ACC,
    dec: float = MAX_DEC,
    wheel_base: float = 0.5,
    dt: float = CMD_SLICE,
    max_slices: int = 4 * MAX_SLICES,
) -> WheelSchedule:
    """Open-loop differential wheel commands along a (blended) polyline:
    a trapezoidal speed profile over its arc length plus the curvature-
    induced ω at each slice — the CMD_SLICE stream Trajectory.cpp
    generates for the motor link (vctWL/vctWR)."""
    xy = np.asarray(xy, np.float32).reshape(-1, 2)
    seg = np.diff(xy, axis=0)
    seg_len = np.linalg.norm(seg, axis=1)
    arc = np.concatenate([[0.0], np.cumsum(seg_len)])
    total = float(arc[-1])
    heads = np.unwrap(np.arctan2(seg[:, 1], seg[:, 0]))

    prof = trapezoid_profile(total, 0.0, 0.0, v_max, acc, dec, dt)
    v = np.asarray(prof.v)
    valid = np.asarray(prof.valid)
    # Arc position at each slice midpoint → heading → ω = dθ/dt.
    s_at = np.cumsum(v * dt)
    idx = np.clip(np.searchsorted(arc, s_at) - 1, 0, len(heads) - 1)
    th = heads[idx]
    om = np.zeros_like(v)
    om[1:] = (th[1:] - th[:-1]) / dt
    om = np.clip(om, -2.0, 2.0)
    vl, vr = wheel_velocities(jnp.asarray(v), jnp.asarray(om), wheel_base)
    n = min(len(v), max_slices)
    return WheelSchedule(
        v_l=jnp.asarray(vl)[:n], v_r=jnp.asarray(vr)[:n],
        valid=jnp.asarray(valid)[:n],
    )


def blend_path(
    path: np.ndarray, n_slices: int = 40,
) -> np.ndarray:
    """Smooth a waypoint polyline by blending every interior corner
    (vmapped :func:`blend_corner`); unblendable corners stay sharp.
    Returns the densified polyline ``[M, 2]``."""
    import jax

    path = np.asarray(path, np.float32).reshape(-1, 2)
    if len(path) < 3:
        return path
    p0 = jnp.asarray(path[:-2])
    p1 = jnp.asarray(path[1:-1])
    p2 = jnp.asarray(path[2:])
    out = jax.jit(
        jax.vmap(lambda a, b, c_: blend_corner(a, b, c_, n_slices))
    )(p0, p1, p2)
    xy, ok = np.asarray(out.xy), np.asarray(out.ok)
    pts = [path[:1]]
    for i in range(len(ok)):
        if ok[i]:
            # Use the corner's middle half (the blend region); the
            # straight parts come from the neighboring entries.
            pts.append(xy[i][n_slices // 4: 3 * n_slices // 4])
        else:
            pts.append(path[i + 1: i + 2])
    pts.append(path[-1:])
    return np.concatenate(pts, axis=0)


class Schedule(NamedTuple):
    v: Array         # [S, MAX_SLICES] per-segment speeds
    valid: Array     # [S, MAX_SLICES]
    seg_ok: Array    # [S] segment is real (not padding)
    headings: Array  # [S] segment headings [rad]


def plan_velocity_schedule(
    path: np.ndarray,
    speed_limits: np.ndarray | None = None,
    v_max: float = MAX_SPD,
    acc: float = MAX_ACC,
    dec: float = MAX_DEC,
    max_segments: int = 32,
) -> Schedule:
    """Whole-path schedule (NewTrajectory, Trajectory.cpp:1110): chain
    trapezoids over the waypoint segments, carrying each achieved end
    speed into the next segment's start, with per-segment limits; end
    speed at corners scales with the turn angle (sharp corner → stop,
    the role of segment blending's speed drop)."""
    path = np.asarray(path, np.float32).reshape(-1, 2)
    n_seg = max(len(path) - 1, 0)
    if speed_limits is None:
        speed_limits = np.full(n_seg, v_max, np.float32)
    d = np.diff(path, axis=0)
    lens = np.linalg.norm(d, axis=1)
    heads = np.arctan2(d[:, 1], d[:, 0])
    # Corner end-speed: full speed through straight joints, zero at
    # U-turns (linear in the turn angle).
    turn = np.abs(
        (np.diff(heads, append=heads[-1:] if n_seg else 0.0) + np.pi)
        % (2 * np.pi) - np.pi
    )
    v_corner = np.clip(1.0 - turn / np.pi, 0.0, 1.0) * np.minimum(
        speed_limits, v_max
    )
    v_corner[-1:] = 0.0                       # stop at the goal

    vs = np.zeros((max_segments, MAX_SLICES), np.float32)
    valids = np.zeros((max_segments, MAX_SLICES), bool)
    seg_ok = np.zeros(max_segments, bool)
    headings = np.zeros(max_segments, np.float32)
    v0 = 0.0
    for i in range(min(n_seg, max_segments)):
        vm = float(min(speed_limits[i], v_max))
        p = trapezoid_profile(lens[i], v0, float(v_corner[i]), vm, acc, dec)
        vs[i] = np.asarray(p.v)
        valids[i] = np.asarray(p.valid)
        seg_ok[i] = True
        headings[i] = heads[i]
        v0 = float(p.v_end)
    return Schedule(
        v=jnp.asarray(vs), valid=jnp.asarray(valids),
        seg_ok=jnp.asarray(seg_ok), headings=jnp.asarray(headings),
    )
