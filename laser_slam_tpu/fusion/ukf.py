"""Unscented Kalman filtering for multi-sensor pose fusion.

Batched JAX replacement for the reference's vendored Bayes++ stack
(src/sensorFusion/: ``Unscented_scheme`` in unsFlt.cpp, plus the
predict/observe models in config.hpp and the fusion loop in
src/slam/threadFusion.cpp:89-155). The reference fuses SICK-SLAM poses,
odometry increments, beacon fixes, and a nonlinear GPS range model into
an SE(2) state; the models here mirror that surface:

- :func:`predict` — near-identity motion with (large) additive process
  noise (``Robot_predict``, config.hpp:58-72);
- :func:`update_pose` — full-pose linear observation with angle wrapping
  (the SICK / global-sync observes, config.hpp:77-178);
- :func:`update_partial` — observe any linear slice of the state
  (beacon x/y fixes);
- :func:`update_nonlinear` — generic unscented update for nonlinear
  models (the GPS range observe, config.hpp:180-197).

All functions are pure ``(state, ...) -> state`` and jit/vmap friendly;
the sigma-point propagation is a tiny batched matmul. (The reference's
SIR particle scheme is covered by :mod:`..localization.particle_filter`;
its covariance/UdU filters exist only to support these two schemes.)
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from ..core import se2

Array = jnp.ndarray

# Unscented transform parameters (Julier's symmetric set with the
# customary scaling; Bayes++ uses kappa defaulting to 3 - n).
ALPHA = 1e-1
BETA = 2.0


class UkfState(NamedTuple):
    mean: Array  # [D]
    cov: Array   # [D, D]

    @property
    def dim(self) -> int:
        return self.mean.shape[0]


def init(mean: Array, cov: Array | float) -> UkfState:
    mean = jnp.asarray(mean, jnp.float32)
    d = mean.shape[0]
    if jnp.ndim(cov) == 0:
        cov = jnp.eye(d) * cov
    return UkfState(mean=mean, cov=jnp.asarray(cov, jnp.float32))


def _sigma_points(state: UkfState) -> tuple[Array, Array, Array]:
    """Symmetric sigma points ``[2D+1, D]`` + mean/cov weights."""
    d = state.dim
    lam = ALPHA * ALPHA * (d + 3.0 - d) - d
    scale = d + lam
    sqrt_cov = jnp.linalg.cholesky(
        state.cov * scale + 1e-9 * jnp.eye(d)
    )
    pts = jnp.concatenate(
        [
            state.mean[None, :],
            state.mean[None, :] + sqrt_cov.T,
            state.mean[None, :] - sqrt_cov.T,
        ],
        axis=0,
    )
    wm = jnp.full(2 * d + 1, 1.0 / (2.0 * scale)).at[0].set(lam / scale)
    wc = wm.at[0].add(1.0 - ALPHA * ALPHA + BETA)
    return pts, wm, wc


def predict(
    state: UkfState,
    motion: Array | None = None,
    q: Array | float = 1.0,
) -> UkfState:
    """Propagate by an (optional) SE(2) increment and inflate covariance.

    With ``motion=None`` this is the reference's near-identity predict
    with large Q (config.hpp:58-72): the state barely moves, uncertainty
    grows, and the observations do the work.
    """
    d = state.dim
    if jnp.ndim(q) == 0:
        q = jnp.eye(d) * q
    if motion is None:
        return UkfState(mean=state.mean, cov=state.cov + q)
    mean = se2.compose(state.mean, motion)
    # Jacobian of compose wrt the state at (mean, motion).
    c, s = jnp.cos(state.mean[2]), jnp.sin(state.mean[2])
    mx, my = motion[0], motion[1]
    F = jnp.asarray(
        [
            [1.0, 0.0, -s * mx - c * my],
            [0.0, 1.0, c * mx - s * my],
            [0.0, 0.0, 1.0],
        ]
    )
    cov = F @ state.cov @ F.T + q
    return UkfState(mean=mean, cov=cov)


def _joseph_update(state: UkfState, H: Array, innov: Array, R: Array) -> UkfState:
    S = H @ state.cov @ H.T + R
    K = state.cov @ H.T @ jnp.linalg.inv(S)
    mean = state.mean + K @ innov
    ikh = jnp.eye(state.dim) - K @ H
    cov = ikh @ state.cov @ ikh.T + K @ R @ K.T
    return UkfState(mean=mean, cov=cov)


def update_pose(state: UkfState, z: Array, r: Array | float) -> UkfState:
    """Observe the full SE(2) pose (SICK-SLAM / global-sync observes),
    wrapping the angle innovation."""
    if jnp.ndim(r) == 0:
        r = jnp.eye(3) * r
    H = jnp.eye(3)
    innov = z - state.mean
    innov = innov.at[2].set(se2.normalize_angle(innov[2]))
    out = _joseph_update(state, H, innov, jnp.asarray(r))
    return UkfState(
        mean=out.mean.at[2].set(se2.normalize_angle(out.mean[2])), cov=out.cov
    )


def update_partial(
    state: UkfState, idx: tuple[int, ...], z: Array, r: Array | float
) -> UkfState:
    """Observe a linear slice of the state (e.g. beacon (x, y) fix —
    config.hpp beacon observe)."""
    k = len(idx)
    if jnp.ndim(r) == 0:
        r = jnp.eye(k) * r
    H = jnp.zeros((k, state.dim)).at[jnp.arange(k), jnp.asarray(idx)].set(1.0)
    innov = z - state.mean[jnp.asarray(idx)]
    return _joseph_update(state, H, innov, jnp.asarray(r))


def update_nonlinear(
    state: UkfState,
    h: Callable[[Array], Array],
    z: Array,
    r: Array | float,
) -> UkfState:
    """Generic unscented update for a nonlinear observation ``h(x)``
    (the GPS range model, config.hpp:180-197)."""
    pts, wm, wc = _sigma_points(state)
    zs = jax.vmap(h)(pts)                                  # [2D+1, K]
    if zs.ndim == 1:
        zs = zs[:, None]
        z = jnp.atleast_1d(z)
    k = zs.shape[1]
    if jnp.ndim(r) == 0:
        r = jnp.eye(k) * r
    z_mean = jnp.sum(wm[:, None] * zs, axis=0)
    dz = zs - z_mean[None, :]
    dx = pts - state.mean[None, :]
    S = jnp.einsum("n,ni,nj->ij", wc, dz, dz) + jnp.asarray(r)
    C = jnp.einsum("n,ni,nj->ij", wc, dx, dz)
    K = C @ jnp.linalg.inv(S)
    mean = state.mean + K @ (z - z_mean)
    cov = state.cov - K @ S @ K.T
    return UkfState(mean=mean, cov=cov)


class FusionInputs(NamedTuple):
    """One fusion tick's gated sensor data (the threadFusion loop gates
    each sensor by timestamp freshness, threadFusion.cpp:89-155).
    Invalid sensors are masked, keeping the step jittable.

    Timestamps default to +inf ("always fresh") so timestamp-free
    callers keep the old behavior; a live pipeline should stamp each
    observation with its capture time (seconds, any common origin)."""

    odom_rel: Array      # [3] odometry increment since last tick
    odom_valid: Array    # [] bool
    slam_pose: Array     # [3] scan-matcher pose
    slam_valid: Array    # [] bool
    beacon_xy: Array     # [2]
    beacon_valid: Array  # [] bool
    slam_t: Array = jnp.inf    # [] capture time of the SLAM pose
    beacon_t: Array = jnp.inf  # [] capture time of the beacon fix


def fusion_step(
    state: UkfState,
    inp: FusionInputs,
    q: float = 0.05,
    r_slam: float = 0.02,
    r_beacon: float = 0.25,
    filter_t: Array | float = -jnp.inf,
) -> tuple[UkfState, Array]:
    """One fused tick: predict by odometry, then apply whichever
    observations are fresh (prepareFusedNode_online semantics).

    Timestamp gating mirrors the reference's fusion loop, which tracks
    ``t_filter_current`` and consumes each sensor buffer only when it
    holds a *newer* observation (updateMainSICKNode,
    threadFusion.cpp:225-300): an observation stamped at or before
    ``filter_t`` is stale (already consumed, or delivered out of order
    after the filter advanced past it) and is skipped. Returns
    ``(state, new_filter_t)``; pass the returned time into the next
    tick. Callers that never stamp observations (all defaults) get the
    old always-fresh behavior.
    """
    filter_t = jnp.asarray(filter_t, jnp.float32)
    motion = jnp.where(inp.odom_valid, inp.odom_rel, jnp.zeros(3))
    state = predict(state, motion, q)

    slam_fresh = inp.slam_valid & (inp.slam_t > filter_t)
    upd_slam = update_pose(state, inp.slam_pose, r_slam)
    state = jax.tree.map(
        lambda a, b: jnp.where(slam_fresh, a, b), upd_slam, state
    )
    beacon_fresh = inp.beacon_valid & (inp.beacon_t > filter_t)
    upd_bn = update_partial(state, (0, 1), inp.beacon_xy, r_beacon)
    state = jax.tree.map(
        lambda a, b: jnp.where(beacon_fresh, a, b), upd_bn, state
    )
    consumed = jnp.stack(
        [
            jnp.where(slam_fresh & jnp.isfinite(inp.slam_t),
                      inp.slam_t, filter_t),
            jnp.where(beacon_fresh & jnp.isfinite(inp.beacon_t),
                      inp.beacon_t, filter_t),
        ]
    )
    return state, jnp.max(consumed)
