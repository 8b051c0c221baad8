"""Landmark-SLAM filter schemes: EKF-SLAM and Rao-Blackwellized fastSLAM.

JAX equivalents of the last two Bayes++ schemes vendored by the
reference (src/sensorFusion/kalmanSLAM.{hpp,cpp} — joint-state Kalman
SLAM — and src/sensorFusion/fastSLAM.{hpp,cpp} — per-particle landmark
maps). The reference never wires these into its pipelines (its mapping
is grid/pose-graph based), but they are part of the library surface it
ships, so the framework provides them.

Accelerator-first design, not a port:

- Fixed capacity everywhere: ``L_max`` landmark slots with a validity
  mask instead of Bayes++'s dynamically grown state; unseen-landmark
  initialization is a masked select, so every step has static shapes
  and jits once.
- fastSLAM is *fully vectorized*: ``[P]`` particles × ``[L]`` landmark
  EKFs live in one pytree of arrays; predict/observe/resample are
  ``vmap``/``where`` over that block — the per-particle pointer maps of
  fastSLAM.cpp become two dense tensors the device chews through.
- Observation model is standard range-bearing
  ``z = (‖m − p‖, atan2(m − p) − θ)``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import se2

Array = jnp.ndarray

_TWO_PI = 2.0 * jnp.pi


def _range_bearing(pose: Array, lm: Array) -> Array:
    """h(pose, landmark) -> [range, bearing]."""
    d = lm - pose[:2]
    rng = jnp.sqrt(jnp.sum(d * d) + 1e-12)
    brg = se2.normalize_angle(jnp.arctan2(d[1], d[0]) - pose[2])
    return jnp.stack([rng, brg])


def _inverse_obs(pose: Array, z: Array) -> Array:
    """Landmark position implied by one (range, bearing) observation."""
    a = pose[2] + z[1]
    return pose[:2] + z[0] * jnp.stack([jnp.cos(a), jnp.sin(a)])


# ---------------------------------------------------------------------------
# EKF-SLAM (kalmanSLAM.cpp analog)
# ---------------------------------------------------------------------------


class EkfSlamState(NamedTuple):
    """Joint Gaussian over [robot(3), landmarks(2·L_max)]."""

    mean: Array      # [3 + 2L]
    cov: Array       # [3 + 2L, 3 + 2L]
    lm_valid: Array  # [L] bool

    @property
    def n_landmarks(self) -> int:
        return self.lm_valid.shape[0]

    def robot(self) -> Array:
        return self.mean[:3]

    def landmarks(self) -> Array:
        return self.mean[3:].reshape(-1, 2)


def ekfslam_init(
    pose: Array, max_landmarks: int, pose_cov: float = 1e-4
) -> EkfSlamState:
    d = 3 + 2 * max_landmarks
    mean = jnp.zeros(d, jnp.float32).at[:3].set(jnp.asarray(pose, jnp.float32))
    # unseen landmark blocks get huge prior variance; they are pinned by
    # their first observation
    cov = jnp.eye(d, dtype=jnp.float32) * 1e6
    cov = cov.at[:3, :3].set(jnp.eye(3) * pose_cov)
    return EkfSlamState(mean, cov, jnp.zeros(max_landmarks, bool))


def ekfslam_predict(
    state: EkfSlamState, motion: Array, q: Array | float
) -> EkfSlamState:
    """Robot moves by an SE(2) increment; landmarks are static
    (kalmanSLAM's predict touches only the robot block)."""
    pose = state.mean[:3]
    new_pose = se2.compose(pose, motion)
    c, s = jnp.cos(pose[2]), jnp.sin(pose[2])
    mx, my = motion[0], motion[1]
    Fr = jnp.asarray(
        [[1.0, 0.0, -s * mx - c * my], [0.0, 1.0, c * mx - s * my], [0.0, 0.0, 1.0]]
    )
    if jnp.ndim(q) == 0:
        q = jnp.eye(3) * q
    mean = state.mean.at[:3].set(new_pose)
    Prr = state.cov[:3, :3]
    Prm = state.cov[:3, 3:]
    cov = state.cov
    cov = cov.at[:3, :3].set(Fr @ Prr @ Fr.T + jnp.asarray(q))
    cov = cov.at[:3, 3:].set(Fr @ Prm)
    cov = cov.at[3:, :3].set((Fr @ Prm).T)
    return EkfSlamState(mean, cov, state.lm_valid)


def ekfslam_observe(
    state: EkfSlamState, lm_id: Array, z: Array, r: Array | float
) -> EkfSlamState:
    """Observe landmark ``lm_id`` as (range, bearing).

    First sighting initializes the landmark block from the inverse
    observation (kalmanSLAM's AddLandmark); later sightings run a joint
    EKF update. Both paths are computed and selected by mask, keeping
    the step jittable with a traced ``lm_id``.
    """
    if jnp.ndim(r) == 0:
        r = jnp.eye(2) * r
    R = jnp.asarray(r)
    L = state.n_landmarks
    lm_id = jnp.asarray(lm_id, jnp.int32)
    seen = state.lm_valid[lm_id]
    pose = state.mean[:3]

    # --- init path: pin the landmark block at the inverse observation
    lm0 = _inverse_obs(pose, z)
    a = pose[2] + z[1]
    ca, sa = jnp.cos(a), jnp.sin(a)
    # Jacobians of inverse obs wrt pose and z
    Gp = jnp.asarray(
        [[1.0, 0.0, -z[0] * sa], [0.0, 1.0, z[0] * ca]]
    )
    Gz = jnp.asarray([[ca, -z[0] * sa], [sa, z[0] * ca]])
    Pll = Gp @ state.cov[:3, :3] @ Gp.T + Gz @ R @ Gz.T
    Plx = Gp @ state.cov[:3, :]  # cross-cov with the whole state
    sl = 3 + 2 * lm_id
    init_mean = jax.lax.dynamic_update_slice(state.mean, lm0, (sl,))
    init_cov = jax.lax.dynamic_update_slice(state.cov, Plx, (sl, 0))
    init_cov = jax.lax.dynamic_update_slice(init_cov, Plx.T, (0, sl))
    init_cov = jax.lax.dynamic_update_slice(init_cov, Pll, (sl, sl))

    # --- update path: joint EKF observe with sparse H = [Hr 0 .. Hl .. 0]
    lm = jax.lax.dynamic_slice(state.mean, (sl,), (2,))
    dxy = lm - pose[:2]
    q2 = jnp.sum(dxy * dxy) + 1e-12
    rng = jnp.sqrt(q2)
    Hr = jnp.asarray(
        [
            [-dxy[0] / rng, -dxy[1] / rng, 0.0],
            [dxy[1] / q2, -dxy[0] / q2, -1.0],
        ]
    )
    Hl = jnp.asarray(
        [[dxy[0] / rng, dxy[1] / rng], [-dxy[1] / q2, dxy[0] / q2]]
    )
    H = jnp.zeros((2, 3 + 2 * L), jnp.float32)
    H = H.at[:, :3].set(Hr)
    H = jax.lax.dynamic_update_slice(H, Hl, (0, sl))
    innov = z - _range_bearing(pose, lm)
    innov = innov.at[1].set(se2.normalize_angle(innov[1]))
    S = H @ state.cov @ H.T + R
    K = jnp.linalg.solve(S, H @ state.cov).T
    upd_mean = state.mean + K @ innov
    ikh = jnp.eye(3 + 2 * L) - K @ H
    upd_cov = ikh @ state.cov @ ikh.T + K @ R @ K.T

    mean = jnp.where(seen, upd_mean, init_mean)
    cov = jnp.where(seen, upd_cov, init_cov)
    return EkfSlamState(mean, cov, state.lm_valid.at[lm_id].set(True))


# ---------------------------------------------------------------------------
# fastSLAM (fastSLAM.cpp analog): Rao-Blackwellized particle filter
# ---------------------------------------------------------------------------


class FastSlamState(NamedTuple):
    poses: Array      # [P, 3] particle robot poses
    log_w: Array      # [P] log weights
    lm_mean: Array    # [P, L, 2] per-particle landmark EKF means
    lm_cov: Array     # [P, L, 2, 2]
    lm_valid: Array   # [P, L] bool

    @property
    def n_particles(self) -> int:
        return self.poses.shape[0]


def fastslam_init(
    pose: Array, n_particles: int, max_landmarks: int
) -> FastSlamState:
    p = jnp.tile(jnp.asarray(pose, jnp.float32)[None, :], (n_particles, 1))
    return FastSlamState(
        poses=p,
        log_w=jnp.zeros(n_particles, jnp.float32),
        lm_mean=jnp.zeros((n_particles, max_landmarks, 2), jnp.float32),
        lm_cov=jnp.tile(
            jnp.eye(2, dtype=jnp.float32)[None, None] * 1e6,
            (n_particles, max_landmarks, 1, 1),
        ),
        lm_valid=jnp.zeros((n_particles, max_landmarks), bool),
    )


def fastslam_predict(
    state: FastSlamState, key: Array, motion: Array, sigma: Array
) -> FastSlamState:
    """Sample each particle's pose through the noisy motion model
    (the particle half of the Rao-Blackwellization)."""
    noise = jax.random.normal(key, state.poses.shape) * jnp.asarray(sigma)
    moved = jax.vmap(lambda p, n: se2.compose(p, motion + n))(state.poses, noise)
    return state._replace(poses=moved)


def _particle_observe(pose, lm_mean, lm_cov, valid, z, R):
    """One particle × one landmark EKF observe; returns updated landmark
    and the particle's log-likelihood contribution."""
    # init path
    lm0 = _inverse_obs(pose, z)
    a = pose[2] + z[1]
    Gz = jnp.asarray(
        [[jnp.cos(a), -z[0] * jnp.sin(a)], [jnp.sin(a), z[0] * jnp.cos(a)]]
    )
    cov0 = Gz @ R @ Gz.T
    # update path
    zhat = _range_bearing(pose, lm_mean)
    dxy = lm_mean - pose[:2]
    q2 = jnp.sum(dxy * dxy) + 1e-12
    rng = jnp.sqrt(q2)
    Hl = jnp.asarray(
        [[dxy[0] / rng, dxy[1] / rng], [-dxy[1] / q2, dxy[0] / q2]]
    )
    innov = z - zhat
    innov = innov.at[1].set(se2.normalize_angle(innov[1]))
    S = Hl @ lm_cov @ Hl.T + R
    Sinv = jnp.linalg.inv(S)
    K = lm_cov @ Hl.T @ Sinv
    upd_mean = lm_mean + K @ innov
    upd_cov = (jnp.eye(2) - K @ Hl) @ lm_cov
    loglik = -0.5 * (
        innov @ Sinv @ innov + jnp.log(jnp.linalg.det(S)) + 2 * jnp.log(_TWO_PI)
    )
    new_mean = jnp.where(valid, upd_mean, lm0)
    new_cov = jnp.where(valid, upd_cov, cov0)
    # unseen landmarks contribute a constant (importance weight 1)
    return new_mean, new_cov, jnp.where(valid, loglik, 0.0)


def fastslam_observe(
    state: FastSlamState, lm_id: Array, z: Array, r: Array | float
) -> FastSlamState:
    """All particles observe landmark ``lm_id``; weights multiply by the
    per-particle innovation likelihood (fastSLAM's observe + weighting),
    vectorized as one vmap over the particle block."""
    if jnp.ndim(r) == 0:
        r = jnp.eye(2) * r
    R = jnp.asarray(r)
    lm_id = jnp.asarray(lm_id, jnp.int32)

    def per_particle(pose, lms, lcovs, valids, lw):
        m, c, v = lms[lm_id], lcovs[lm_id], valids[lm_id]
        nm, nc, ll = _particle_observe(pose, m, c, v, z, R)
        return (
            lms.at[lm_id].set(nm),
            lcovs.at[lm_id].set(nc),
            valids.at[lm_id].set(True),
            lw + ll,
        )

    lm_mean, lm_cov, lm_valid, log_w = jax.vmap(per_particle)(
        state.poses, state.lm_mean, state.lm_cov, state.lm_valid, state.log_w
    )
    return FastSlamState(state.poses, log_w, lm_mean, lm_cov, lm_valid)


def fastslam_resample(state: FastSlamState, key: Array) -> FastSlamState:
    """Systematic resampling of the whole particle block (poses and
    landmark maps together — the map rides with its particle)."""
    P = state.n_particles
    w = jax.nn.softmax(state.log_w)
    cdf = jnp.cumsum(w)
    u0 = jax.random.uniform(key, (), minval=0.0, maxval=1.0 / P)
    pts = u0 + jnp.arange(P) / P
    idx = jnp.searchsorted(cdf, pts)
    idx = jnp.clip(idx, 0, P - 1)
    return FastSlamState(
        poses=state.poses[idx],
        log_w=jnp.zeros(P, jnp.float32),
        lm_mean=state.lm_mean[idx],
        lm_cov=state.lm_cov[idx],
        lm_valid=state.lm_valid[idx],
    )


def fastslam_neff(state: FastSlamState) -> Array:
    w = jax.nn.softmax(state.log_w)
    return 1.0 / jnp.sum(w * w)


def fastslam_estimate(state: FastSlamState) -> tuple[Array, Array]:
    """Weighted mean pose and the best particle's landmark map."""
    w = jax.nn.softmax(state.log_w)
    xy = jnp.sum(w[:, None] * state.poses[:, :2], axis=0)
    th = jnp.arctan2(
        jnp.sum(w * jnp.sin(state.poses[:, 2])),
        jnp.sum(w * jnp.cos(state.poses[:, 2])),
    )
    best = jnp.argmax(state.log_w)
    return jnp.concatenate([xy, th[None]]), state.lm_mean[best]
