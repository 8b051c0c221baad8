"""Monte-Carlo localization: vmapped particle cloud.

Batched JAX replacement for the reference's Bayes++ SIR particle filter
(``CParticles`` over ``SIR_scheme``, src/localization/particles.cpp, and
the MRPT MCL demo src/mrptpf/). The reference evaluates 60 particles
serially, each doing a DDA ray trace + an MRPT ICP match
(particles.cpp:321-387); here the whole cloud (thousands of particles)
evaluates in one batched call using any of three observation models:

- ``field``: likelihood-field endpoint model (one gather per beam —
  fastest, no reference equivalent),
- ``beam``: ray-cast Gaussian beam model (obsLikelyhood3 semantics),
- ``icp``: per-particle trimmed point-ICP refinement against the map
  cloud with goodness weights and pose nudging (obsLikelyhood
  semantics, VPmap.cpp:485-503 — the particle is moved to the ICP
  corrected pose like the reference does).

Resampling is systematic (replacing Bayes++
``SIR_scheme::update_resample``) triggered below the same Neff < 0.5·P
threshold (particles.cpp:350-354). Global relocalization scores a large
uniform pose batch in one shot (localization.cpp:483-540 runs 10 000
serially).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import se2
from ..core.scan import LaserModel
from ..mapping.occupancy import OccupancyGrid, occupied_points
from ..ops.icp_points import match_icp_points
from .raycast import beam_likelihood, endpoint_likelihood, likelihood_field

Array = jnp.ndarray

# Reference noise/Neff constants (localization/globaldef.cpp:13-30).
PREDICT_SIGMA_XY = 0.25       # [m]
PREDICT_SIGMA_THETA = 0.15    # [rad] (ref uses (pi/6)² variance)
NEFF_RESAMPLE_FRACTION = 0.5
TOP_K = 8                     # top-K weighted mean (particles.cpp:346-386)


class ParticleState(NamedTuple):
    poses: Array    # [P, 3]
    log_w: Array    # [P] log weights (normalized)

    @property
    def n(self) -> int:
        return self.poses.shape[0]


def _normalize(log_w: Array) -> Array:
    return log_w - jax.scipy.special.logsumexp(log_w)


def init_gaussian(
    key: Array, pose: Array, n: int,
    sigma_xy: float = PREDICT_SIGMA_XY,
    sigma_theta: float = PREDICT_SIGMA_THETA,
) -> ParticleState:
    """Cloud around a known pose (particles.cpp:72-92)."""
    kx, kt = jax.random.split(key)
    noise_xy = jax.random.normal(kx, (n, 2)) * sigma_xy
    noise_t = jax.random.normal(kt, (n,)) * sigma_theta
    poses = jnp.stack(
        [
            pose[0] + noise_xy[:, 0],
            pose[1] + noise_xy[:, 1],
            se2.normalize_angle(pose[2] + noise_t),
        ],
        axis=-1,
    )
    return ParticleState(poses=poses, log_w=_normalize(jnp.zeros(n)))


def predict(
    state: ParticleState, rel: Array, key: Array,
    sigma_xy: float = PREDICT_SIGMA_XY,
    sigma_theta: float = PREDICT_SIGMA_THETA,
) -> ParticleState:
    """Propagate every particle by the odometry increment ``rel`` plus
    Gaussian noise. (The reference collapses the cloud to the fused mean
    before jittering, particles.cpp:119-153 — a standard SIR propagate
    keeps multimodality, so we propagate per-particle.)"""
    n = state.n
    kx, kt = jax.random.split(key)
    moved = se2.compose(state.poses, rel[None, :])
    noise_xy = jax.random.normal(kx, (n, 2)) * sigma_xy
    noise_t = jax.random.normal(kt, (n,)) * sigma_theta
    poses = jnp.stack(
        [
            moved[:, 0] + noise_xy[:, 0],
            moved[:, 1] + noise_xy[:, 1],
            se2.normalize_angle(moved[:, 2] + noise_t),
        ],
        axis=-1,
    )
    return ParticleState(poses=poses, log_w=state.log_w)


def update_field(
    state: ParticleState,
    field: Array,
    grid: OccupancyGrid,
    model: LaserModel,
    ranges: Array,
    valid: Array,
) -> ParticleState:
    """Likelihood-field weight update (one batched gather)."""
    lik = jax.vmap(
        lambda p: endpoint_likelihood(field, grid.spec, model, p, ranges, valid)
    )(state.poses)
    log_w = _normalize(state.log_w + jnp.log(lik + 1e-12))
    return ParticleState(poses=state.poses, log_w=log_w)


def update_beam(
    state: ParticleState,
    grid: OccupancyGrid,
    model: LaserModel,
    ranges: Array,
    valid: Array,
    sigma: float = 0.5,
) -> ParticleState:
    """Ray-cast beam-model update (obsLikelyhood3 semantics)."""
    lik = jax.vmap(
        lambda p: beam_likelihood(grid, model, p, ranges, valid, sigma=sigma)
    )(state.poses)
    log_w = _normalize(state.log_w + jnp.log(lik + 1e-12))
    return ParticleState(poses=state.poses, log_w=log_w)


def update_icp(
    state: ParticleState,
    map_pts: Array,
    map_valid: Array,
    model: LaserModel,
    scan_pts: Array,
    scan_valid: Array,
    nudge: bool = True,
) -> ParticleState:
    """ICP-refined update: match the scan from each particle pose against
    the map cloud; weight by goodness and (optionally) move the particle
    to the corrected pose — the reference's obsLikelyhood flow
    (VPmap.cpp:485-503, particle nudging at particles.cpp:341-344)."""
    res = jax.vmap(
        lambda p: match_icp_points(
            map_pts, map_valid, scan_pts, scan_valid, p,
            iters=10, max_corr=0.6,
        )
    )(state.poses)
    lik = jnp.where(res.fail, 1e-6, res.goodness)
    poses = jnp.where((res.fail | (not nudge))[:, None], state.poses, res.pose)
    log_w = _normalize(state.log_w + jnp.log(lik + 1e-12))
    return ParticleState(poses=poses, log_w=log_w)


def neff(state: ParticleState) -> Array:
    w = jnp.exp(state.log_w)
    return 1.0 / jnp.sum(w * w)


def systematic_resample(state: ParticleState, key: Array) -> ParticleState:
    """Systematic (low-variance) resampling — replaces Bayes++
    ``SIRFlt``'s systematic scheme."""
    n = state.n
    w = jnp.exp(state.log_w)
    cum = jnp.cumsum(w)
    u0 = jax.random.uniform(key, ()) / n
    u = u0 + jnp.arange(n) / n
    idx = jnp.searchsorted(cum, u)
    idx = jnp.clip(idx, 0, n - 1)
    return ParticleState(
        poses=state.poses[idx], log_w=_normalize(jnp.zeros(n))
    )


def maybe_resample(state: ParticleState, key: Array) -> ParticleState:
    """Resample when Neff < 0.5·P (particles.cpp:350-354)."""
    do = neff(state) < NEFF_RESAMPLE_FRACTION * state.n
    resampled = systematic_resample(state, key)
    return jax.tree.map(
        lambda a, b: jnp.where(do, a, b), resampled, state
    )


def track_field(
    state: ParticleState,
    rel: Array,
    ranges: Array,
    valid: Array,
    key: Array,
    field: Array,
    grid: OccupancyGrid,
    model: LaserModel,
    sigma_xy: float = 0.05,
    sigma_theta: float = 0.03,
) -> tuple[ParticleState, Array]:
    """One tracking tick on a likelihood field: predict by the odometry
    step ``rel``, weight by the scan, resample when degenerate; returns
    ``(state, pose estimate [3])``. Jit it whole: one dispatch per tick."""
    k1, k2 = jax.random.split(key)
    state = predict(state, rel, k1, sigma_xy=sigma_xy, sigma_theta=sigma_theta)
    state = update_field(state, field, grid, model, ranges, valid)
    state = maybe_resample(state, k2)
    return state, estimate(state)


def estimate(state: ParticleState, top_k: int = TOP_K) -> Array:
    """Weighted mean over the top-K particles with circular angle
    averaging (particles.cpp:258-281 weightMean)."""
    k = min(top_k, state.n)
    vals, idx = jax.lax.top_k(state.log_w, k)
    w = jnp.exp(vals - jax.scipy.special.logsumexp(vals))
    sel = state.poses[idx]
    x = jnp.sum(w * sel[:, 0])
    y = jnp.sum(w * sel[:, 1])
    c = jnp.sum(w * jnp.cos(sel[:, 2]))
    s = jnp.sum(w * jnp.sin(sel[:, 2]))
    return jnp.stack([x, y, jnp.arctan2(s, c)])


def dispersion(state: ParticleState, top_k: int = TOP_K) -> Array:
    """Mean distance of the top-K particles from their weighted mean —
    the reference's convergence confidence gate (particles.cpp:239-256)."""
    k = min(top_k, state.n)
    _, idx = jax.lax.top_k(state.log_w, k)
    sel = state.poses[idx, :2]
    mean = estimate(state, top_k)[:2]
    return jnp.mean(jnp.linalg.norm(sel - mean[None, :], axis=-1))


def global_relocalize(
    key: Array,
    grid: OccupancyGrid,
    field: Array,
    model: LaserModel,
    ranges: Array,
    valid: Array,
    n_samples: int = 10_000,
    n_keep: int = 1024,
) -> ParticleState:
    """Global relocalization: score a uniform batch of valid free-space
    poses in one shot and keep the best ``n_keep`` as the new cloud
    (localization.cpp:483-540, g_num_of_global_particles=10000)."""
    spec = grid.spec
    kx, ky, kt = jax.random.split(key, 3)
    x = jax.random.uniform(
        kx, (n_samples,),
        minval=spec.origin_x, maxval=spec.origin_x + spec.width * spec.resolution,
    )
    y = jax.random.uniform(
        ky, (n_samples,),
        minval=spec.origin_y, maxval=spec.origin_y + spec.height * spec.resolution,
    )
    th = jax.random.uniform(kt, (n_samples,), minval=-jnp.pi, maxval=jnp.pi)
    poses = jnp.stack([x, y, th], axis=-1)

    # Validity: the cell must be known free space (localization.cpp:512).
    ix = jnp.floor((x - spec.origin_x) / spec.resolution).astype(jnp.int32)
    iy = jnp.floor((y - spec.origin_y) / spec.resolution).astype(jnp.int32)
    ix = jnp.clip(ix, 0, spec.width - 1)
    iy = jnp.clip(iy, 0, spec.height - 1)
    lo = grid.log_odds[iy, ix]
    free = lo < 0.0

    lik = jax.vmap(
        lambda p: endpoint_likelihood(field, spec, model, p, ranges, valid)
    )(poses)
    score = jnp.where(free, lik, 0.0)
    vals, idx = jax.lax.top_k(score, n_keep)
    return ParticleState(
        poses=poses[idx],
        log_w=_normalize(jnp.log(vals + 1e-12)),
    )


# --- KLD adaptive sampling (MRPT MCL demo parity) -----------------------
# The reference vendors MRPT's pf-localization app whose sample size is
# chosen by KLD-sampling (CMonteCarloLocalization2D with adaptive KLD,
# src/mrptpf/pf_localization_main.cpp:162). Fox's bound: with k occupied
# histogram bins, n >= (k-1)/(2eps) * (1 - 2/(9(k-1)) +
# sqrt(2/(9(k-1))) * z_{1-delta})^3 keeps the KL divergence between the
# sampled and true posterior below eps with confidence 1-delta.
#
# On the device the cloud is fixed-shape, so instead of growing/shrinking
# arrays the adaptive size becomes an *active-particle count*: excess
# particles get -inf log weight and drop out of estimates, resampling,
# and updates (their lanes still compute — fixed shapes are the point).

KLD_BIN_XY = 0.5          # [m] histogram bin (MRPT default KLD_binSize_XY)
KLD_BIN_THETA = 0.1745    # [rad] 10 deg (KLD_binSize_PHI)
KLD_EPSILON = 0.02        # KLD_delta
KLD_Z = 2.326             # z_{1-delta} for delta = 0.01
KLD_MIN_PARTICLES = 64


def kld_sample_size(
    state: ParticleState,
    bin_xy: float = KLD_BIN_XY,
    bin_theta: float = KLD_BIN_THETA,
    epsilon: float = KLD_EPSILON,
    z: float = KLD_Z,
) -> Array:
    """Fox's KLD bound on the number of particles needed, from the count
    of occupied (x, y, theta) histogram bins of the *live* cloud."""
    live = jnp.isfinite(state.log_w)
    bx = jnp.floor(state.poses[:, 0] / bin_xy).astype(jnp.int32)
    by = jnp.floor(state.poses[:, 1] / bin_xy).astype(jnp.int32)
    bt = jnp.floor(
        se2.normalize_angle(state.poses[:, 2]) / bin_theta
    ).astype(jnp.int32)
    # Distinct-bin count via sort: fixed-shape "unique" (int32 spatial
    # hash; collisions only make the bound slightly conservative).
    sentinel = jnp.iinfo(jnp.int32).max
    key = (bx * 73856093) ^ (by * 19349663) ^ (bt * 83492791)
    key = jnp.where(live & (key != sentinel), key, sentinel)
    s = jnp.sort(key)
    new_bin = jnp.concatenate(
        [jnp.ones(1, bool), s[1:] != s[:-1]]
    ) & (s != sentinel)
    k = jnp.maximum(jnp.sum(new_bin), 2).astype(jnp.float32)

    km1 = k - 1.0
    a = 2.0 / (9.0 * km1)
    n = km1 / (2.0 * epsilon) * (1.0 - a + jnp.sqrt(a) * z) ** 3
    return jnp.clip(n, KLD_MIN_PARTICLES, state.n).astype(jnp.int32)


def kld_resample(state: ParticleState, key: Array) -> ParticleState:
    """Systematic resample sized by the KLD bound: the first ``n_kld``
    lanes carry the resampled posterior, the rest are parked at -inf
    weight. Fixed compute, adaptive effective cloud size."""
    n = state.n
    n_kld = kld_sample_size(state)
    resampled = systematic_resample(state, key)
    lane = jnp.arange(n)
    active = lane < n_kld
    log_w = jnp.where(active, 0.0, -jnp.inf)
    return ParticleState(
        poses=resampled.poses, log_w=_normalize(log_w)
    )
