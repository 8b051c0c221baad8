"""Particle-filter localization tests on a synthetic room map."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from laser_slam_tpu.core import se2
from laser_slam_tpu.core.scan import LMS211
from laser_slam_tpu.localization import particle_filter as pf
from laser_slam_tpu.localization.raycast import (
    likelihood_field,
    simulate_scan,
)
from laser_slam_tpu.mapping.occupancy import (
    GridSpec2D,
    empty_grid,
    integrate_scans,
)
from laser_slam_tpu.ops.icp_points import scan_to_points
from laser_slam_tpu.ops.preprocess import preprocess

MODEL = LMS211
BOX = (-3.0, 5.0, -4.0, 4.0)


@pytest.fixture(scope="module")
def room_map(room):
    """Occupancy grid built by integrating room scans from a small
    trajectory of known poses."""
    poses = np.array(
        [[0, 0, 0], [1, 0, 0.4], [1, 1, 0.9], [0.2, 1.2, 1.8], [-0.5, 0.3, 2.6],
         [0.5, -0.8, -1.2], [1.5, 0.5, 0.2], [-1.0, -1.0, 0.7]],
        dtype=np.float32,
    )
    ranges = np.stack([room(MODEL, p, BOX) for p in poses])
    scans = preprocess(jnp.asarray(ranges), MODEL)
    spec = GridSpec2D(-5.0, -6.0, 0.05, 220, 220)
    grid = integrate_scans(empty_grid(spec), MODEL, scans, jnp.asarray(poses))
    field = likelihood_field(grid)
    return grid, field, poses


def test_simulate_scan_matches_analytic(room, room_map):
    grid, _, _ = room_map
    pose = jnp.asarray([0.3, -0.2, 0.5])
    sim = np.asarray(simulate_scan(grid, MODEL, pose))
    true = room(MODEL, (0.3, -0.2, 0.5), BOX)
    ok = true < 20.0
    err = np.abs(sim - true)[ok]
    # within a few cells for most beams
    assert np.median(err) < 0.15
    assert np.quantile(err, 0.9) < 0.5


def test_field_tracking_converges(room, room_map):
    grid, field, _ = room_map
    key = jax.random.PRNGKey(0)
    true_pose = np.array([0.5, 0.2, 0.3], dtype=np.float32)
    ranges = jnp.asarray(room(MODEL, tuple(true_pose), BOX))
    valid = ranges < MODEL.max_range

    # Start biased half a meter off.
    state = pf.init_gaussian(key, jnp.asarray(true_pose + [0.4, -0.3, 0.2]), 512)
    for k in range(10):
        key, k1, k2 = jax.random.split(key, 3)
        state = pf.predict(state, jnp.zeros(3), k1, sigma_xy=0.06, sigma_theta=0.04)
        state = pf.update_field(state, field, grid, MODEL, ranges, valid)
        state = pf.maybe_resample(state, k2)
    est = np.asarray(pf.estimate(state, top_k=64))
    assert np.linalg.norm(est[:2] - true_pose[:2]) < 0.3
    assert abs(se2.normalize_angle(jnp.asarray(est[2] - true_pose[2]))) < 0.15


def test_track_field_tick_tracks_a_moving_robot(room, room_map):
    """The jitted one-program tick (predict + field update + resample +
    estimate) follows a robot across the room from its odometry steps."""
    grid, field, _ = room_map
    tick = jax.jit(lambda st, rel, r, v, k: pf.track_field(
        st, rel, r, v, k, field, grid, MODEL))
    path = np.array([[0.0, 0.0, 0.1 * t] for t in range(6)], np.float32)
    path[:, 0] = np.linspace(0.0, 1.0, 6)
    key = jax.random.PRNGKey(1)
    state = pf.init_gaussian(key, jnp.asarray(path[0]), 512)
    for t in range(1, len(path)):
        key, k = jax.random.split(key)
        rel = se2.relative(jnp.asarray(path[t - 1]), jnp.asarray(path[t]))
        r = jnp.asarray(room(MODEL, tuple(path[t]), BOX))
        state, est = tick(state, rel, r, r < MODEL.max_range, k)
        assert np.linalg.norm(np.asarray(est)[:2] - path[t, :2]) < 0.2
    assert state.poses.shape == (512, 3)


def test_icp_update_weights_and_nudges(room, room_map):
    grid, _, _ = room_map
    from laser_slam_tpu.mapping.occupancy import occupied_points

    map_pts, map_ok = occupied_points(grid, 2048)
    true_pose = np.array([0.2, -0.1, -0.4], dtype=np.float32)
    ranges = jnp.asarray(room(MODEL, tuple(true_pose), BOX))
    scan = preprocess(ranges[None], MODEL)
    spts, sok = scan_to_points(MODEL, jax.tree.map(lambda x: x[0], scan))

    key = jax.random.PRNGKey(1)
    state = pf.init_gaussian(key, jnp.asarray(true_pose), 64, sigma_xy=0.15)
    state = pf.update_icp(state, map_pts, map_ok, MODEL, spts, sok)
    est = np.asarray(pf.estimate(state))
    assert np.linalg.norm(est[:2] - true_pose[:2]) < 0.15


def test_global_relocalization(room, room_map):
    grid, field, _ = room_map
    true_pose = np.array([1.2, 0.8, 2.0], dtype=np.float32)
    ranges = jnp.asarray(room(MODEL, tuple(true_pose), BOX))
    valid = ranges < MODEL.max_range
    state = pf.global_relocalize(
        jax.random.PRNGKey(2), grid, field, MODEL, ranges, valid,
        n_samples=8000, n_keep=256,
    )
    # Refine a couple of steps.
    key = jax.random.PRNGKey(3)
    for _ in range(4):
        key, k1, k2 = jax.random.split(key, 3)
        state = pf.predict(state, jnp.zeros(3), k1, sigma_xy=0.1, sigma_theta=0.08)
        state = pf.update_field(state, field, grid, MODEL, ranges, valid)
        state = pf.maybe_resample(state, k2)
    # The square-ish room has rotational ambiguity and the cloud may stay
    # multimodal — judge the *best particle* by scan consistency.
    best = np.asarray(state.poses[int(np.argmax(np.asarray(state.log_w)))])
    sim = np.asarray(simulate_scan(grid, MODEL, jnp.asarray(best)))
    true = np.asarray(ranges)
    ok = true < 20.0
    assert np.median(np.abs(sim - true)[ok]) < 0.35


def test_systematic_resample_preserves_mean():
    key = jax.random.PRNGKey(4)
    poses = jax.random.normal(key, (256, 3))
    w = jnp.concatenate([jnp.full(128, 0.9 / 128), jnp.full(128, 0.1 / 128)])
    state = pf.ParticleState(poses=poses, log_w=jnp.log(w))
    out = pf.systematic_resample(state, jax.random.PRNGKey(5))
    # Heavily-weighted half should dominate the resampled cloud.
    frac_first = np.mean(np.isin(
        np.asarray(out.poses[:, 0]), np.asarray(poses[:128, 0])
    ))
    assert frac_first > 0.7
    assert np.allclose(np.exp(np.asarray(out.log_w)), 1.0 / 256)


def test_neff():
    state = pf.ParticleState(
        poses=jnp.zeros((4, 3)), log_w=jnp.log(jnp.asarray([0.97, 0.01, 0.01, 0.01]))
    )
    assert float(pf.neff(state)) < 1.1


def test_kld_sample_size_scales_with_spread():
    """A concentrated cloud needs few particles; a dispersed one needs
    many (Fox's KLD bound, MRPT adaptive-sampling parity)."""
    import jax
    import jax.numpy as jnp
    from laser_slam_tpu.localization.particle_filter import (
        ParticleState,
        kld_resample,
        kld_sample_size,
        _normalize,
    )

    p = 2048
    key = jax.random.PRNGKey(0)
    tight = ParticleState(
        poses=jax.random.normal(key, (p, 3)) * 0.05,
        log_w=_normalize(jnp.zeros(p)),
    )
    wide = ParticleState(
        poses=jax.random.uniform(key, (p, 3), minval=-20.0, maxval=20.0),
        log_w=_normalize(jnp.zeros(p)),
    )
    n_tight = int(kld_sample_size(tight))
    n_wide = int(kld_sample_size(wide))
    assert n_tight < n_wide
    assert n_wide <= p

    out = jax.jit(kld_resample)(wide, jax.random.PRNGKey(1))
    live = int(jnp.sum(jnp.isfinite(out.log_w)))
    assert live == n_wide or abs(live - n_wide) <= 1
