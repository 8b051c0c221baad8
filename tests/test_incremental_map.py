"""Incremental mapping service: O(1) per-scan updates, rebase gate,
egocentric crops (MapService parity, threadGlobal1.cpp:130-138)."""

import numpy as np
import jax.numpy as jnp
import pytest

from laser_slam_tpu.core.scan import LMS211
from laser_slam_tpu.mapping.incremental import IncrementalMapper
from laser_slam_tpu.ops.preprocess import preprocess

from tests.conftest import box_room_ranges


@pytest.fixture(scope="module")
def model():
    return LMS211


def make_scan(model, pose):
    r = box_room_ranges(model, pose)
    return preprocess(jnp.asarray(r)[None, :], model), r


def test_add_accumulates_and_matches_batch(model):
    import jax

    m = IncrementalMapper(model, resolution=0.1, half_size=15.0)
    poses = np.array(
        [[0.0, 0.0, 0.0], [0.5, 0.0, 0.1], [1.0, 0.2, 0.2]], np.float32
    )
    scans = []
    for p in poses:
        s, _ = make_scan(model, p)
        s1 = jax.tree.map(lambda x: x[0], s)
        scans.append(s1)
        m.add(s1, p)

    # identical to a one-shot batch integration over the same grid
    from laser_slam_tpu.mapping.occupancy import empty_grid, integrate_scans

    batch = jax.tree.map(lambda *xs: jnp.stack(xs), *scans)
    ref = integrate_scans(
        empty_grid(m.spec), model, batch, jnp.asarray(poses)
    )
    inc = np.asarray(m.grid.log_odds)
    bat = np.asarray(ref.log_odds)
    # Bit-exactness is not guaranteed: per-scan clipping vs end clipping
    # differs on saturated cells, and XLA fuses the two shapes
    # differently so endpoint coordinates exactly on a cell boundary can
    # floor to the neighboring cell. Require near-identity: <0.1% of
    # cells differ, none by more than a single update increment.
    diff = np.abs(inc - bat)
    assert (diff > 1e-4).mean() < 1e-3
    assert diff.max() <= 1.0
    assert np.asarray(m.grid.occupied).sum() > 50


def test_rebase_gate_and_rebuild(model):
    import jax

    m = IncrementalMapper(model, resolution=0.1, half_size=15.0)
    poses = np.array([[0.0, 0.0, 0.0], [0.5, 0.0, 0.0]], np.float32)
    for p in poses:
        s, _ = make_scan(model, p)
        m.add(jax.tree.map(lambda x: x[0], s), p)

    # tiny pose change → no rebase needed
    wiggle = poses + np.array([0.01, 0.0, 0.001], np.float32)
    assert not m.needs_rebase(wiggle)
    # loop-closure-sized change → rebase
    moved = poses + np.array([1.0, 0.0, 0.0], np.float32)
    assert m.needs_rebase(moved)
    before = np.asarray(m.grid.occupied).copy()
    m.rebase(moved)
    after = np.asarray(m.grid.occupied)
    assert after.sum() > 0
    assert (before != after).any()
    assert not m.needs_rebase(moved)


def test_local_crop_window(model):
    import jax

    m = IncrementalMapper(model, resolution=0.1, half_size=15.0)
    s, _ = make_scan(model, np.zeros(3, np.float32))
    m.add(jax.tree.map(lambda x: x[0], s), np.zeros(3, np.float32))
    win, wspec = m.local_crop(np.zeros(3, np.float32), half_cells=32)
    assert win.shape == (64, 64)
    assert wspec.width == 64 and wspec.resolution == m.resolution
    # window is centered: origin offset ≈ pose - half window
    assert abs(wspec.origin_x - (-3.2)) < 0.2
    # crop equals the corresponding slice of the full grid
    full = np.asarray(m.grid.log_odds)
    y0 = int((wspec.origin_y - m.spec.origin_y) / m.resolution)
    x0 = int((wspec.origin_x - m.spec.origin_x) / m.resolution)
    np.testing.assert_allclose(
        np.asarray(win), full[y0:y0 + 64, x0:x0 + 64]
    )


def test_online_slam_uses_incremental_grid(model, monkeypatch):
    from laser_slam_tpu.runtime.online import OnlineSlam

    slam = OnlineSlam(
        model, incremental_map=True, map_resolution=0.1, map_half_size=15.0
    )
    for i in range(5):
        pose = np.array([0.1 * i, 0.0, 0.0], np.float32)
        slam.feed_scan(box_room_ranges(model, pose))
    grid = slam.render_map(0.1)
    assert grid is slam._imap.grid  # live grid, no rebuild
    win, _ = slam.local_map(half_cells=16)
    assert win.shape == (32, 32)
    assert slam.last_scan is not None
