"""The seeded synthetic CARMEN log (tools/synth_log.py)."""

import math

import numpy as np
import pytest

from laser_slam_tpu.core.scan import LMS211
from laser_slam_tpu.io.carmen import read_carmen
from tools import synth_log


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    d = tmp_path_factory.mktemp("synth")
    return {
        name: synth_log.make_log(str(d / f"{name}.log"), n, seed)
        for name, n, seed in [("a", 12, 0), ("a_again", 12, 0),
                              ("short", 5, 0), ("b", 12, 1)]
    }


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_deterministic_from_seed(logs):
    assert _bytes(logs["a"]) == _bytes(logs["a_again"])
    assert _bytes(logs["a"]) != _bytes(logs["b"])


def test_short_log_is_prefix_of_long(logs):
    assert _bytes(logs["a"]).startswith(_bytes(logs["short"]))


def test_round_trips_through_read_carmen(logs):
    log = read_carmen(logs["a"])
    assert log.ranges.shape == (12, LMS211.n_beams)
    assert log.model.name == "LMS211"
    assert log.model.n_beams == LMS211.n_beams
    assert math.isclose(log.model.fov_deg, LMS211.fov_deg)
    assert math.isclose(log.model.fi_min, -math.pi / 2, abs_tol=1e-9)
    assert log.model.max_range == synth_log.MAX_RANGE
    gt = synth_log.load_trajectory()[:12]
    np.testing.assert_allclose(log.gt_pose, gt, atol=1e-5)
    assert np.all(np.diff(log.timestamps) > 0)
    # Dropouts read 0 and come back past max range (tagged invalid).
    assert np.any(log.ranges > log.model.max_range)
    ok = log.ranges <= log.model.max_range
    assert ok.mean() > 0.98
    assert np.all(log.ranges[ok] > 0.0)


def test_cast_rays_match_an_analytic_box():
    """Ray casting in a solid-walled 8 x 6 m box agrees with the box's
    analytic ranges to within one bisection step."""
    res = 0.05
    solid = np.ones((160, 200), bool)          # 10 x 8 m raster
    solid[20:140, 20:180] = False             # free box x in [1, 9), y in [1, 7)
    world = synth_log.World(solid, np.zeros(2), res)
    origin = np.array([4.0, 3.0])
    ang = np.linspace(-np.pi, np.pi, 73)[:-1]
    r = synth_log.cast_rays(world, np.tile(origin, (len(ang), 1)), ang)
    c, s = np.cos(ang), np.sin(ang)
    with np.errstate(divide="ignore"):
        tx = np.where(c > 0, (9.0 - origin[0]) / c, (1.0 - origin[0]) / c)
        ty = np.where(s > 0, (7.0 - origin[1]) / s, (1.0 - origin[1]) / s)
    exact = np.minimum(np.abs(tx), np.abs(ty))
    np.testing.assert_allclose(r, exact, atol=2e-3)


def test_timestamps_carry_frame_drop_gaps():
    traj = synth_log.load_trajectory()
    ts = synth_log.timestamps(traj, np.random.default_rng([0, 1]))
    dt = np.diff(ts)
    assert ts.shape == (traj.shape[0],)
    assert int((dt > 8.0 * np.median(dt)).sum()) == synth_log.N_GAPS
