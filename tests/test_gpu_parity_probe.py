"""tools/exp/gpu_parity_probe.py at tiny size, CPU against CPU.

The probe needs a card for its numbers; here each part runs with the
CPU on both sides, which checks its plumbing and that identical
backends show no divergence at all.
"""

import dataclasses

import jax
import numpy as np
import pytest

import chip_smoke
from laser_slam_tpu.io.carmen import read_carmen
from laser_slam_tpu.runtime.slam import SlamConfig
from tools.exp import gpu_parity_probe as probe

TINY = dataclasses.replace(
    SlamConfig(), submap_points=64, wide_points=128, max_loops=8,
    verify_chunk=4, n_theta=8, n_peaks=2, search_xy=1.0,
)


@pytest.fixture(scope="module")
def log(tmp_path_factory):
    return read_carmen(chip_smoke.phase_input(
        str(tmp_path_factory.mktemp("probe")), 0, 40))


def test_odometry_modes_agree_on_one_backend(log):
    cpu = jax.devices("cpu")[0]
    out = probe.odometry_modes(log, 24, cpu, cpu)
    for mode in ("shipped", "highest", "pass1"):
        assert out[mode]["max_mm"] == 0.0
        assert out[mode]["diverged_steps"] == []


def test_pass1_matches_the_shipped_odometry_off_the_deep_steps(log):
    """``pass1`` is the first pass of ``odometry_keyframe``: every step
    the deep re-match leaves alone moves the same."""
    import jax.numpy as jnp

    from laser_slam_tpu.core import se2
    from laser_slam_tpu.ops.odometry import odometry_keyframe
    from laser_slam_tpu.ops.preprocess import preprocess

    scans = preprocess(jnp.asarray(log.ranges[:24]), log.model)
    poses, need = probe.pass1(log.model, scans)
    full = odometry_keyframe(log.model, scans)
    a = se2.np_relative(np.asarray(poses[:-1]), np.asarray(poses[1:]))
    b = se2.np_relative(np.asarray(full.poses[:-1]),
                        np.asarray(full.poses[1:]))
    keep = ~np.asarray(need)
    np.testing.assert_allclose(a[keep], b[keep], atol=1e-5)


def test_precision_modes_tiny(log):
    cpu = jax.devices("cpu")[0]
    out = probe.precision_modes(log, log.gt_pose, TINY, cpu, cpu, seeds=(0,),
                                repeats=1)
    for mode in ("shipped", "highest"):
        rec = out[f"seed0_{mode}"]
        assert rec["failed"] == []
        assert any("accept flips 0, tentative flips 0" in line
                   for line in rec["lines"])


def test_trace_reduction_on_a_host_trace(log, tmp_path):
    out = probe.trace_pass1(log, str(tmp_path), window=12,
                            plane_prefix="/host:CPU")
    assert out["hlo_while"] >= 1 and out["hlo_conditional"] >= 1
    assert out["lines"]
    for line in out["lines"].values():
        assert 0.0 <= line["busy_share"] <= 1.0
        assert line["busy_ms"] <= line["span_ms"] + 1e-9


def test_psm_pairs_agree_on_one_backend(log):
    cpu = jax.devices("cpu")[0]
    out = probe.psm_pairs(log, 16, cpu, cpu)
    assert out["pairs"] == 15 and out["diverged_pairs"] == 0
    assert out["preprocess_ranges_maxdiff"] == 0.0
