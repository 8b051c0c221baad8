"""Matcher recovery tests on a synthetic room fixture.

Generate two scans of the same rectangular room from slightly different
poses; the matcher must recover the relative pose. This is the role the
reference's embedded two-scan fixture plays (zhicp/test.cpp:44-60).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from laser_slam_tpu.core import se2
from laser_slam_tpu.core.scan import LMS211
from laser_slam_tpu.ops import preprocess as pp
from laser_slam_tpu.ops.icp import match_icp
from laser_slam_tpu.ops.project import scan_project
from laser_slam_tpu.ops.psm import error_index, match_psm

MODEL = LMS211


def make_pair(room, pose_a, pose_b, seed=0):
    rng = np.random.default_rng(seed)
    ra = room(MODEL, pose_a) + rng.normal(0, 0.003, MODEL.n_beams).astype(np.float32)
    rb = room(MODEL, pose_b) + rng.normal(0, 0.003, MODEL.n_beams).astype(np.float32)
    sa = pp.preprocess(jnp.asarray(ra), MODEL)
    sb = pp.preprocess(jnp.asarray(rb), MODEL)
    return sa, sb


def test_projection_self_consistency(room):
    r = room(MODEL, (0.0, 0.0, 0.0))
    scan = pp.preprocess(jnp.asarray(r), MODEL)
    proj = scan_project(MODEL, scan, jnp.zeros(3))
    ok = ~np.asarray(proj.bad) & ~np.asarray(scan.bad)
    # Interior bins should reproduce the scan's own ranges closely.
    assert ok.sum() > 100
    err = np.abs(np.asarray(proj.new_r) - np.asarray(scan.ranges))[ok]
    assert np.quantile(err, 0.9) < 0.05


@pytest.mark.parametrize(
    "true_rel",
    [
        (0.05, 0.02, 0.03),
        (-0.10, 0.05, -0.05),
        (0.0, 0.0, 0.12),
    ],
)
def test_psm_recovers_pose(room, true_rel):
    pose_a = (0.4, -0.3, 0.2)
    pose_b = tuple(np.asarray(se2.compose(jnp.asarray(pose_a), jnp.asarray(true_rel))))
    sa, sb = make_pair(room, pose_a, pose_b)
    res = match_psm(MODEL, sa, sb)
    assert not bool(res.fail)
    est = np.asarray(res.pose)
    assert np.allclose(est[:2], true_rel[:2], atol=0.03)
    assert abs(est[2] - true_rel[2]) < 0.02


@pytest.mark.parametrize(
    "true_rel",
    [
        (0.05, 0.02, 0.03),
        (-0.10, 0.05, -0.05),
    ],
)
def test_icp_recovers_pose(room, true_rel):
    pose_a = (0.4, -0.3, 0.2)
    pose_b = tuple(np.asarray(se2.compose(jnp.asarray(pose_a), jnp.asarray(true_rel))))
    sa, sb = make_pair(room, pose_a, pose_b)
    res = match_icp(MODEL, sa, sb)
    assert not bool(res.fail)
    est = np.asarray(res.pose)
    assert np.allclose(est[:2], true_rel[:2], atol=0.03)
    assert abs(est[2] - true_rel[2]) < 0.02


def test_error_index_small_after_match(room):
    true_rel = (0.06, -0.03, 0.04)
    pose_a = (0.0, 0.0, 0.0)
    pose_b = tuple(np.asarray(se2.compose(jnp.zeros(3), jnp.asarray(true_rel))))
    sa, sb = make_pair(room, pose_a, pose_b)
    res = match_psm(MODEL, sa, sb)
    ex, ey, n = error_index(MODEL, sa, sb, res.pose)
    err = float(jnp.sqrt(ex + ey))
    assert int(n) > 50
    assert err < 0.05  # same 5 cm gate as runlogImproved (ZHPolar_Match.cpp:800)
    # A wrong pose must score worse.
    ex2, ey2, _ = error_index(MODEL, sa, sb, jnp.asarray([0.5, 0.5, 0.3]))
    assert float(jnp.sqrt(ex2 + ey2)) > err


def test_matchers_batch_with_vmap(room):
    rels = np.array([[0.05, 0.02, 0.03], [-0.08, 0.04, -0.04]], dtype=np.float32)
    scans_a, scans_b = [], []
    for k, rel in enumerate(rels):
        pose_a = (0.1, 0.0, 0.05)
        pose_b = tuple(np.asarray(se2.compose(jnp.asarray(pose_a), jnp.asarray(rel))))
        sa, sb = make_pair(room, pose_a, pose_b, seed=k)
        scans_a.append(sa)
        scans_b.append(sb)
    batch_a = jax.tree.map(lambda *xs: jnp.stack(xs), *scans_a)
    batch_b = jax.tree.map(lambda *xs: jnp.stack(xs), *scans_b)
    res = jax.vmap(lambda a, b: match_psm(MODEL, a, b))(batch_a, batch_b)
    assert res.pose.shape == (2, 3)
    assert not np.any(np.asarray(res.fail))
    assert np.allclose(np.asarray(res.pose), rels, atol=0.04)


@pytest.mark.parametrize(
    "rels, init",
    [
        ([(0.05, 0.02, 0.03), (-0.10, 0.05, -0.05), (0.0, 0.0, 0.12)], None),
        ([(0.3, -0.2, 0.3)], [(0.28, -0.18, 0.28)]),
    ],
    ids=["zero_init", "with_init"],
)
def test_vmapped_banded_psm_recovers_offsets(room, rels, init):
    """The batched PSM mode (``vmap`` of the banded matcher, what XLA
    compiles for a batch of independent pairs) recovers known offsets on
    box-room pairs, and agrees with the dense projection."""
    pose_a = (0.4, -0.3, 0.2)
    pairs = [
        make_pair(room, pose_a,
                  tuple(np.asarray(se2.compose(jnp.asarray(pose_a),
                                               jnp.asarray(rel)))), seed=k)
        for k, rel in enumerate(rels)
    ]
    batch_a = jax.tree.map(lambda *xs: jnp.stack(xs), *[p[0] for p in pairs])
    batch_b = jax.tree.map(lambda *xs: jnp.stack(xs), *[p[1] for p in pairs])
    init = jnp.zeros((len(rels), 3)) if init is None else jnp.asarray(init)

    def batched(banded):
        return jax.jit(jax.vmap(
            lambda a, b, p: match_psm(MODEL, a, b, p, banded=banded)
        ))(batch_a, batch_b, init)

    res = batched(True)
    assert not np.any(np.asarray(res.fail))
    est = np.asarray(res.pose)
    assert np.allclose(est[:, :2], np.asarray(rels)[:, :2], atol=0.03)
    assert np.all(np.abs(est[:, 2] - np.asarray(rels)[:, 2]) < 0.02)
    assert np.allclose(est, np.asarray(batched(False).pose), atol=2e-3)
