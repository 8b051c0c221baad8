"""chip_smoke.py: its device check and its phases at tiny size.

On the CPU mesh the phases run at a few dozen scans with a shrunk loop
verifier; ``test_parity_at_full_width`` is the full-size content and
needs a card (``LASER_SLAM_GPU_LANE=1 python -m pytest -m gpu``), where
``python chip_smoke.py`` runs it as well.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke
from laser_slam_tpu.io.carmen import read_carmen
from laser_slam_tpu.runtime.slam import SlamConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Default SlamConfig shrunk for the CPU: same code paths, tiny widths.
TINY = dataclasses.replace(
    SlamConfig(), submap_points=64, wide_points=128, max_loops=8,
    verify_chunk=4, n_theta=8, n_peaks=2, search_xy=1.0,
)


def _cpu_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    return env


def test_smoke_exits_nonzero_without_a_gpu():
    p = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, env=_cpu_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
    assert "needs a GPU" in p.stderr


def test_require_gpu_refuses_the_cpu():
    with pytest.raises(SystemExit, match="needs a GPU"):
        chip_smoke.require_gpu()


@pytest.fixture(scope="module")
def tiny_log(tmp_path_factory):
    path = chip_smoke.phase_input(str(tmp_path_factory.mktemp("smoke")), 0, 30)
    return path, read_carmen(path)


def test_phase_input_writes_the_synthetic_log(tiny_log):
    path, log = tiny_log
    assert os.path.basename(path) == "synth_intel_s0.log"
    assert log.ranges.shape == (30, 181)


def test_phase_slam_runs_the_cli_and_rejects_a_loopless_run(tiny_log, capsys):
    """30 scans hold no revisit, so the loop check must fail -- after the
    CLI has run and printed its stage walls."""
    path, _ = tiny_log
    with pytest.raises(RuntimeError, match="at least one loop"):
        chip_smoke.phase_slam(path, ["--max-loops", "4", "--rounds", "1"],
                              runs=("cold",))
    out = capsys.readouterr().out
    assert "[slam] preprocess:" in out and "[odo] pass1 scan:" in out
    assert "[slam] cold wall:" in out and "ATE odometry=" in out
    assert "LASER_SLAM_TIMING" not in os.environ


def test_phase_served_tiny(tiny_log, capsys):
    _, log = tiny_log
    traj = chip_smoke.phase_served(log, 20, TINY)
    assert traj.shape == (20, 3)
    assert "p50=" in capsys.readouterr().out


def test_phase_localization_tiny(tiny_log, capsys):
    _, log = tiny_log
    chip_smoke.phase_localization(log, log.gt_pose, n_particles=64, ticks=4,
                                  resolution=0.2)
    assert "ticks/s" in capsys.readouterr().out


def test_phase_parity_tiny(tiny_log, capsys):
    """CPU against CPU here: exercises every comparison and tolerance."""
    _, log = tiny_log
    chip_smoke.phase_parity(log, log.gt_pose, jax.devices()[0], n_odo=24,
                            cfg=TINY)
    out = capsys.readouterr().out
    assert "accept flips 0" in out and "flag flips 0" in out
    # Step 19 goes to the deep re-match, so its search is compared too.
    assert "deep-search argmax flips 0 of 1 re-matched steps" in out


def test_score_volume_reference_matches_the_conv(tiny_log):
    """The float64 NumPy score volume is the gather form of the conv."""
    import jax.numpy as jnp

    from laser_slam_tpu.ops.correlative import (
        build_likelihood_grid_points, correlative_score_volume,
    )

    rng = np.random.default_rng(0)
    ref = rng.uniform(-4, 4, (96, 2)).astype(np.float32)
    cur = ref[:48] + np.float32(0.05)
    ok = np.ones(48, bool)
    grid = np.asarray(build_likelihood_grid_points(
        jnp.asarray(ref), jnp.ones(96, bool), res=0.3, half_extent=12.8))
    thetas = np.linspace(-np.pi, np.pi, 8, dtype=np.float32)
    base = np.zeros(2, np.float32)
    vol = np.asarray(correlative_score_volume(
        jnp.asarray(grid), jnp.asarray(cur), jnp.asarray(ok),
        jnp.asarray(thetas), 4, 0.3, 12.8, jnp.asarray(base)))
    v64, slack, _ = chip_smoke._score_volume_f64(grid, cur, ok, thetas, 4,
                                                 0.3, 12.8, base)
    assert np.all(np.abs(vol - v64) <= 1e-6 + slack)
    # The slack is zero away from cell edges, so it cannot hide a
    # shifted point: moving one point by a cell must break the bound.
    assert np.median(slack) == 0.0
    moved = cur.copy()
    moved[0] += np.float32(0.3)
    vol2 = np.asarray(correlative_score_volume(
        jnp.asarray(grid), jnp.asarray(moved), jnp.asarray(ok),
        jnp.asarray(thetas), 4, 0.3, 12.8, jnp.asarray(base)))
    assert not np.all(np.abs(vol2 - v64) <= 1e-6 + slack)


@pytest.mark.gpu
def test_parity_at_full_width(gpu_device, tmp_path):
    """Odometry, one default-width verify chunk and one score volume on
    the card against JAX's CPU backend and float64 NumPy."""
    log = read_carmen(chip_smoke.phase_input(str(tmp_path), 0))
    chip_smoke.phase_parity(log, log.gt_pose, gpu_device)


@pytest.mark.parametrize("env_dir", [None, "custom"], ids=["unset", "set"])
def test_compile_cache_directory(tmp_path, env_dir):
    """With JAX_COMPILATION_CACHE_DIR set, that directory is the cache and
    no other is set; unset, the cache is the fixed checkout path."""
    env = _cpu_env()
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    want = os.path.join(REPO, ".jax_cache")
    if env_dir is not None:
        want = env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    code = ("import laser_slam_tpu, jax; "
            "print(jax.config.jax_compilation_cache_dir)")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == want
