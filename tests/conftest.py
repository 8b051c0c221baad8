"""Test configuration: run everything on a virtual 8-device CPU mesh.

Multi-device sharding is validated on host-platform virtual devices (the
standard JAX pattern). Must run before the first ``import jax`` anywhere
in the test process.

The GPU lane (``LASER_SLAM_GPU_LANE=1 python -m pytest -m gpu`` on a
machine with a card) opts OUT of the CPU mesh, for the tests marked
``gpu`` and the full-size accuracy lane.
"""

import os

_GPU_LANE = os.environ.get("LASER_SLAM_GPU_LANE") == "1"

if not _GPU_LANE:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

# If jax was imported before this file ran, its env vars are latched;
# force the platform via the config API as well.
import jax

if not _GPU_LANE:
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


REFERENCE_DATA = "/root/reference/data"


@pytest.fixture
def gpu_device():
    """The first GPU, for tests marked ``gpu``; skips where there is none."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a GPU: LASER_SLAM_GPU_LANE=1 python -m pytest -m gpu")
    return gpus[0]


@pytest.fixture(scope="session")
def intel_log_path():
    path = os.path.join(REFERENCE_DATA, "intel-lab.log")
    if not os.path.exists(path):
        pytest.skip("reference intel-lab.log not available")
    return path


@pytest.fixture(scope="session")
def fr079_log_path():
    path = os.path.join(REFERENCE_DATA, "fr079.log")
    if not os.path.exists(path):
        pytest.skip("reference fr079.log not available")
    return path


@pytest.fixture(scope="session")
def mit_log_path():
    path = os.path.join(REFERENCE_DATA, "mit-cscail.log")
    if not os.path.exists(path):
        pytest.skip("reference mit-cscail.log not available")
    return path


def box_room_ranges(model, pose, box=(-3.0, 5.0, -4.0, 4.0)):
    """Analytic ranges of a rectangular room seen from ``pose``.

    A deterministic synthetic fixture (the reference's closest analog is
    the two embedded scans in zhicp/test.cpp:44-60). Returns ``[N]``
    float32 ranges in meters.
    """
    xmin, xmax, ymin, ymax = box
    x0, y0, th = pose
    n = model.n_beams
    ang = th + (np.arange(n) * model.dfi + model.fi_min)
    dx, dy = np.cos(ang), np.sin(ang)
    ts = np.full((4, n), np.inf)
    with np.errstate(divide="ignore", invalid="ignore"):
        for k, (t_num, t_den, lo, hi, coord0, d_other) in enumerate(
            [
                (xmin - x0, dx, ymin, ymax, y0, dy),
                (xmax - x0, dx, ymin, ymax, y0, dy),
                (ymin - y0, dy, xmin, xmax, x0, dx),
                (ymax - y0, dy, xmin, xmax, x0, dx),
            ]
        ):
            t = t_num / t_den
            other = coord0 + t * d_other
            ok = (t > 0) & (other >= lo) & (other <= hi)
            ts[k] = np.where(ok, t, np.inf)
    r = ts.min(axis=0)
    r = np.where(np.isfinite(r), r, model.max_range + 1.0)
    return r.astype(np.float32)


@pytest.fixture(scope="session")
def room():
    return box_room_ranges
