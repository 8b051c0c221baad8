"""Beta-grid style polar descriptors and symmetric-χ² distance.

JAX equivalent of FLIRT's beta-grid descriptor generator and
histogram distance (``CFliterNode::InitFliter``
src/mapGraph/FlirterNode.cpp:563-580: BetaGridGenerator over
``minRho=0.02, maxRho=0.5`` with the *symmetric χ²* distance).

A descriptor is a polar occupancy histogram of the scan points around
an interest point: radial bins × angular bins, weighted by a Gaussian
of the point's distance to the bin center, normalized to sum 1. The
whole scan's ``K`` descriptors are one ``[K, N]``-per-bin reduction —
batched, fixed-shape, no per-feature loops.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core.scan import LaserModel, Scan
from .detector import FeatureSet

Array = jnp.ndarray

# FLIRT beta-grid extent (FlirterNode.cpp:565).
MIN_RHO = 0.02
MAX_RHO = 0.5
N_RADIAL = 4
N_ANGULAR = 8
DESCRIPTOR_DIM = N_RADIAL * N_ANGULAR


def describe_features(
    model: LaserModel, scan: Scan, feats: FeatureSet
) -> Array:
    """``[K, D]`` normalized polar histograms around each feature.

    Rotation alignment: angular bins are measured relative to the
    feature's bearing from the sensor, which makes the descriptor
    invariant to the *sensor* pose (the same surface patch seen from two
    poses produces comparable histograms, the property FLIRT gets from
    orienting the beta grid along the beam).
    """
    pts = scan.points(model)                              # [N, 2]
    good = ~scan.bad                                      # [N]

    d = pts[None, :, :] - feats.xy[:, None, :]            # [K, N, 2]
    rho = jnp.linalg.norm(d, axis=-1)                     # [K, N]
    # Angle of the offset relative to the feature's viewing direction.
    view = jnp.arctan2(feats.xy[:, 1], feats.xy[:, 0])    # [K]
    ang = jnp.arctan2(d[..., 1], d[..., 0]) - view[:, None]
    ang = jnp.mod(ang, 2.0 * jnp.pi)                      # [K, N] in [0, 2pi)

    in_range = (rho >= MIN_RHO) & (rho <= MAX_RHO) & good[None, :]

    r_edges = jnp.linspace(MIN_RHO, MAX_RHO, N_RADIAL + 1)
    r_bin = jnp.clip(
        jnp.searchsorted(r_edges, rho, side="right") - 1, 0, N_RADIAL - 1
    )
    a_bin = jnp.clip(
        (ang / (2.0 * jnp.pi / N_ANGULAR)).astype(jnp.int32), 0, N_ANGULAR - 1
    )
    bin_idx = r_bin * N_ANGULAR + a_bin                   # [K, N]

    onehot = (
        bin_idx[..., None] == jnp.arange(DESCRIPTOR_DIM)[None, None, :]
    ) & in_range[..., None]
    hist = jnp.sum(onehot.astype(pts.dtype), axis=1)      # [K, D]
    total = jnp.sum(hist, axis=-1, keepdims=True)
    hist = hist / jnp.maximum(total, 1.0)
    return jnp.where(feats.valid[:, None], hist, 0.0)


def descriptor_distance(da: Array, db: Array) -> Array:
    """Symmetric χ² distance between all descriptor pairs.

    ``da [Ka, D]``, ``db [Kb, D]`` → ``[Ka, Kb]``; FLIRT's default
    histogram distance (FlirterNode.cpp:570-580).
    """
    a = da[:, None, :]
    b = db[None, :, :]
    num = (a - b) ** 2
    den = a + b
    return 0.5 * jnp.sum(jnp.where(den > 1e-12, num / jnp.maximum(den, 1e-12), 0.0), axis=-1)
