"""Batched ray-cast scan simulation against an occupancy grid.

Batched JAX replacement for the reference's DDA scan simulator
(``CVPmap::laserScanSimulator`` / ``simulateScanRay``,
src/localization/VPmap.cpp:180-300): instead of a per-beam while-loop
walking grid cells, every beam samples the grid at a fixed ladder of
ranges and finds the first occupied sample with one ``argmax`` — a dense
``[B, N, S]`` gather with no data-dependent control flow, batched over
poses (particles) via ``vmap``.

Sample spacing equals the grid resolution, so accuracy matches a DDA
walk to within one cell.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.scan import LaserModel
from ..mapping.occupancy import OccupancyGrid

Array = jnp.ndarray


def simulate_scan(
    grid: OccupancyGrid,
    model: LaserModel,
    pose: Array,
    max_range: float | None = None,
    occ_threshold: float = 0.5,
) -> Array:
    """Simulate ``[N]`` ranges from ``pose [3]`` against the grid.

    ``vmap`` over poses for particle clouds; the reference evaluates this
    serially per particle (localization.cpp:328-339).
    """
    spec = grid.spec
    if max_range is None:
        max_range = model.max_range
    n_samples = int(max_range / spec.resolution)

    fi = model.bearings(pose.dtype)
    ang = pose[2] + fi                                       # [N]
    rs = (jnp.arange(n_samples, dtype=pose.dtype) + 1.0) * spec.resolution
    x = pose[0] + rs[None, :] * jnp.cos(ang)[:, None]        # [N, S]
    y = pose[1] + rs[None, :] * jnp.sin(ang)[:, None]

    ix = jnp.floor((x - spec.origin_x) / spec.resolution).astype(jnp.int32)
    iy = jnp.floor((y - spec.origin_y) / spec.resolution).astype(jnp.int32)
    inb = (ix >= 0) & (ix < spec.width) & (iy >= 0) & (iy < spec.height)
    flat = jnp.where(inb, iy * spec.width + ix, 0)
    occ = jnp.take(grid.probability.reshape(-1), flat) > occ_threshold
    occ = occ & inb

    hit_any = jnp.any(occ, axis=1)
    first = jnp.argmax(occ, axis=1)                          # [N]
    r_hit = (first.astype(pose.dtype) + 1.0) * spec.resolution
    return jnp.where(hit_any, r_hit, jnp.asarray(max_range, pose.dtype))


def beam_likelihood(
    grid: OccupancyGrid,
    model: LaserModel,
    pose: Array,
    ranges: Array,
    valid: Array,
    sigma: float = 0.5,
    max_range: float | None = None,
) -> Array:
    """Gaussian beam-likelihood of an observed scan from ``pose``:
    ``mean_n exp(-(r_obs - r_sim)² / 2σ²)`` over valid beams — the
    reference's ``obsLikelyhood3`` model (VPmap.cpp:336-452, residual
    ``exp(-(Δr/σ√2)²)``)."""
    sim = simulate_scan(grid, model, pose, max_range=max_range)
    dr = ranges - sim
    w = jnp.exp(-0.5 * (dr / sigma) ** 2)
    n = jnp.maximum(jnp.sum(valid), 1).astype(w.dtype)
    return jnp.sum(jnp.where(valid, w, 0.0)) / n


def likelihood_field(
    grid: OccupancyGrid, sigma: float = 0.2, n_iter: int | None = None
) -> Array:
    """Precomputed likelihood field: per-cell ``exp(-d²/2σ²)`` where d is
    the distance to the nearest occupied cell. Computed with an
    iterated 3×3 min-plus relaxation (chamfer-style distance transform)
    — O(n_iter) dense passes, no data-dependent control flow.

    This enables the fast endpoint observation model: transform scan
    endpoints by a particle pose and gather field values — thousands of
    particles in one batched gather (no ray marching at all). The
    reference has no equivalent (it ray-traces + runs ICP per particle).
    """
    spec = grid.spec
    occ = grid.log_odds > 0.0
    res = spec.resolution
    if n_iter is None:
        n_iter = int(3.0 * sigma / res) + 1
    big = jnp.asarray(1e3, grid.log_odds.dtype)
    d = jnp.where(occ, 0.0, big)

    def body(_, d):
        # 3×3 neighborhood min-plus update (diagonal cost √2·res).
        pads = jnp.pad(d, 1, constant_values=big)
        c = res
        cd = res * 1.41421356
        cands = jnp.stack(
            [
                d,
                pads[:-2, 1:-1] + c,
                pads[2:, 1:-1] + c,
                pads[1:-1, :-2] + c,
                pads[1:-1, 2:] + c,
                pads[:-2, :-2] + cd,
                pads[:-2, 2:] + cd,
                pads[2:, :-2] + cd,
                pads[2:, 2:] + cd,
            ]
        )
        return jnp.min(cands, axis=0)

    d = jax.lax.fori_loop(0, n_iter, body, d)
    return jnp.exp(-0.5 * (d / sigma) ** 2)


def endpoint_likelihood(
    field: Array,
    spec,
    model: LaserModel,
    pose: Array,
    ranges: Array,
    valid: Array,
) -> Array:
    """Likelihood-field observation model: mean field value at the
    observed beam endpoints transformed by ``pose``."""
    fi = model.bearings(pose.dtype)
    ang = pose[2] + fi
    x = pose[0] + ranges * jnp.cos(ang)
    y = pose[1] + ranges * jnp.sin(ang)
    ix = jnp.floor((x - spec.origin_x) / spec.resolution).astype(jnp.int32)
    iy = jnp.floor((y - spec.origin_y) / spec.resolution).astype(jnp.int32)
    inb = valid & (ix >= 0) & (ix < spec.width) & (iy >= 0) & (iy < spec.height)
    flat = jnp.where(inb, iy * spec.width + ix, 0)
    vals = jnp.take(field.reshape(-1), flat)
    n = jnp.maximum(jnp.sum(inb), 1).astype(vals.dtype)
    return jnp.sum(jnp.where(inb, vals, 0.0)) / n
