"""Beacon-based positioning (the reference's BN subsystem,
src/Main-Ctrl/BN/BNpos.cpp): a robot-mounted receiver ranges a set of
surveyed beacons; position comes from trilateration.

Fixed-shape masked Gauss-Newton over ``[M]`` range
residuals, jittable and vmappable over a batch of fixes (e.g. scoring
beacon fixes for every particle at once).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

Array = jnp.ndarray


class BeaconFix(NamedTuple):
    xy: Array       # [2] estimated position
    err: Array      # [] RMS range residual [m]
    fail: Array     # [] bool — fewer than 3 usable beacons or divergence


def trilaterate(
    beacons: Array,
    ranges: Array,
    valid: Array,
    init_xy: Array | None = None,
    iters: int = 10,
) -> BeaconFix:
    """Least-squares position from ranges to known beacons.

    ``beacons [M, 2]``, ``ranges [M]``, ``valid [M]`` bool. Needs ≥ 3
    usable beacons for a unique fix (2 leaves a mirror ambiguity).
    """
    dtype = ranges.dtype
    w = valid.astype(dtype)
    n = jnp.sum(w)
    fail = n < 3

    if init_xy is None:
        init_xy = jnp.sum(beacons * w[:, None], axis=0) / jnp.maximum(n, 1.0)

    def body(_, xy):
        d = xy[None, :] - beacons                      # [M, 2]
        dist = jnp.maximum(jnp.linalg.norm(d, axis=-1), 1e-6)
        resid = dist - ranges                          # [M]
        J = d / dist[:, None]                          # [M, 2]
        Jw = J * w[:, None]
        H = Jw.T @ J + 1e-9 * jnp.eye(2, dtype=dtype)
        g = Jw.T @ resid
        return xy - jnp.linalg.solve(H, g)

    xy = jax.lax.fori_loop(0, iters, body, init_xy.astype(dtype))
    dist = jnp.linalg.norm(xy[None, :] - beacons, axis=-1)
    err = jnp.sqrt(
        jnp.sum(w * (dist - ranges) ** 2) / jnp.maximum(n, 1.0)
    )
    fail = fail | ~jnp.all(jnp.isfinite(xy))
    xy = jnp.where(fail, init_xy, xy)
    return BeaconFix(xy=xy, err=jnp.where(fail, jnp.inf, err), fail=fail)


def heading_from_fixes(prev_xy: Array, xy: Array, min_move: float = 0.05) -> Array:
    """Heading from two consecutive fixes; NaN when the motion is too
    small to be directionally meaningful."""
    d = xy - prev_xy
    th = jnp.arctan2(d[1], d[0])
    return jnp.where(jnp.linalg.norm(d) < min_move, jnp.nan, th)
