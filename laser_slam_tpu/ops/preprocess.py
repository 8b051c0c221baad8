"""Scan preprocessing: median filter, far-point tagging, segmentation.

Fixed-shape JAX reformulation of ``pm_preprocessScan``
(src/zhpsm/ZHPolar_Match.cpp:861-866) and its three stages:

- ``pm_median_filter`` (1610-1639): window-5 median via a sort over a
  stacked-shift axis instead of a per-point bubble sort.
- ``pm_find_far_points`` (1583-1590): a mask compare.
- ``pm_segment_scan`` (1495-1576): the reference's sequential
  segment-counter loop becomes a **boolean linear recurrence**
  ``c[i] = a[i] | (b[i] & c[i-1])`` over "pair (i-1, i) is connected",
  solved in O(log N) depth with ``lax.associative_scan``. Segment ids are
  then cumulative sums of breaks. (The reference's rare
  "three-collinear-points rescue" at 1549-1567 retroactively merges a
  singleton; we apply its forward effect only — see ``pair_connected``.)

All functions operate on ``[..., N]`` arrays and are vmap/jit friendly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.scan import LaserModel, Scan

Array = jax.Array

# Max range discontinuity between consecutive points within one segment,
# meters (PM_SEG_MAX_DIST = 20 cm, PolarParameter.h:14).
SEG_MAX_DIST = 0.20
MEDIAN_HALF_WINDOW = 2  # pm_median_filter HALF_WINDOW (ZHPolar_Match.cpp:1612)


def median_filter(ranges: Array, half_window: int = MEDIAN_HALF_WINDOW) -> Array:
    """Window-(2h+1) median along the last axis with edge clamping."""
    n = ranges.shape[-1]
    idx = jnp.arange(n)
    cols = [
        jnp.take(ranges, jnp.clip(idx + d, 0, n - 1), axis=-1)
        for d in range(-half_window, half_window + 1)
    ]
    stacked = jnp.stack(cols, axis=-1)           # [..., N, W]
    return jnp.sort(stacked, axis=-1)[..., half_window]


def far_point_mask(ranges: Array, model: LaserModel) -> Array:
    """True where the reading exceeds the sensor's max range."""
    return ranges > model.max_range


def pair_connected(ranges: Array, bad: Array, max_dist: float = SEG_MAX_DIST) -> Array:
    """``[..., N]`` bool: entry ``i`` is True iff beams ``i-1`` and ``i``
    belong to the same segment (entry 0 is always False).

    Encodes pm_segment_scan's membership rule (ZHPolar_Match.cpp:1522-1567):
    consecutive points connect if their range gap is small, or if the
    current point continues the linear extrapolation through the two
    previous points (corridor walls at grazing incidence; the reference
    gates this on segment history — running segment at 1530-1537 or the
    three-collinear-singleton rescue at 1549-1562). Working through the
    cases, both gates reduce to "beam i-2 is also good", up to one rare
    corner (a collinear continuation immediately after a large jump out
    of a multi-point segment connects here but not in the reference),
    which makes the predicate stateless — no sequential pass at all.
    """
    r = ranges
    good = ~bad
    r_m1 = jnp.roll(r, 1, axis=-1)
    r_m2 = jnp.roll(r, 2, axis=-1)
    close = jnp.abs(r - r_m1) < max_dist
    extrap = jnp.abs(r - (2.0 * r_m1 - r_m2)) < max_dist

    both_good = good & jnp.roll(good, 1, axis=-1)
    three_good = both_good & jnp.roll(good, 2, axis=-1)
    c = (both_good & close) | (three_good & extrap)
    # Pair 0 (beams -1, 0) does not exist; pair 1 has no extrapolation
    # history (the reference seeds beams (0, 1) with the plain-distance
    # rule, 1506-1518).
    i = jnp.arange(r.shape[-1])
    c = jnp.where(i == 0, False, c)
    return jnp.where(i == 1, both_good & close, c)


def segment_ids(pair_ok: Array) -> Array:
    """Integer segment labels from the pair relation, with the reference's
    convention that singleton points get label 0 (pm_segment_scan:1508)."""
    breaks = (~pair_ok).astype(jnp.int32)
    raw = jnp.cumsum(breaks, axis=-1)            # same value ⇔ same segment
    has_left = pair_ok
    has_right = jnp.concatenate(
        [pair_ok[..., 1:], jnp.zeros_like(pair_ok[..., :1])], axis=-1
    )
    singleton = ~(has_left | has_right)
    return jnp.where(singleton, 0, raw + 1)


def preprocess(ranges: Array, model: LaserModel) -> Scan:
    """Full preprocessing chain → :class:`Scan` (pm_preprocessScan)."""
    r = median_filter(ranges)
    bad = far_point_mask(r, model) | (r < model.min_range)
    pair_ok = pair_connected(r, bad)
    seg = segment_ids(pair_ok)
    return Scan(ranges=r, bad=bad, seg=seg)


def preprocess_log(ranges: Array, model: LaserModel) -> Scan:
    """Preprocess a whole ``[T, N]`` log in one batched call."""
    return preprocess(ranges, model)
