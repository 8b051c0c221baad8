"""Polar scan projection (resampling into another frame's bearing grid).

Fixed-shape JAX reformulation of ``pm_scan_project``
(src/zhpsm/ZHPolar_Match.cpp:1356-1479). The reference walks adjacent
beam pairs and serially interpolates each pair's span of bearing bins,
keeping the minimum range per bin (nearest surface wins) and tagging
occluded spans. Here the same computation is one dense masked
``[N_pairs, N_bins]`` candidate matrix followed by a min-reduce over
pairs — fully parallel, fixed-shape, and batched over scan pairs via
``vmap``.

For N ≤ 541 beams the matrix is ≤ 541×541 floats (~1.2 MB); XLA fuses
the construction and reduction.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..core.scan import LaserModel, Scan

Array = jnp.ndarray

# Range value used for bins no surface projects into (the reference uses
# 10000 cm = 100 m, ZHPolar_Match.cpp:1374).
EMPTY_RANGE = 100.0


class Projection(NamedTuple):
    """Current scan resampled at the reference scan's bearings."""

    new_r: Array      # [..., N] interpolated ranges, EMPTY_RANGE where empty
    empty: Array      # [..., N] bool: no surface crossed this bearing
    occluded: Array   # [..., N] bool: nearest crossing was back-facing

    @property
    def bad(self) -> Array:
        return self.empty | self.occluded


def _pair_valid_from_seg(scan: Scan) -> Array:
    """Adjacent beams (i-1, i) usable for interpolation: same nonzero
    segment, both good (ZHPolar_Match.cpp:1393)."""
    seg, bad = scan.seg, scan.bad
    seg_prev = jnp.roll(seg, 1, axis=-1)
    bad_prev = jnp.roll(bad, 1, axis=-1)
    ok = (seg != 0) & (seg == seg_prev) & ~bad & ~bad_prev
    i = jnp.arange(seg.shape[-1])
    return jnp.where(i == 0, False, ok)


def scan_project(model: LaserModel, scan: Scan, pose: Array) -> Projection:
    """Project ``scan`` posed at ``pose = (x, y, theta)`` (relative to the
    target frame) onto the target's bearing grid.

    Works on a single scan ``[N]``; ``vmap`` for batches.
    """
    fi = model.bearings(scan.ranges.dtype)                    # [N]
    r = scan.ranges
    px, py, pth = pose[0], pose[1], pose[2]

    # Transform beams into the target frame, in polar coordinates
    # (ZHPolar_Match.cpp:1364-1377).
    ang = pth + fi
    x = r * jnp.cos(ang) + px
    y = r * jnp.sin(ang) + py
    rr = jnp.sqrt(x * x + y * y)
    phi = jnp.arctan2(y, x)
    # Third-quadrant lift keeps 270°-FOV scans continuous across ±pi
    # (ZHPolar_Match.cpp:1371-1373).
    phi = jnp.where((x < 0) & (y < 0), phi + 2.0 * jnp.pi, phi)

    # Per-pair quantities; pair i spans beams (i-1, i).
    phi0 = jnp.roll(phi, 1)
    rr0 = jnp.roll(rr, 1)
    pair_ok = _pair_valid_from_seg(scan)
    # Skip pairs wrapping through the whole scan at the ±pi boundary
    # (the reference's "crude hack", ZHPolar_Match.cpp:1404-1407).
    pair_ok = pair_ok & (jnp.abs(phi - phi0) < jnp.pi)

    a_lo = jnp.minimum(phi0, phi)
    a_hi = jnp.maximum(phi0, phi)
    # Back-facing span ⇒ surface seen from behind ⇒ occluder
    # (ZHPolar_Match.cpp:1420-1431; equality counts as occluded).
    occl_pair = phi <= phi0

    # Candidate matrix over (pair i, bearing bin j).
    cover = (fi[None, :] >= a_lo[:, None]) & (fi[None, :] <= a_hi[:, None])
    mask = cover & pair_ok[:, None]                            # [N, N]

    dphi = phi - phi0
    dphi_safe = jnp.where(jnp.abs(dphi) < 1e-9, 1e-9, dphi)
    t = (fi[None, :] - phi0[:, None]) / dphi_safe[:, None]
    ri = rr0[:, None] + (rr - rr0)[:, None] * t                # [N, N]

    big = jnp.asarray(EMPTY_RANGE, ri.dtype)
    ri_masked = jnp.where(mask, ri, big)
    new_r = jnp.min(ri_masked, axis=0)                         # [N]
    winner = jnp.argmin(ri_masked, axis=0)                     # [N]
    empty = ~jnp.any(mask, axis=0)
    occluded = jnp.take(occl_pair, winner) & ~empty
    new_r = jnp.where(empty, big, new_r)
    return Projection(new_r=new_r, empty=empty, occluded=occluded)


def scan_project_banded(
    model: LaserModel, scan: Scan, pose: Array, band: int = 32
) -> Projection:
    """Banded variant of :func:`scan_project`.

    A pair's bearing in the target frame is its own bearing plus the
    rotation (in bins, ``round(θ/dfi)``) plus a distortion from the
    translation that is small for all but very close points. Restricting
    each bin's candidate pairs to a ±``band`` window around that shifted
    index turns the O(N²) candidate matrix into O(N·2band) — ~4× less
    arithmetic for N=181 — with identical results whenever every true
    candidate falls inside the band (pairs whose translation-induced
    angular shift exceeds the band are missed; with ``band=32`` that
    needs a point closer than ~0.9 m during a 0.5 m translation).
    """
    fi = model.bearings(scan.ranges.dtype)
    r = scan.ranges
    n = model.n_beams
    px, py, pth = pose[0], pose[1], pose[2]

    ang = pth + fi
    x = r * jnp.cos(ang) + px
    y = r * jnp.sin(ang) + py
    rr = jnp.sqrt(x * x + y * y)
    phi = jnp.arctan2(y, x)
    phi = jnp.where((x < 0) & (y < 0), phi + 2.0 * jnp.pi, phi)

    phi0 = jnp.roll(phi, 1)
    rr0 = jnp.roll(rr, 1)
    pair_ok = _pair_valid_from_seg(scan)
    pair_ok = pair_ok & (jnp.abs(phi - phi0) < jnp.pi)
    a_lo = jnp.minimum(phi0, phi)
    a_hi = jnp.maximum(phi0, phi)
    occl_pair = phi <= phi0

    # Candidate pair indices per bin: j - shift ± band.
    shift = jnp.round(pth / model.dfi).astype(jnp.int32)
    offs = jnp.arange(-band, band)                             # [K]
    cand = jnp.arange(n)[:, None] - shift + offs[None, :]      # [N, K]
    inb = (cand >= 0) & (cand < n)
    cand_c = jnp.clip(cand, 0, n - 1)

    al = a_lo[cand_c]
    ah = a_hi[cand_c]
    pv = pair_ok[cand_c] & inb
    cover = (fi[:, None] >= al) & (fi[:, None] <= ah) & pv     # [N, K]

    p0 = phi0[cand_c]
    dp = phi[cand_c] - p0
    dp = jnp.where(jnp.abs(dp) < 1e-9, 1e-9, dp)
    t = (fi[:, None] - p0) / dp
    ri = rr0[cand_c] + (rr[cand_c] - rr0[cand_c]) * t          # [N, K]

    big = jnp.asarray(EMPTY_RANGE, ri.dtype)
    ri_masked = jnp.where(cover, ri, big)
    new_r = jnp.min(ri_masked, axis=1)
    kmin = jnp.argmin(ri_masked, axis=1)
    empty = ~jnp.any(cover, axis=1)
    occluded = (
        jnp.take_along_axis(occl_pair[cand_c], kmin[:, None], axis=1)[:, 0]
        & ~empty
    )
    new_r = jnp.where(empty, big, new_r)
    return Projection(new_r=new_r, empty=empty, occluded=occluded)
