"""Scan containers and laser sensor models.

Batched JAX replacement for the reference's ``PMScan`` struct-of-arrays and
``Base_PARAM`` laser presets (src/zhpsm/PolarParameter.h:42-184). Instead
of per-scan heap objects with ``bad[]`` flag bytes, scans are fixed-shape
batched arrays ``[..., N]`` with boolean masks — the shapes XLA wants.

Units: **meters / radians** everywhere (the reference works in cm for the
matchers and converts at module boundaries, e.g. ZHPolar_Match.cpp:158;
we avoid that entirely).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class LaserModel:
    """Static description of a 2D laser range finder.

    Mirrors ``Base_PARAM`` (src/zhpsm/PolarParameter.h:42-69) but in
    meters. Hashable and usable as a static jit argument.
    """

    name: str
    n_beams: int              # pm_l_points
    fov_deg: float            # pm_fov
    fi_min_deg: float         # start bearing, degrees
    max_range: float          # [m] pm_max_range
    min_range: float = 0.10   # [m] PM_MIN_RANGE (10 cm)
    min_valid_points: int = 40
    window: int = 20          # pm_scan_window: half-window in bearing bins

    @property
    def fi_min(self) -> float:
        return math.radians(self.fi_min_deg)

    @property
    def dfi(self) -> float:
        """Angular resolution [rad]: fov / (n_beams - 1)."""
        return math.radians(self.fov_deg) / (self.n_beams - 1.0)

    def with_start(self, fi_min_rad: float, max_range: float | None = None) -> "LaserModel":
        """Override start bearing / max range from a log header (the
        reference does the same on the first CARMEN record,
        ZHPolar_Match.cpp:230-238)."""
        return dataclasses.replace(
            self,
            fi_min_deg=math.degrees(fi_min_rad),
            max_range=self.max_range if max_range is None else max_range,
        )

    def bearings(self, dtype=jnp.float32) -> Array:
        """``[N]`` beam bearing angles (pm_init, ZHPolar_Match.cpp:68-78)."""
        i = jnp.arange(self.n_beams, dtype=dtype)
        return i * jnp.asarray(self.dfi, dtype) + jnp.asarray(self.fi_min, dtype)


# Laser presets (src/zhpsm/PolarParameter.h:71-84), ranges converted cm→m.
LMS211 = LaserModel("LMS211", 181, 180.0, -90.0, 50.0, min_valid_points=40, window=20)
LMS511 = LaserModel("LMS511", 361, 180.0, 0.0, 50.0, min_valid_points=80, window=40)
LMS151 = LaserModel("LMS151", 541, 270.0, -45.0, 50.0, min_valid_points=100, window=50)

PRESETS = {m.name: m for m in (LMS211, LMS511, LMS151)}


class Scan(NamedTuple):
    """A (batch of) preprocessed polar scan(s); all fields ``[..., N]``.

    Replaces ``PMScan`` (src/zhpsm/PolarParameter.h:105-184). The
    reference's bit-flag ``bad[]`` byte array becomes a boolean mask; the
    ``x[]``/``y[]`` caches are recomputed on demand (cheap on the device);
    ``seg[]`` keeps the same semantics (0 = singleton / no segment).
    """

    ranges: Array   # [..., N] float, meters
    bad: Array      # [..., N] bool — far / short / otherwise invalid
    seg: Array      # [..., N] int32 segment ids; 0 means "no segment"

    @property
    def n_beams(self) -> int:
        return self.ranges.shape[-1]

    def points(self, model: LaserModel) -> Array:
        """``[..., N, 2]`` Cartesian points in the sensor frame."""
        fi = model.bearings(self.ranges.dtype)
        return jnp.stack(
            [self.ranges * jnp.cos(fi), self.ranges * jnp.sin(fi)], axis=-1
        )


def raw_scan(ranges: Array, model: LaserModel) -> Scan:
    """Build an unpreprocessed :class:`Scan` from raw ranges [m].

    Mirrors the readers' normalization (ZHPolar_Match.cpp:158-166,
    readCarmon 254-260): readings below ``min_range`` are pushed beyond
    ``max_range`` so the far-point filter tags them.
    """
    ranges = jnp.asarray(ranges)
    too_close = ranges < model.min_range
    ranges = jnp.where(too_close, model.max_range + 1.0, ranges)
    return Scan(
        ranges=ranges,
        bad=jnp.zeros(ranges.shape, dtype=bool),
        seg=jnp.zeros(ranges.shape, dtype=jnp.int32),
    )


def pad_beams(ranges: np.ndarray, n_beams: int, fill: float) -> np.ndarray:
    """Pad a ``[T, M]`` range array up to ``n_beams`` with ``fill``
    (readCarmon pads 180→181-beam logs, ZHPolar_Match.cpp:276-279)."""
    t, m = ranges.shape
    if m >= n_beams:
        return ranges[:, :n_beams]
    out = np.full((t, n_beams), fill, dtype=ranges.dtype)
    out[:, :m] = ranges
    return out
