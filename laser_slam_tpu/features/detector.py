"""Multiscale interest-point detection on the range curve.

JAX equivalent of the reference's FLIRT detector configuration
(``CFliterNode::InitFliter`` src/mapGraph/FlirterNode.cpp:489-604:
default *blob* detector over a Gaussian scale space with ``scale = 5``,
``baseSigma = 0.2``, ``sigmaStep = 1.4``, ``minPeak = 0.34``,
``minPeakDistance = 0.001``).

The FLIRT blob detector finds extrema of the normalized
difference-of-Gaussians of the range signal across bearing *and* scale.
Here the whole scale space is one ``[S, N]`` array built by ``S`` small
1D convolutions (vector-friendly, fixed shape), extrema detection is a
3×3 neighbourhood mask, and the per-scan output is a fixed-``K``
top-k selection with a validity mask — no ragged feature lists.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.scan import LaserModel, Scan

Array = jnp.ndarray

# FLIRT defaults (FlirterNode.cpp:587-604).
N_SCALES = 5
BASE_SIGMA = 0.2
SIGMA_STEP = 1.4
MIN_PEAK = 0.34
MAX_FEATURES = 32  # fixed feature budget per scan (ref lists are ragged)


class FeatureSet(NamedTuple):
    """Fixed-shape set of ``K`` interest points of one scan.

    ``vmap`` over scans gives batched ``[B, K, ...]`` sets.
    """

    xy: Array       # [K, 2] position in the sensor frame (meters)
    scale: Array    # [K] detection scale (sigma, radians of smoothing)
    score: Array    # [K] detector response (higher = stronger)
    beam: Array     # [K] int32 source beam index
    valid: Array    # [K] bool


def _gaussian_kernel(sigma_bins: float, radius: int, dtype) -> Array:
    x = jnp.arange(-radius, radius + 1, dtype=dtype)
    k = jnp.exp(-0.5 * (x / sigma_bins) ** 2)
    return k / jnp.sum(k)


def _smooth(signal: Array, weight_ok: Array, sigma_bins: float, radius: int) -> Array:
    """Mask-aware Gaussian smoothing (normalized convolution): invalid
    beams contribute zero weight instead of poisoning their neighbours."""
    dtype = signal.dtype
    k = _gaussian_kernel(sigma_bins, radius, dtype)
    s = jnp.convolve(signal * weight_ok, k, mode="same")
    w = jnp.convolve(weight_ok, k, mode="same")
    return s / jnp.maximum(w, 1e-6)


def detect_features(
    model: LaserModel,
    scan: Scan,
    k_features: int = MAX_FEATURES,
    min_peak: float = MIN_PEAK,
) -> FeatureSet:
    """Detect up to ``k_features`` blob interest points on one scan ``[N]``.

    Pipeline (all fixed-shape):

    1. Gaussian scale space of the range curve, sigmas
       ``baseSigma · sigmaStep^s`` in *radians*, converted to bearing bins.
    2. Normalized DoG across adjacent scales (scale-normalized blob
       response, as in FLIRT's blob detector).
    3. Local extrema over the 3-neighbourhood in bearing and scale,
       response ≥ ``min_peak`` · (response std), valid beams only.
    4. Global top-k by |response| → fixed ``K`` with validity mask.
    """
    n = model.n_beams
    dtype = scan.ranges.dtype
    ok = (~scan.bad).astype(dtype)
    r = jnp.where(scan.bad, 0.0, scan.ranges)

    # FLIRT's sigmas are curve-length meters; at a typical indoor range
    # (~3 m) one bearing bin spans ~3·dfi meters of surface, so convert
    # with that fixed factor — keeping the kernel sizes static (jit).
    bin_len = 3.0 * model.dfi
    sigmas = [BASE_SIGMA * SIGMA_STEP**s for s in range(N_SCALES + 1)]
    sig_bins = [max(s / bin_len, 0.6) for s in sigmas]
    radius = min(int(math.ceil(3 * max(sig_bins))), n // 2)
    levels = jnp.stack(
        [_smooth(r, ok, sb, radius) for sb in sig_bins]
    )                                                     # [S+1, N]

    # Scale-normalized DoG (difference between adjacent smoothing levels).
    dog = levels[1:] - levels[:-1]                        # [S, N]

    # 3-neighbourhood extrema in bearing...
    left = jnp.roll(dog, 1, axis=1)
    right = jnp.roll(dog, -1, axis=1)
    is_max = (dog > left) & (dog > right)
    is_min = (dog < left) & (dog < right)
    # ...and in scale (compare to the same bearing one scale up/down,
    # clamped at the ends).
    up = jnp.concatenate([dog[1:], dog[-1:]], axis=0)
    dn = jnp.concatenate([dog[:1], dog[:-1]], axis=0)
    is_max &= (dog >= up) & (dog >= dn)
    is_min &= (dog <= up) & (dog <= dn)

    resp = jnp.abs(dog)
    std = jnp.sqrt(
        jnp.sum(ok * (dog - jnp.mean(dog, where=ok[None, :] > 0)) ** 2)
        / jnp.maximum(jnp.sum(ok) * N_SCALES, 1.0)
    )
    thresh = min_peak * jnp.maximum(std, 1e-6)

    i = jnp.arange(n)
    interior = (i > 0) & (i < n - 1)
    cand = (
        (is_max | is_min)
        & (resp > thresh)
        & ~scan.bad[None, :]
        & interior[None, :]
    )                                                     # [S, N]

    flat_resp = jnp.where(cand, resp, -jnp.inf).reshape(-1)
    top = jax.lax.top_k(flat_resp, k_features)
    idx = top[1]
    score = top[0]
    valid = jnp.isfinite(score)

    beam = (idx % n).astype(jnp.int32)
    scale_i = idx // n
    scale = jnp.asarray(sigmas, dtype)[jnp.clip(scale_i + 1, 0, N_SCALES)]

    fi = model.bearings(dtype)[beam]
    rng = scan.ranges[beam]
    xy = jnp.stack([rng * jnp.cos(fi), rng * jnp.sin(fi)], axis=-1)
    zero = jnp.zeros((), dtype)
    return FeatureSet(
        xy=jnp.where(valid[:, None], xy, zero),
        scale=jnp.where(valid, scale, zero),
        score=jnp.where(valid, score, zero),
        beam=jnp.where(valid, beam, -1),
        valid=valid,
    )
