"""Batched-hypothesis RANSAC SE(2) matching of two feature sets.

JAX equivalent of FLIRT's RansacFeatureSetMatcher as used by
``CFliterNode::matchNodePair`` (src/mapGraph/FlirterNode.cpp:394-423,
matcher config 575-580: acceptance χ² 0.4·0.4, success probability
0.99, inlier probability 0.5, distance threshold 0.8) and
``matchFeaturePoints`` (464-482). The serial sample-until-confident
loop becomes a *fixed batch of H hypotheses evaluated at once*: sample
H correspondence pairs, closed-form SE(2) from each 2-point sample,
score all H × K inlier matrices in one shot, pick the best, refine on
its inliers with a weighted Kabsch solve. Edge information is ``1/err``
like the reference (FlirterNode.cpp:416-419).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import se2
from .descriptor import descriptor_distance
from .detector import FeatureSet

Array = jnp.ndarray

N_HYPOTHESES = 128
DESC_MATCH_THRESH = 0.8   # max descriptor χ² for a candidate correspondence
INLIER_DIST = 0.4         # acceptance distance [m] (0.4² χ², FlirterNode.cpp:576)
MIN_INLIERS = 5


class FeatureMatchResult(NamedTuple):
    pose: Array        # [3] SE(2) pose of set B's frame in set A's frame
    n_inliers: Array   # [] int32
    err: Array         # [] mean inlier residual after refinement (m)
    fail: Array        # [] bool
    information: Array # [] scalar edge information = 1 / err


def _two_point_se2(pa: Array, pb: Array, qa: Array, qb: Array) -> Array:
    """Closed-form SE(2) aligning segment (qa, qb) onto (pa, pb):
    rotation from segment direction, translation from midpoints."""
    dp = pb - pa
    dq = qb - qa
    th = jnp.arctan2(dp[1], dp[0]) - jnp.arctan2(dq[1], dq[0])
    c, s = jnp.cos(th), jnp.sin(th)
    mq = 0.5 * (qa + qb)
    mp = 0.5 * (pa + pb)
    tx = mp[0] - (c * mq[0] - s * mq[1])
    ty = mp[1] - (s * mq[0] + c * mq[1])
    return jnp.stack([tx, ty, th])


def match_features(
    fa: FeatureSet,
    da: Array,
    fb: FeatureSet,
    db: Array,
    seed: int | Array = 0,
    n_hypotheses: int = N_HYPOTHESES,
) -> FeatureMatchResult:
    """RANSAC-match feature set B onto A; returns B's frame in A's frame.

    ``da``/``db`` are the ``[K, D]`` descriptors. jit/vmap-safe: the
    candidate correspondence for every feature of B is its best
    descriptor match in A (gated by ``DESC_MATCH_THRESH``), hypotheses
    are random pairs of those correspondences.
    """
    k = fb.xy.shape[0]
    dtype = fa.xy.dtype
    key = jax.random.PRNGKey(seed) if jnp.ndim(seed) == 0 else seed

    dist = descriptor_distance(db, da)                    # [Kb, Ka]
    pair_ok = fb.valid[:, None] & fa.valid[None, :]
    dist = jnp.where(pair_ok, dist, jnp.inf)
    j_best = jnp.argmin(dist, axis=1)                     # [Kb]
    d_best = jnp.take_along_axis(dist, j_best[:, None], axis=1)[:, 0]
    corr_ok = jnp.isfinite(d_best) & (d_best < DESC_MATCH_THRESH)

    qs = fb.xy                                            # [Kb, 2] source
    ps = fa.xy[j_best]                                    # [Kb, 2] target

    # Sample H pairs of distinct correspondence indices, biased to valid
    # ones by weighting invalid with ~0 probability.
    w = corr_ok.astype(dtype) + 1e-6
    logits = jnp.log(w / jnp.sum(w))
    k1, k2 = jax.random.split(key)
    i1 = jax.random.categorical(k1, logits, shape=(n_hypotheses,))
    i2 = jax.random.categorical(k2, logits, shape=(n_hypotheses,))
    distinct = (i1 != i2) & corr_ok[i1] & corr_ok[i2]

    hyp = jax.vmap(
        lambda a, b: _two_point_se2(ps[a], ps[b], qs[a], qs[b])
    )(i1, i2)                                             # [H, 3]

    # Score every hypothesis against every candidate correspondence.
    q_h = jax.vmap(lambda p: se2.transform_points(p, qs))(hyp)  # [H, Kb, 2]
    res = jnp.linalg.norm(q_h - ps[None], axis=-1)              # [H, Kb]
    inl = (res < INLIER_DIST) & corr_ok[None, :] & distinct[:, None]
    n_inl = jnp.sum(inl, axis=1)                                # [H]
    # Tie-break equal inlier counts by total inlier residual.
    score = n_inl.astype(dtype) - jnp.sum(jnp.where(inl, res, 0.0), axis=1) / (
        INLIER_DIST * k
    )
    h_best = jnp.argmax(score)
    inliers = inl[h_best]                                       # [Kb]
    n = n_inl[h_best]

    # Weighted Kabsch refinement on the winning inlier set.
    wk = inliers.astype(dtype)
    m = jnp.maximum(jnp.sum(wk), 1.0)
    mq = jnp.sum(qs * wk[:, None], axis=0) / m
    mp = jnp.sum(ps * wk[:, None], axis=0) / m
    dq = (qs - mq) * wk[:, None]
    dp = ps - mp
    sxx = jnp.sum(dq[:, 0] * dp[:, 0])
    sxy = jnp.sum(dq[:, 0] * dp[:, 1])
    syx = jnp.sum(dq[:, 1] * dp[:, 0])
    syy = jnp.sum(dq[:, 1] * dp[:, 1])
    th = jnp.arctan2(sxy - syx, sxx + syy)
    c, s = jnp.cos(th), jnp.sin(th)
    tx = mp[0] - (c * mq[0] - s * mq[1])
    ty = mp[1] - (s * mq[0] + c * mq[1])
    pose = jnp.stack([tx, ty, th])

    qr = se2.transform_points(pose, qs)
    err = jnp.sum(jnp.where(inliers, jnp.linalg.norm(qr - ps, axis=-1), 0.0)) / m
    fail = n < MIN_INLIERS
    pose = jnp.where(fail, jnp.zeros(3, dtype), pose)
    info = jnp.where(fail, 0.0, 1.0 / jnp.maximum(err, 1e-4))
    return FeatureMatchResult(
        pose=pose,
        n_inliers=n.astype(jnp.int32),
        err=jnp.where(fail, jnp.asarray(jnp.inf, dtype), err),
        fail=fail,
        information=info,
    )
