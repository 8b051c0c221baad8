"""Pose-free loop-candidate proposal: invariant submap signatures.

On a long trajectory the odometry estimate drifts far beyond any usable
search gate (intel-lab: true revisits end up >20 m apart with >2.5 rad
heading error in the odometry frame), so candidate proposal cannot rely
on estimated poses at all. The reference's answer is FLIRT descriptors +
RANSAC (src/mapGraph/FlirterNode.cpp:394-482) plus random sampling of
earlier nodes (MapGraph.cpp:2063-2099). The batched answer is a
*global* descriptor per submap that is invariant to the unknown relative
pose, compared all-pairs in one matrix op:

- **signature**: the histogram of pairwise point distances inside the
  submap cloud (the D2 shape distribution). Rigid motions preserve all
  pairwise distances, so the signature is exactly rotation- and
  translation-invariant; no pose estimate enters at any point.
- **similarity**: χ² distance between histograms for **all** anchor
  pairs at once — one ``[A, A, B]`` batched reduction, where the
  reference verifies a handful of sampled candidates.

Signatures only *rank* candidates; every proposed pair still passes the
full correlative + ICP + reciprocity verification in
:mod:`.loop_closure`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jnp.ndarray

DEFAULT_BINS = 32
DEFAULT_DMAX = 16.0
DEFAULT_SAMPLE = 384


def submap_signatures(
    points: Array,
    valid: Array,
    bins: int = DEFAULT_BINS,
    dmax: float = DEFAULT_DMAX,
    sample: int = DEFAULT_SAMPLE,
    chunk: int = 32,
) -> Array:
    """Normalized pairwise-distance histograms ``[S, bins]`` of submap
    clouds ``points [S, P, 2]`` / ``valid [S, P]``.

    Points are strided down to ``sample`` per submap before the O(P²)
    distance matrix; submaps are processed ``chunk`` at a time to bound
    live memory.
    """
    s, p, _ = points.shape
    stride = max(p // sample, 1)
    pts = points[:, ::stride]
    ok = valid[:, ::stride]
    dtype = points.dtype

    def one(pts_i: Array, ok_i: Array) -> Array:
        d = jnp.linalg.norm(
            pts_i[:, None, :] - pts_i[None, :, :], axis=-1
        )
        w = (ok_i[:, None] & ok_i[None, :]).astype(dtype)
        # exclude the zero self-distances
        w = w * (1.0 - jnp.eye(pts_i.shape[0], dtype=dtype))
        b = jnp.clip(
            (d / dmax * bins).astype(jnp.int32), 0, bins - 1
        ).reshape(-1)
        hist = jnp.zeros(bins, dtype).at[b].add(w.reshape(-1))
        return hist / jnp.maximum(jnp.sum(hist), 1.0)

    pad = (-s) % chunk
    pts_c = jnp.pad(pts, ((0, pad), (0, 0), (0, 0)))
    ok_c = jnp.pad(ok, ((0, pad), (0, 0)))
    n_chunks = (s + pad) // chunk
    out = jax.lax.map(
        lambda a: jax.vmap(one)(*a),
        (
            pts_c.reshape(n_chunks, chunk, *pts_c.shape[1:]),
            ok_c.reshape(n_chunks, chunk, *ok_c.shape[1:]),
        ),
    )
    return out.reshape(-1, bins)[:s]


def signature_affinity(sigs: Array) -> Array:
    """``[A, A]`` similarity in (0, 1]: ``exp(-χ²/2)`` of histogram
    pairs. Symmetric; diagonal is 1."""
    a = sigs[:, None, :]
    b = sigs[None, :, :]
    chi2 = jnp.sum((a - b) ** 2 / (a + b + 1e-9), axis=-1)
    return jnp.exp(-0.5 * chi2)


def signature_gate(
    sigs: Array,
    min_gap: int,
    per_dst: int = 6,
    min_affinity: float = 0.5,
) -> Array:
    """``[A, A]`` bool: pairs ``i < j - min_gap`` whose signatures rank
    in ``j``'s top ``per_dst`` most-similar earlier anchors and clear
    ``min_affinity``. Purely appearance-based — usable at any drift."""
    a = sigs.shape[0]
    aff = signature_affinity(sigs)
    ii = jnp.arange(a)
    ordered = (ii[None, :] - ii[:, None]) > min_gap
    score = jnp.where(ordered, aff, -jnp.inf)

    score_t = score.T                                     # [dst, src]
    kth = jax.lax.top_k(score_t, min(per_dst, a))[0][:, -1]
    keep = (score_t >= kth[:, None]) & (score_t >= min_affinity)
    return keep.T & ordered
