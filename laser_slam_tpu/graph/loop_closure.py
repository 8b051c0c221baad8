"""Loop-closure detection: batched gating + batched verification.

Fixed-shape JAX redesign of the reference's serial candidate scan
(``CMapGraph::addMapNodeCov`` loops over all prior submaps,
src/mapGraph/MapGraph.cpp:1272-1484):

- geometric gates — bounding-box overlap ratio ≥ 0.4
  (isOverlappedArea:962-993) and center distance ≤ 2 m
  (isLoopyArea:995-1032, constant-covariance mode) — are evaluated for
  **all** anchor pairs at once as a dense masked matrix;
- candidate verification (the reference rasterizes each submap and runs
  MRPT ICP per candidate, MapNode.cpp:625-759) becomes one vmapped
  scan-matcher batch, shardable across chips;
- acceptance mirrors the reference's gates: match success, bounded
  correction vs the initial guess (isBigTrafo:2103-2114), and a
  match-quality threshold (ICP_QUALITY_THRESHOLD 0.8 / 0.45,
  MapGraph.cpp:42-43);
- mismatch pruning keeps the largest pairwise-consistent cluster of
  accepted loops per target (deleteMisMatch / calculateFinalPose
  semantics, MapGraph.cpp:110-223) via a vote matrix instead of
  sequential deletion.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import se2
from ..core.scan import LaserModel, Scan
from ..ops.icp_points import match_icp_points, scan_to_points

Array = jnp.ndarray

LOOP_RADIUS = 2.0          # [m] isLoopyArea constant-cov search radius
BBOX_OVERLAP_MIN = 0.4     # isOverlappedArea threshold
MIN_INDEX_GAP = 2          # skip adjacent submaps (addMapNodeCov:1342)
MAX_TRANSFORM_DELTA = 1.5  # [m] DIS_THRESHOLD (MapGraph.cpp:40)
MAX_ANGLE_DELTA = 0.8      # [rad] bound on correction vs odometry guess
QUALITY_MIN = 0.45         # ICP_QUALITY_REVERSE_THRESHOLD (MapGraph.cpp:43)
MATCH_ERR_MAX = 0.12       # [m] mean matched-point distance gate


class LoopCandidates(NamedTuple):
    src: Array    # [C] anchor indices (earlier scan)
    dst: Array    # [C] anchor indices (later scan)
    valid: Array  # [C] bool


class VerifiedLoops(NamedTuple):
    src: Array
    dst: Array
    rel: Array       # [C, 3] measured relative pose src→dst
    quality: Array   # [C] matched-beam fraction
    accept: Array    # [C] bool — strict tier (solve-grade edges)
    tentative: Array | None = None  # [C] bool — loose tier: correct-
    #   looking matches below the strict gates; only usable after a
    #   residual-under-solution promotion check (see _solve_with_bank)
    diag: dict | None = None  # optional per-gate masks (tuning/tests)
    cov: Array | None = None  # [C, 3, 3] per-loop Censi covariance of
    #   ``rel`` (from the polish ICP) — the reference propagates its
    #   matcher covariance into the graph the same way (FMatchKeyFrame2/
    #   setCov, src/zhcsm/ZHCanonical_Matcher.cpp:287-298, 79-81)


def submap_bboxes(
    model: LaserModel, scans: Scan, poses: Array
) -> tuple[Array, Array]:
    """Per-scan world-frame AABBs of valid beam endpoints:
    ``(lo [T,2], hi [T,2])`` (the role of CMapNode::updateObsRange,
    MapNode.cpp:150)."""
    fi = model.bearings(scans.ranges.dtype)
    ok = ~scans.bad & (scans.ranges < model.max_range)
    ang = poses[:, 2:3] + fi[None, :]
    ex = poses[:, 0:1] + scans.ranges * jnp.cos(ang)
    ey = poses[:, 1:2] + scans.ranges * jnp.sin(ang)
    big = 1e9
    lo = jnp.stack(
        [
            jnp.min(jnp.where(ok, ex, big), axis=1),
            jnp.min(jnp.where(ok, ey, big), axis=1),
        ],
        axis=-1,
    )
    hi = jnp.stack(
        [
            jnp.max(jnp.where(ok, ex, -big), axis=1),
            jnp.max(jnp.where(ok, ey, -big), axis=1),
        ],
        axis=-1,
    )
    return lo, hi


def drift_radius_matrix(
    n: int,
    r0: float | Array,
    rate: float | Array,
    rmax: float | Array,
    dtype=jnp.float32,
) -> Array:
    """``[A, A]`` per-pair loop search radii that grow with the odometry
    path length between the anchors.

    The relative-pose uncertainty of anchors ``(i, j)`` accumulates over
    the ``|j - i|`` odometry steps between them, so a revisit after a
    long excursion must be searched in a drift-sized window while nearby
    anchors keep a tight gate. This is the covariance-driven search of
    the reference's non-constant ``isLoopyArea``
    (src/mapGraph/MapGraph.cpp:995-1032, cov mode at 1012-1017) with the
    chained covariance replaced by a linear drift-rate model
    ``r = r0 + rate·gap`` clipped to ``rmax``.
    """
    ii = jnp.arange(n, dtype=dtype)
    gap = jnp.abs(ii[None, :] - ii[:, None])
    return jnp.clip(r0 + rate * gap, r0, rmax)


def gate_matrix(
    centers: Array,
    bbox_lo: Array | None = None,
    bbox_hi: Array | None = None,
    radius: float | Array = LOOP_RADIUS,
    min_gap: int = MIN_INDEX_GAP,
    overlap_min: float | None = BBOX_OVERLAP_MIN,
) -> Array:
    """``[A, A]`` bool: entry (i, j) true iff anchors i<j are loop-closure
    candidates under the distance + bbox-overlap gates.

    ``radius`` may be a scalar or a per-pair ``[A, A]`` matrix (see
    :func:`drift_radius_matrix`). With a drift-sized radius the estimated
    bboxes of true revisits may not overlap at all, so the overlap test
    dilates each box by the per-pair radius; pass ``overlap_min=None``
    to skip the overlap gate entirely.
    """
    a = centers.shape[0]
    radius = jnp.asarray(radius, centers.dtype)
    d2 = jnp.sum((centers[:, None, :] - centers[None, :, :]) ** 2, axis=-1)
    near = d2 <= radius * radius

    ii = jnp.arange(a)
    ordered = (ii[None, :] - ii[:, None]) > min_gap   # j - i > gap
    gate = near & ordered

    if overlap_min is not None and bbox_lo is not None:
        dil = jnp.broadcast_to(radius, (a, a))[..., None]
        lo_i, hi_i = bbox_lo[:, None, :], bbox_hi[:, None, :]
        lo_j, hi_j = bbox_lo[None, :, :], bbox_hi[None, :, :]
        inter_lo = jnp.maximum(lo_i, lo_j) - 0.5 * dil
        inter_hi = jnp.minimum(hi_i, hi_j) + 0.5 * dil
        inter = jnp.clip(inter_hi - inter_lo, 0.0)
        inter_area = inter[..., 0] * inter[..., 1]
        area_j = jnp.prod(jnp.clip(hi_j - lo_j, 1e-6), axis=-1)
        gate = gate & ((inter_area / area_j) >= overlap_min)
    return gate


def select_candidates(
    gate: Array,
    centers: Array,
    max_pairs: int,
    radius: Array | None = None,
    per_dst: int = 0,
    boost: Array | None = None,
) -> LoopCandidates:
    """Pick up to ``max_pairs`` gated pairs, fixed shape.

    Pairs are ranked by center distance normalized by the per-pair
    search ``radius`` (a Mahalanobis-style score: a pair 6 m apart after
    a 300-step excursion outranks one 3 m apart after 30 steps). With
    ``per_dst > 0`` each destination anchor keeps at most that many
    source candidates before the global cut — spreading the fixed
    verification budget across the whole trajectory instead of letting
    one dense revisit area monopolize it (the reference's counterpart
    is its last-3 + random sampling, MapGraph.cpp:2063-2099).
    """
    a = gate.shape[0]
    d2 = jnp.sum((centers[:, None, :] - centers[None, :, :]) ** 2, axis=-1)
    if radius is not None:
        norm = jnp.sqrt(d2) / jnp.maximum(radius, 1e-6)
    else:
        norm = d2
    if boost is not None:
        # Coverage-aware priority: callers add a bonus for pairs that
        # would constrain so-far-unconstrained trajectory regions, so
        # the fixed verification budget binds every segment instead of
        # re-polishing well-covered ones.
        norm = norm - boost
    score = jnp.where(gate, -norm, -jnp.inf)

    if per_dst > 0:
        score_t = score.T                                  # [dst, src]
        kth = jax.lax.top_k(score_t, min(per_dst, a))[0][:, -1]  # [dst]
        keep = score_t >= kth[:, None]
        score = jnp.where(keep.T, score, -jnp.inf)

    vals, idx = jax.lax.top_k(score.reshape(-1), max_pairs)
    valid = jnp.isfinite(vals)
    return LoopCandidates(src=idx // a, dst=idx % a, valid=valid)


def verify_loops(
    model: LaserModel,
    anchor_scans: Scan,
    anchor_poses: Array,
    cand: LoopCandidates,
    max_corr: float | Array = 1.5,
) -> VerifiedLoops:
    """Batch-verify candidates with free-form trimmed point ICP (the
    zhicp/MRPT role), initializing from the current pose estimates. All
    candidates verify in one vmap, shardable across chips."""
    ref = jax.tree.map(lambda x: x[cand.src], anchor_scans)
    cur = jax.tree.map(lambda x: x[cand.dst], anchor_scans)
    init = se2.relative(anchor_poses[cand.src], anchor_poses[cand.dst])

    ref_pts, ref_ok = jax.vmap(lambda s: scan_to_points(model, s))(ref)
    cur_pts, cur_ok = jax.vmap(lambda s: scan_to_points(model, s))(cur)
    res = jax.vmap(
        lambda rp, ro, cp, co, p: match_icp_points(
            rp, ro, cp, co, p, max_corr=max_corr
        )
    )(ref_pts, ref_ok, cur_pts, cur_ok, init)

    # Reciprocal check: match the pair in the opposite direction too and
    # require the two estimates to invert each other. Perceptually
    # aliased matches (repeated corridors/rooms) rarely reciprocate —
    # this is the batched counterpart of the reference's neighbor
    # consensus validVerify (MapGraph.cpp:1932-1958).
    bwd = jax.vmap(
        lambda cp, co, rp, ro, p: match_icp_points(
            cp, co, rp, ro, p, max_corr=max_corr
        )
    )(cur_pts, cur_ok, ref_pts, ref_ok, se2.inverse(init))
    cycle = se2.compose(res.pose, bwd.pose)
    reciprocal = (jnp.linalg.norm(cycle[:, :2], axis=-1) < 0.10) & (
        jnp.abs(se2.normalize_angle(cycle[:, 2])) < 0.035
    )

    delta = se2.relative(init, res.pose)
    small_corr = (jnp.linalg.norm(delta[:, :2], axis=-1) < MAX_TRANSFORM_DELTA) & (
        jnp.abs(se2.normalize_angle(delta[:, 2])) < MAX_ANGLE_DELTA
    )
    accept = (
        cand.valid
        & ~res.fail
        & ~bwd.fail
        & reciprocal
        & small_corr
        & (res.goodness >= QUALITY_MIN)
        & (res.err < MATCH_ERR_MAX)
    )
    rel = jnp.where(accept[:, None], jnp.nan_to_num(res.pose), 0.0)
    return VerifiedLoops(
        src=cand.src, dst=cand.dst, rel=rel, quality=res.goodness, accept=accept
    )


def consistency_prune(loops: VerifiedLoops, anchor_poses: Array) -> Array:
    """Keep loops consistent with the majority. Each accepted loop implies
    a pose correction ``c = (pose_src ⊕ rel) ⊖-ish pose_dst``; loops whose
    implied corrections agree (within 1 m / 0.3 rad) vote for each other,
    and loops with below-median votes are dropped — the batched analog of
    deleteMisMatch's pairwise-distance pruning (MapGraph.cpp:169-223)."""
    pred_dst = se2.compose(anchor_poses[loops.src], loops.rel)
    corr = jnp.concatenate(
        [
            pred_dst[:, :2] - anchor_poses[loops.dst, :2],
            se2.normalize_angle(pred_dst[:, 2:3] - anchor_poses[loops.dst, 2:3]),
        ],
        axis=-1,
    )
    dt = jnp.linalg.norm(corr[:, None, :2] - corr[None, :, :2], axis=-1)
    da = jnp.abs(se2.normalize_angle(corr[:, None, 2] - corr[None, :, 2]))
    agree = (dt < 1.0) & (da < 0.3)
    agree = agree & loops.accept[None, :] & loops.accept[:, None]
    votes = jnp.sum(agree, axis=1)
    n_acc = jnp.sum(loops.accept)
    # Require a small absolute cluster (self + 2 supporters). Corrections
    # are drift-local: loops closing *different* revisit events carry
    # different (all correct) corrections, so a fraction-of-total
    # threshold would wrongly erase every cluster smaller than the
    # biggest one; an absolute quorum keeps all real clusters while
    # still dropping isolated spurious matches.
    min_votes = jnp.minimum(n_acc, 3)
    return loops.accept & (votes >= min_votes)


def pcm_cycle_errors(
    src: Array, dst: Array, rel: Array, odo_anchor_poses: Array
) -> tuple[Array, Array, Array, Array]:
    """Pairwise loop-vs-loop cycle errors through the raw odometry:
    ``(et [C,C], er [C,C], gap_i, gap_j)`` where entry (a, b) is the
    discrepancy of measuring loop b as ``odo(i_b→i_a) ⊕ L_a ⊕
    odo(j_a→j_b)`` (the PCM consistency kernel, Mangelson et al.)."""
    odo_ii = se2.relative(
        odo_anchor_poses[src[:, None]], odo_anchor_poses[src[None, :]]
    )                                                   # [C, C, 3] i_a→i_b
    odo_jj = se2.relative(
        odo_anchor_poses[dst[None, :]], odo_anchor_poses[dst[:, None]]
    )                                                   # [C, C, 3] j_b→j_a
    # L_b_pred[a, b] = inv(odo(i_a→i_b)) ⊕ L_a ⊕ odo(j_a→j_b)
    la = jnp.broadcast_to(rel[:, None, :], odo_ii.shape)
    pred = se2.compose(
        se2.compose(se2.inverse(odo_ii), la), se2.inverse(odo_jj)
    )
    e = se2.relative(jnp.broadcast_to(rel[None, :, :], pred.shape), pred)
    et = jnp.linalg.norm(e[..., :2], axis=-1)
    er = jnp.abs(se2.normalize_angle(e[..., 2]))
    gap_i = jnp.abs(src[:, None] - src[None, :]).astype(et.dtype)
    gap_j = jnp.abs(dst[:, None] - dst[None, :]).astype(et.dtype)
    return et, er, gap_i, gap_j


def pcm_prune(
    loops: VerifiedLoops,
    odo_anchor_poses: Array,
    base_t: float = 0.3,
    rate_t: float = 0.25,
    cap_t: float = 2.0,
    base_r: float = 0.15,
    rate_r: float = 0.03,
    cap_r: float = 0.4,
    votes_min: int = 3,
    conflict_k: int = 0,
    conflict_t: float = 3.0,
) -> Array:
    """Pairwise-consistent-measurement pruning (PCM, Mangelson et al.)
    with drift-scaled, capped gates and an absolute vote quorum.

    Two loops ``a=(i_a→j_a)``, ``b=(i_b→j_b)`` are checked through the
    odometry cycle ``L_b ≈ odo(i_b→i_a) ⊕ L_a ⊕ odo(j_a→j_b)``; the
    acceptance threshold grows with the square root of the connecting
    odometry path length (random-walk drift model) and is **capped**: an
    uncapped linear model reaches tens of meters at long gaps and
    rendered the check vacuous (measured on intel-lab: a 23 m-wrong loop
    passed). A loop survives with ``votes_min`` supporters (its own
    cluster — each real revisit produces several mutually consistent
    loops), so isolated gross outliers die while distant true clusters
    — which can NEVER validate each other through drift-sized odometry
    cycles, so no seed/max-clique structure exists to find — keep
    themselves alive (measured: 327/329 correct kept, the 23 m outlier
    and 2 others killed; seed-neighborhood variants kept only 157/329).
    This covers the role of the reference's deleteMisMatch + validVerify
    neighbor consensus (MapGraph.cpp:169-223, 1932-1958) with an
    explicit noise model.

    A solitary verified loop still survives (``votes ≥ min(n_acc,
    votes_min)``, ADVICE r2): the strict verification gates and the
    post-solve residual trim remain the lone-false-positive guards.

    ``odo_anchor_poses`` must be the *raw odometry* anchor chain (the
    actual measurements), not the current optimized estimates.
    """
    src = loops.src
    dst = loops.dst
    et, er, gap_i, gap_j = pcm_cycle_errors(
        src, dst, loops.rel, odo_anchor_poses
    )
    g = jnp.sqrt(gap_i + gap_j)
    thr_t = jnp.minimum(base_t + rate_t * g, cap_t)
    thr_r = jnp.minimum(base_r + rate_r * g, cap_r)

    ok = loops.accept
    consistent = (et <= thr_t) & (er <= thr_r) & ok[:, None] & ok[None, :]
    votes = jnp.sum(consistent, axis=1)
    n_acc = jnp.sum(ok)
    keep = ok & (votes >= jnp.minimum(n_acc, votes_min))

    # Local conflict resolution: two loops whose endpoints nearly
    # coincide (both index gaps ≤ conflict_k) measure the SAME revisit —
    # the odometry connecting them is short and reliable, so a
    # *meters-sized* cycle disagreement (> conflict_t, i.e. different
    # alignment basins, not measurement noise) proves one of them wrong.
    # The vote quorum above cannot separate them: a perceptual-alias
    # cluster (parallel corridors offset by a repeating bay) is
    # internally consistent and votes for itself (mit-cscail grew four
    # mutually-supporting 6-8 m wrong loops around anchors (28-32 →
    # 78-88) exactly this way, next to the true cluster for the same
    # revisit). Let the basins fight: a loop outvoted by its gross
    # local conflicters dies. conflict_t is deliberately far above
    # thr_t — "sloppy-correct" loops (0.7-1.2 m off on low-overlap
    # cross-heading revisits) are net-positive constraints (measured:
    # oracle-removing every >0.5 m loop from the mit bank WORSENS ATE
    # 1.29 → 1.57) and must not be treated as conflicting.
    if conflict_k > 0:
        gi_small = gap_i <= conflict_k
        gj_small = gap_j <= conflict_k
        local = gi_small & gj_small & ok[:, None] & ok[None, :]
        support = jnp.sum(consistent & local, axis=1)   # includes self
        conflict = jnp.sum(local & (et > conflict_t), axis=1)
        keep = keep & (support >= conflict)
    # Degenerate case: nothing accepted → keep stays all-false.
    return keep


def _chunked_vmap(fn, args: tuple, chunk: int):
    """``vmap(fn)(*args)`` evaluated ``chunk`` rows at a time with
    ``lax.map`` — bounds live memory when the batch is large (hundreds
    of loop candidates × submap point clouds)."""
    c = args[0].shape[0]
    if chunk <= 0 or c % chunk != 0:
        return jax.vmap(fn)(*args)
    resh = jax.tree.map(
        lambda x: x.reshape((c // chunk, chunk) + x.shape[1:]), args
    )
    out = jax.lax.map(lambda a: jax.vmap(fn)(*a), resh)
    return jax.tree.map(lambda x: x.reshape((c,) + x.shape[2:]), out)


def verify_loops_correlative(
    submaps,
    anchor_poses: Array,
    cand: LoopCandidates,
    cand_radius: Array | None = None,
    wide_pts: Array | None = None,
    wide_ok: Array | None = None,
    search_xy: float = 5.0,
    search_theta: float = float(jnp.pi),
    n_theta: int = 72,
    coarse_res: float = 0.3,
    coarse_points: int = 192,
    n_peaks: int = 8,
    chunk: int = 32,
    coarse_chunk: int = 16,
    coarse_min_score: float = 0.2,
    quality_min: float = 0.6,
    err_max: float = 0.05,
    cycle_t_max: float = 0.25,
    cycle_r_max: float = 0.1,
    strong_goodness: float = 0.8,
    strong_err: float = 0.03,
    identity_init: bool = False,
) -> VerifiedLoops:
    """Init-free loop verification: exhaustive coarse correlative search
    against a *wide* reference cloud, per-peak ICP polish, reciprocal
    check.

    This is the stage the round-1 pipeline lacked: ICP-only
    verification needs the odometry guess inside its convergence basin,
    but on a long loop (intel-lab) the guess is drift-sized (tens of
    meters) and every true revisit fails to verify. Design (each point
    validated empirically against intel-lab ground truth):

    - the search is exhaustive over ``±search_xy × ±search_theta``
      centered on **identity** when ``identity_init`` — a true revisit
      has a small relative pose by definition even when the estimated
      poses are 20 m apart (Olson-style correlative matching; the
      reference's init-free role is RANSAC feature matching,
      FlirterNode.cpp:394-423);
    - **both sides are wide** for the coarse score and triage: the
      reference side is the ``wide_pts`` local context
      (:func:`..graph.submap.wide_clouds`, ±wing submaps) and the query
      side is the *dst* anchor's wide cloud — measured on 256 GT-true
      intel-lab revisits, narrow-vs-narrow leaves the true alignment
      out of the top-8 peaks on 34% of pairs, narrow-vs-wide on 27%,
      wide-vs-wide on 18%, and wide-query triage then picks the true
      peak on 97% of the pairs where it exists (find rate 62% → 79%);
      the *final* polish and its gates stay narrow-query-vs-wide-ref so
      the accepted relative pose is anchored to the dst submap proper;
    - the **top ``n_peaks`` NMS peaks** are each polished with trimmed
      point-to-segment ICP and the best gated survivor wins — argmax
      alone hands aliased corridor alignments the match;
    - acceptance is *strict* (goodness ≥ 0.5, mean err < 3 cm,
      reciprocal cycle < 8 cm/0.015 rad): measured gate separation
      between geometrically correct and wrong matches is wide
      (goodness 0.75 vs 0.28, cycle 0.01 vs 0.06), and the pose-graph
      solve wants few-and-right edges (94% precision at these values),
      not many-and-noisy (the reference gates at ICP goodness 0.8/0.45,
      MapGraph.cpp:42-43);
    - the correction vs the current estimate must fit ``cand_radius``
      (the uncertainty that proposed the pair; isBigTrafo's role,
      MapGraph.cpp:2103-2114).
    """
    ref_pts = submaps.points[cand.src]
    ref_ok = submaps.valid[cand.src]
    cur_pts = submaps.points[cand.dst]
    cur_ok = submaps.valid[cand.dst]
    if wide_pts is not None:
        refw_pts = wide_pts[cand.src]
        refw_ok = wide_ok[cand.src]
        curw_pts = wide_pts[cand.dst]
        curw_ok = wide_ok[cand.dst]
    else:
        refw_pts, refw_ok = ref_pts, ref_ok
        curw_pts, curw_ok = cur_pts, cur_ok
    odo_rel = se2.relative(anchor_poses[cand.src], anchor_poses[cand.dst])
    return verify_pairs_correlative(
        refw_pts, refw_ok, ref_pts, ref_ok,
        curw_pts, curw_ok, cur_pts, cur_ok,
        odo_rel, cand.valid, cand_radius,
        src=cand.src, dst=cand.dst,
        search_xy=search_xy, search_theta=search_theta, n_theta=n_theta,
        coarse_res=coarse_res, coarse_points=coarse_points,
        n_peaks=n_peaks, chunk=chunk,
        coarse_min_score=coarse_min_score, quality_min=quality_min,
        err_max=err_max, cycle_t_max=cycle_t_max, cycle_r_max=cycle_r_max,
        strong_goodness=strong_goodness, strong_err=strong_err,
        identity_init=identity_init,
    )


def verify_pairs_correlative(
    refw_pts: Array,
    refw_ok: Array,
    ref_pts: Array,
    ref_ok: Array,
    curw_pts: Array,
    curw_ok: Array,
    cur_pts: Array,
    cur_ok: Array,
    odo_rel: Array,
    valid: Array,
    cand_radius: Array | None = None,
    src: Array | None = None,
    dst: Array | None = None,
    search_xy: float = 5.0,
    search_theta: float = float(jnp.pi),
    n_theta: int = 72,
    coarse_res: float = 0.3,
    coarse_points: int = 192,
    n_peaks: int = 8,
    chunk: int = 32,
    coarse_min_score: float = 0.2,
    quality_min: float = 0.6,
    err_max: float = 0.05,
    cycle_t_max: float = 0.25,
    cycle_r_max: float = 0.1,
    strong_goodness: float = 0.8,
    strong_err: float = 0.03,
    identity_init: bool = False,
    triage_steps_per_nn: int = 1,
) -> VerifiedLoops:
    """Pair-level core of :func:`verify_loops_correlative`: all clouds
    already gathered per candidate ``[C, P, 2]`` / ``[C, W, 2]``. The
    compiled shape depends only on the candidate count and the
    narrow/wide point budgets — NOT on the anchor count or the laser
    beam count — so one executable serves every log, laser model, and
    growing online session, and its compile is paid once."""
    from ..ops.correlative import (
        build_likelihood_grid_points, correlative_top_peaks,
    )

    if src is None:
        src = jnp.zeros(odo_rel.shape[0], jnp.int32)
    if dst is None:
        dst = jnp.zeros(odo_rel.shape[0], jnp.int32)
    init = jnp.zeros_like(odo_rel) if identity_init else odo_rel


    pw = refw_pts.shape[1]
    pn = cur_pts.shape[1]
    stride = max(pw // coarse_points, 1)
    nstride = max(pn // coarse_points, 1)
    tri_stride = max(pw // 384, 1)

    def one(rw_p, rw_o, r_p, r_o, cw_p, cw_o, c_p, c_o, ip, orel):
        # Dual-query coarse search: the WIDE query carries long-gap
        # same-direction revisits (context disambiguates corridor
        # aliases — measured find-rate 62%→79% on intel-lab GT), but on
        # cross/opposite-heading revisits the two wide clouds share only
        # the crossing region and the wide query's out-of-overlap mass
        # buries the true peak (mit-cscail: true basin absent from the
        # top-32 on 9/12 uncovered GT-true pairs; the overlap-NORMALIZED
        # narrow query restores 6 at rank 0-1). The wide lane keeps raw
        # mean scoring: normalizing it rewards sharp low-overlap alias
        # basins between unrelated places (measured on intel-lab:
        # 20 m-wrong strict accepts binding the early uncovered span,
        # ATE 0.90 → 4.5). Both lanes score against the same ref grid.
        grid = build_likelihood_grid_points(
            rw_p, rw_o, res=coarse_res, half_extent=12.8, blur_sigma=1.0
        )
        peaks_w, scores_w = correlative_top_peaks(
            rw_p, rw_o, cw_p[::stride], cw_o[::stride], ip,
            n_peaks=n_peaks, search_xy=search_xy,
            search_theta=search_theta, n_theta=n_theta, res=coarse_res,
            overlap_norm=False, grid=grid,
        )
        peaks_n, scores_n = correlative_top_peaks(
            rw_p, rw_o, c_p[::nstride], c_o[::nstride], ip,
            n_peaks=n_peaks, search_xy=search_xy,
            search_theta=search_theta, n_theta=n_theta, res=coarse_res,
            overlap_norm=True, grid=grid,
        )
        # Triage each peak list with ITS OWN query (subsampled polish,
        # score by goodness gated on error): wide-query triage of a
        # narrow-found cross-heading peak re-dilutes exactly what the
        # narrow query recovered, and vice versa.
        tri_w = jax.vmap(
            lambda pk: match_icp_points(
                rw_p[::2], rw_o[::2], cw_p[::tri_stride], cw_o[::tri_stride],
                pk, iters=12, max_corr=4.0 * coarse_res, steps_per_nn=triage_steps_per_nn,
            )
        )(peaks_w)
        tri_n = jax.vmap(
            lambda pk: match_icp_points(
                rw_p[::2], rw_o[::2], c_p[::2], c_o[::2],
                pk, iters=12, max_corr=4.0 * coarse_res, steps_per_nn=triage_steps_per_nn,
            )
        )(peaks_n)

        def best_of(tri, peaks, scores):
            s = jnp.where(
                ~tri.fail & (tri.err < 2.0 * err_max), tri.goodness, -1.0
            )
            b = jnp.argmax(s)
            return tri.pose[b], peaks[b], scores[b], tri.goodness[b], tri.err[b]

        cand_polish = [
            best_of(tri_w, peaks_w, scores_w),
            best_of(tri_n, peaks_n, scores_n),
        ]
        # Full polish of BOTH winning basins against the wide reference
        # (narrow query, so the accepted pose anchors to the dst submap
        # proper); the gated-better forward result wins the pair.
        fwd2 = jax.vmap(
            lambda ip_: match_icp_points(
                rw_p, rw_o, c_p, c_o, ip_,
                iters=30, max_corr=4.0 * coarse_res,
            )
        )(jnp.stack([cand_polish[0][0], cand_polish[1][0]]))
        fscore = jnp.where(
            ~fwd2.fail & (fwd2.err < err_max), fwd2.goodness, -1.0
        )
        # The WIDE lane stays authoritative: whenever its polish alone
        # clears the acceptance-quality bar, take it — the narrow lane
        # exists only to rescue pairs the wide query buries (cross-
        # heading crossings), not to outvote it. Letting the lanes
        # compete by goodness re-admitted corridor slide-aliases on
        # intel-lab (narrow polishes an alias basin marginally sharper
        # than the truth's wide polish): ATE 0.90 → 4.59.
        wide_pass = (
            ~fwd2.fail[0]
            & (fwd2.err[0] < err_max)
            & (fwd2.goodness[0] >= quality_min)
        )
        # A narrow-lane rescue must also agree with the WIDE context: a
        # true crossing still shares its crossing region between the two
        # wide clouds (wide-triage goodness 0.24-0.58 measured on mit's
        # GT-true rescues).
        ctx = match_icp_points(
            rw_p[::2], rw_o[::2], cw_p[::tri_stride], cw_o[::tri_stride],
            cand_polish[1][0], iters=12, max_corr=4.0 * coarse_res,
            steps_per_nn=triage_steps_per_nn,
        )
        ctx_ok = ~ctx.fail & (ctx.goodness >= 0.2) & (
            ctx.err < 2.0 * err_max
        )
        narrow_ok = ctx_ok & ~fwd2.fail[1] & (fwd2.err[1] < err_max)
        which = jnp.where(wide_pass | ~narrow_ok, 0, jnp.argmax(fscore))
        fwd = jax.tree.map(lambda x: x[which], fwd2)
        peak = jnp.stack([cand_polish[0][1], cand_polish[1][1]])[which]
        peak_score = jnp.stack([cand_polish[0][2], cand_polish[1][2]])[which]
        tri_good = jnp.stack([cand_polish[0][3], cand_polish[1][3]])[which]
        tri_err = jnp.stack([cand_polish[0][4], cand_polish[1][4]])[which]
        # Reciprocal: the narrow src submap against the dst side's wide
        # context, from the inverse — a spurious plateau diverges, a
        # real surface alignment inverts exactly. Both legs must be
        # narrow-vs-wide: a narrow-narrow backward leg drifts on exactly
        # the partial-overlap pairs the wide reference was built for.
        bwd = match_icp_points(
            cw_p, cw_o, r_p, r_o, se2.inverse(fwd.pose),
            iters=30, max_corr=4.0 * coarse_res,
        )
        return fwd, bwd, peak, peak_score, tri_good, tri_err, which

    fwd, bwd, peak, peak_score, tri_good, tri_err, lane = _chunked_vmap(
        one,
        (refw_pts, refw_ok, ref_pts, ref_ok, curw_pts, curw_ok,
         cur_pts, cur_ok, init, odo_rel),
        chunk,
    )

    cycle = se2.compose(fwd.pose, bwd.pose)
    reciprocal = (jnp.linalg.norm(cycle[:, :2], axis=-1) < cycle_t_max) & (
        jnp.abs(se2.normalize_angle(cycle[:, 2])) < cycle_r_max
    )
    d_polish = se2.relative(peak, fwd.pose)
    near_peak = (
        jnp.linalg.norm(d_polish[:, :2], axis=-1) < 3.0 * coarse_res
    ) & (jnp.abs(se2.normalize_angle(d_polish[:, 2])) < 0.2)
    delta = se2.relative(odo_rel, fwd.pose)
    if cand_radius is None:
        rad = jnp.full(init.shape[0], jnp.inf, init.dtype)
    else:
        rad = cand_radius
    in_gate = jnp.linalg.norm(delta[:, :2], axis=-1) <= rad + 0.5

    gates = {
        "coarse_ok": peak_score >= coarse_min_score,
        "fwd_ok": ~fwd.fail,
        "bwd_ok": ~bwd.fail,
        "reciprocal": reciprocal,
        "near_peak": near_peak,
        "in_gate": in_gate,
        "quality_ok": fwd.goodness >= quality_min,
        "err_ok": fwd.err < err_max,
    }
    accept = valid
    for m in gates.values():
        accept = accept & m
    # Narrow-lane rescues NEVER reach the strict tier. On self-similar
    # buildings the narrow query mass-produces drift-confirming aliases
    # that pass every per-pair gate including reciprocity (measured on
    # intel-lab round 0: (17,234)/(21,234)/(26,234) at 15-24 m true
    # error, goodness 0.70-0.80, full gate pass — admitting them as
    # strict gave ATE 6.5-6.6 under every per-pair gating variant
    # tried). Their only safe entry is the tentative tier below, whose
    # residual-under-solution promotion is a topological check no
    # single-pair evidence can substitute for.
    accept = accept & (lane == 0)
    # Strong-accept bypass of the reciprocal gate: the backward leg
    # occasionally diverges off a *correct* alignment (measured on
    # intel-lab GT: pairs at 2 cm true error with goodness 0.93 killed
    # by a 1.5 m cycle). A forward match this sharp is beyond what
    # perceptual aliasing produces (measured wrong-match goodness ≤
    # 0.83), so it stands on its own; PCM + residual trim remain as
    # backstops.
    # The bypass is wide-lane-only: "beyond what aliasing produces" was
    # measured for wide-context matches; a narrow slide-alias can polish
    # arbitrarily sharp, so narrow-lane rescues must pass EVERY gate
    # including reciprocity.
    strong = (
        valid
        & (lane == 0)
        & gates["coarse_ok"]
        & gates["fwd_ok"]
        & gates["near_peak"]
        & gates["in_gate"]
        & (fwd.goodness >= strong_goodness)
        & (fwd.err < strong_err)
    )
    accept = accept | strong

    # Loose tier: matches that *look* correct (sharp coarse peak, tight
    # residual) but miss the strict goodness/reciprocity bar — typical
    # for genuinely low-overlap revisits (opposite-direction passes,
    # long gaps). Measured on intel-lab GT: loose-tier wrong matches are
    # 5-25 m off while correct ones are centimeters, so a residual
    # check against the current solution separates them exactly; they
    # must NOT enter the solve before that promotion.
    cyc_t = jnp.linalg.norm(cycle[:, :2], axis=-1)
    cyc_r = jnp.abs(se2.normalize_angle(cycle[:, 2]))
    tentative = (
        valid
        & ~accept
        & ~fwd.fail
        & near_peak
        & in_gate
        & (peak_score >= 0.6)
        & (fwd.goodness >= 0.35)
        & (fwd.err < 0.04)
        & (cyc_t < 0.3)
        & (cyc_r < 0.1)
    )
    rel = jnp.where(
        (accept | tentative)[:, None], jnp.nan_to_num(fwd.pose), 0.0
    )
    quality = jnp.nan_to_num(fwd.goodness)
    gates["coarse_score"] = peak_score
    gates["tri_goodness"] = tri_good      # wide-vs-wide context overlap
    gates["tri_err"] = tri_err
    gates["lane"] = lane                  # 0 = wide, 1 = narrow rescue
    gates["goodness"] = fwd.goodness
    gates["err"] = fwd.err
    gates["cycle_t"] = cyc_t
    gates["cycle_r"] = cyc_r
    gates["pose"] = fwd.pose
    return VerifiedLoops(
        src=src, dst=dst, rel=rel, quality=quality, accept=accept,
        tentative=tentative, diag=gates, cov=jnp.nan_to_num(fwd.cov),
    )


def verify_loops_features(
    model: LaserModel,
    anchor_scans: Scan,
    anchor_poses: Array,
    cand: LoopCandidates,
    seed: int = 0,
) -> VerifiedLoops:
    """Feature-RANSAC loop verification — the reference's descriptor
    path (``CMapNode::matchNodePair`` RANSAC feature matching,
    src/mapGraph/MapNode.cpp:657-698 / FlirterNode.cpp:394-423) as a
    batched alternative to :func:`verify_loops`.

    Detects + describes interest points on every anchor once (vmapped),
    then RANSAC-matches each candidate pair at once. Unlike ICP
    verification it needs no initial pose, so it also validates loops
    whose odometry guess has drifted beyond ICP's convergence basin;
    ``quality`` is the inlier fraction of the feature budget.
    """
    from ..features import describe_features, detect_features, match_features

    feats = jax.vmap(lambda s: detect_features(model, s))(anchor_scans)
    descs = jax.vmap(lambda s, f: describe_features(model, s, f))(
        anchor_scans, feats
    )

    fa = jax.tree.map(lambda x: x[cand.src], feats)
    fb = jax.tree.map(lambda x: x[cand.dst], feats)
    da = descs[cand.src]
    db = descs[cand.dst]
    keys = jax.random.split(jax.random.PRNGKey(seed), cand.src.shape[0])
    res = jax.vmap(match_features)(fa, da, fb, db, keys)

    # Gate against the current estimate like isBigTrafo (MapGraph.cpp:
    # 2103-2114) but with a wider radius: features tolerate more drift.
    init = se2.relative(anchor_poses[cand.src], anchor_poses[cand.dst])
    delta = se2.relative(init, res.pose)
    small_corr = (
        jnp.linalg.norm(delta[:, :2], axis=-1) < 2.0 * MAX_TRANSFORM_DELTA
    ) & (jnp.abs(se2.normalize_angle(delta[:, 2])) < MAX_ANGLE_DELTA)

    k = feats.valid.shape[-1]
    quality = res.n_inliers.astype(res.pose.dtype) / float(k)
    accept = cand.valid & ~res.fail & small_corr & (res.n_inliers >= 8)
    rel = jnp.where(accept[:, None], jnp.nan_to_num(res.pose), 0.0)
    return VerifiedLoops(
        src=cand.src, dst=cand.dst, rel=rel, quality=quality, accept=accept
    )
