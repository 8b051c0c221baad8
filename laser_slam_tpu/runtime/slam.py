"""Full SLAM pipelines: offline batch and online facade.

``slam_offline`` is the accelerator-first pipeline: on-device keyframe odometry
(one ``lax.scan``), then a fixed number of loop-closure rounds, each a
single jitted program — batched gating over all anchor pairs, one vmapped
verification batch, robust graph solve — followed by trajectory
re-attachment. It covers the role of the reference's 3-thread online
pipeline + backend (SURVEY §3.2: ThreadLocal1/2 + ThreadGlobal1 +
CMapGraph) in a form where every expensive step is one large batched
kernel instead of a serial loop.

The anchor spacing mirrors the reference's submap granularity
(``g_session_size`` = 10 pose nodes per MapNode, MapGraph.cpp:725), and
edge information values mirror its constants (adj=50, loop=10,
MapGraph.cpp:250-261).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import se2
from ..core.scan import LaserModel, Scan
from ..graph.loop_closure import (
    VerifiedLoops,
    consistency_prune,
    drift_radius_matrix,
    gate_matrix,
    pcm_prune,
    select_candidates,
    submap_bboxes,
    verify_loops,
)
from ..graph.place_recognition import signature_gate, submap_signatures
from ..graph.submap import (
    Submaps,
    build_submaps,
    submap_bboxes as merged_bboxes,
    verify_loops_submap,
    wide_clouds,
)
from ..graph.solve import PoseGraph, optimize, optimize_with_init
from ..ops.odometry import odometry_keyframe
from ..ops.preprocess import preprocess

Array = jnp.ndarray

INFO_ADJ = 50.0    # sequential-edge information (MapGraph.cpp:251)
INFO_LOOP = 10.0   # loop-edge information (MapGraph.cpp:252)
INFO_WEAK = 0.5    # sequential edges spanning a weak/low-overlap step
#                    (the reference's corridor value, MapGraph.cpp:253)
HINGE_WEIGHT = 1e-3  # seq-weight factor for fractured (unrecoverable)
#                    steps — the edge holds the chain together but must
#                    not resist a loop-driven block rotation


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    anchor_stride: int = 10        # g_session_size (MapGraph.cpp:725)
    max_loops: int = 512           # loop-candidate batch capacity
    rounds: int = 6                # gate→verify→optimize repetitions
    #                                (each verifies a fresh candidate
    #                                slice; accepted loops accumulate)
    loop_radius: float = 2.0       # isLoopyArea constant-cov radius [m]
    gn_iters: int = 20
    use_submaps: bool = False      # verify loops submap-vs-submap (MapNode
    #                                hierarchy) instead of scan-vs-scan
    submap_points: int = 768       # fixed point budget per submap
    # Correlative loop closing (init-free; the default pipeline).
    use_correlative: bool = True
    drift_rate: float = 0.15       # [m / anchor step] gate-radius growth
    #                                (measured p95 odometry drift on
    #                                intel-lab ≈ 0.2 m/anchor-step)
    drift_anneal: float = 0.35     # per-round decay of drift_rate
    radius_max: float = 25.0       # [m] clip of the gate radius — must
    #                                admit full-drift revisits; precision
    #                                comes from verification, not gating
    per_dst: int = 12              # candidate budget per later anchor
    search_xy: float = 5.0         # [m] identity-centered verify window
    n_theta: int = 72              # rotation samples over ±π
    coarse_res: float = 0.3        # [m] correlative grid cell. 0.2
    #                                finds ~4% more GT-true revisits
    #                                (probe_peaks) but its score-volume
    #                                conv has 128² kernels instead of
    #                                85² and compiled far longer; the
    #                                wide-query coarse+triage carries
    #                                the find-rate
    verify_chunk: int = 32         # candidates per memory chunk
    sig_per_dst: int = 6           # signature-gate candidates per anchor
    radius_max_uncov: float = 60.0 # [m] gate-radius clip for pairs that
    #                                would cover a zero-coverage anchor:
    #                                uncovered spans never benefited from
    #                                earlier solves, so their pose
    #                                estimates still carry full drift and
    #                                the annealed radius would never
    #                                reach their true revisits (measured:
    #                                anchors 10-41 of intel-lab stayed
    #                                unconstrained through all rounds)
    min_quality: float = 0.6       # ICP goodness floor on loops —
    #                                with the wide-query coarse search
    #                                and the retuned cycle gates this
    #                                measures ~97% strict precision at
    #                                78% recall-of-found on GT-true
    #                                intel-lab revisits (probe_platform)
    wing: int = 4                  # ± submaps in the wide reference cloud
    wide_points: int = 1536        # point budget of a wide cloud
    n_peaks: int = 8               # polished correlative peaks per pair
    pcm_rate: float = 0.25         # [m/√anchor-step] PCM drift tolerance
    #                                (random-walk model; see pcm_prune)
    pcm_conflict_k: int = 0        # local-conflict window (anchor steps)
    #                                for same-revisit basin fights in
    #                                pcm_prune; 0 disables. Measured on
    #                                mit-cscail: killing even the 6-8 m
    #                                aliased accepts WORSENS ATE (1.35 →
    #                                1.39 at k=6; the oracle that removes
    #                                every >0.5 m loop gives 1.57) — on
    #                                loop-starved logs imprecise
    #                                constraints beat none, so the
    #                                default keeps the fight off and
    #                                relies on DCS + residual trim.
    trim_residual_t: float = 1.0   # [m] post-solve loop-residual trim
    trim_residual_r: float = 0.3   # [rad]
    promote_residual_t: float = 0.7  # [m] tentative-loop promotion gate
    promote_residual_r: float = 0.2  # [rad]
    promote_anchored_t: float = 3.0  # [m] residual bound for ANCHORED
    #                                tentatives (odometry-cycle-
    #                                consistent with ≥2 strict loops):
    #                                drift-sized, since such loops are
    #                                allowed to correct a still-drifted
    #                                span rather than merely confirm a
    #                                converged one
    promote_anchored_r: float = 0.3  # [rad]
    promote_tentative: bool = True   # unlock loose-tier loops that are
    #                                (a) odometry-cycle-consistent with
    #                                ≥2 active strict loops (ANCHORED —
    #                                see _solve_with_bank) and (b) within
    #                                a residual bound of the solved
    #                                estimate. Residual-only promotion
    #                                (r3) promoted exactly the drift-
    #                                consistent wrong tentatives and was
    #                                shipped off (measured 4.27 vs 3.95
    #                                on the r3 intel bank; 1.48 vs 1.26
    #                                on r5 mit-cscail); the anchored form
    #                                measures intel 0.859 (=), fr079
    #                                0.206 (=, promoting ~120 of its 135
    #                                GT-correct tentatives), mit-cscail
    #                                1.18 vs 1.26 — the narrow-lane
    #                                cross-heading rescues only activate
    #                                through this path
    fast_triage: bool = False      # reuse each ICP correspondence
    #                                search for 2 pose updates in the
    #                                verification TRIAGE stage (the
    #                                [N,M] NN pass is the bulk of
    #                                per-pair ICP cost; ops/icp_points.py
    #                                steps_per_nn). Its ATE cost on the
    #                                real logs: intel 0.859→0.865,
    #                                mit-cscail 1.182→1.239 (triage
    #                                basin flicker on marginal pairs) —
    #                                an option for latency-critical
    #                                deployments, OFF by default because
    #                                the offline accuracy bar comes
    #                                first. Its time saving on the GPU
    #                                is not measured.
    #                                (Reusing correspondences in the
    #                                FULL polish as well measured
    #                                0.859→0.927; gating on fresh-tail
    #                                metrics after a stale bulk measured
    #                                ATE 8.7 — stale dynamics land wrong
    #                                pairs in sharper basins that then
    #                                pass the strong gate.)
    cov_rounds: int = 2            # trailing coverage-focused waves:
    #                                the whole candidate budget goes to
    #                                pairs touching zero-coverage anchors
    bank_cap: int = 0              # loop-bank capacity (0 ⇒ max_loops).
    #                                Online/incremental sessions verify
    #                                far more short-gap local pairs than
    #                                the offline wave schedule, and at
    #                                cap=max_loops those high-quality
    #                                local matches evict the long-gap
    #                                global constraints (measured on the
    #                                intel-lab loopback: correct-loop
    #                                gap median 55 vs offline 125, 28
    #                                anchors losing all correct
    #                                coverage, ATE 6.5); the incremental
    #                                backend doubles the bank instead
    weak_seq_weight: float = 1.0   # seq-edge weight factor on "weak"
    #                                (low-overlap deep-fallback) steps.
    #                                r3 used the reference's corridor
    #                                value (INFO_WEAK/INFO_ADJ = 0.01) —
    #                                measured to be the mechanism that
    #                                bent fr079 and mit-cscail: the weak
    #                                flag fires on ~half of all edges
    #                                (68/145 fr079, 35/104 mit) whose
    #                                actual odometry error is identical
    #                                to normal edges (median 0.065 vs
    #                                0.062 m on fr079), and the 100×
    #                                softer chain lets aliased loops
    #                                fold it. Replay on the r3 banks
    #                                (tools/exp/weak_edge_ablate.py):
    #                                fr079 5.85→0.25, mit 2.66→1.30,
    #                                intel 0.84→0.86. Fractured edges
    #                                keep the true hinge weight.
    use_censi_info: bool = True    # per-loop information from the polish
    #                                ICP's Censi covariance (normalized so
    #                                the median loop keeps INFO_LOOP),
    #                                instead of INFO_LOOP × quality.
    #                                ATE on the real logs (diag_slam
    #                                --censi vs r4 defaults): intel
    #                                0.845→0.831,
    #                                fr079 0.228→0.205, mit 1.322→1.243 —
    #                                better on all three logs (r3 shipped
    #                                this dormant; VERDICT r3 #7)


class SlamResult(NamedTuple):
    poses: Array          # [T, 3] optimized trajectory
    odo_poses: Array      # [T, 3] raw odometry trajectory
    anchor_idx: Array     # [A] scan indices of graph vertices
    n_loops: Array        # [] accepted loop edges (last round)
    chi2: Array           # [] final graph chi²


def _loop_round(
    model: LaserModel,
    cfg: SlamConfig,
    anchor_scans: Scan,
    anchor_poses: Array,
    rel_seq: Array,
    radius: Array | float | None = None,
    seq_weight: Array | None = None,
    submaps: Submaps | None = None,
):
    """One gate→verify→prune→solve round over anchors; returns updated
    anchor poses and the number of accepted loops. ``radius`` may be a
    traced scalar so the compiled round is reusable across rounds with
    an escalating search radius. ``seq_weight [A-1]`` scales sequential
    edge information (weak odometry intervals get INFO_WEAK/INFO_ADJ).
    With ``submaps``, gating and verification run on the merged
    keyframe-group clouds (the MapNode hierarchy) instead of single
    anchor scans."""
    if radius is None:
        radius = cfg.loop_radius
    if submaps is not None:
        bbox_lo, bbox_hi = merged_bboxes(submaps, anchor_poses)
    else:
        bbox_lo, bbox_hi = submap_bboxes(model, anchor_scans, anchor_poses)
    gate = gate_matrix(anchor_poses[:, :2], bbox_lo, bbox_hi, radius=radius)
    cand = select_candidates(gate, anchor_poses[:, :2], cfg.max_loops)
    if submaps is not None:
        loops = verify_loops_submap(
            submaps, anchor_poses, cand, max_corr=radius
        )
    else:
        loops = verify_loops(
            model, anchor_scans, anchor_poses, cand, max_corr=radius
        )
    keep = consistency_prune(loops, anchor_poses)

    a = anchor_poses.shape[0]
    seq_i = jnp.arange(a - 1, dtype=jnp.int32)
    seq_j = seq_i + 1
    eye = jnp.eye(3, dtype=anchor_poses.dtype)
    if seq_weight is None:
        seq_weight = jnp.ones(a - 1, anchor_poses.dtype)

    i_all = jnp.concatenate([seq_i, loops.src.astype(jnp.int32)])
    j_all = jnp.concatenate([seq_j, loops.dst.astype(jnp.int32)])
    meas = jnp.concatenate([rel_seq, loops.rel], axis=0)
    info = jnp.concatenate(
        [
            jnp.tile(eye[None] * INFO_ADJ, (a - 1, 1, 1))
            * seq_weight[:, None, None],
            jnp.tile(eye[None] * INFO_LOOP, (cfg.max_loops, 1, 1))
            * loops.quality[:, None, None],
        ],
        axis=0,
    )
    active = jnp.concatenate([jnp.ones(a - 1, bool), keep])
    kernel = jnp.concatenate(
        [
            jnp.zeros(a - 1, jnp.int32),                 # seq: Huber
            jnp.ones(cfg.max_loops, jnp.int32),          # loops: DCS
        ]
    )

    g = PoseGraph(
        poses=anchor_poses,
        v_active=jnp.ones(a, bool),
        i=i_all,
        j=j_all,
        meas=meas,
        info=info,
        e_active=active,
        kernel=kernel,
    )
    g_opt, chi = optimize(g, cfg.gn_iters)
    return g_opt.poses, jnp.sum(keep), chi


def _propose(
    cfg: SlamConfig,
    anchor_poses: Array,
    rate: Array,
    sig_gate: Array,
    tried: Array,
    coverage: Array,
    focus_uncov: Array | bool = False,
    rate0: Array | None = None,
):
    """Candidate proposal only (the gating half of
    :func:`_propose_and_verify`): drift-aware pose gate ∪ appearance
    gate, minus already-tried pairs, coverage-boosted selection. Returns
    ``(cand, trust [C], tried_new)`` — verification runs separately in
    host-driven chunks so each compiled device program stays small and
    reusable."""
    a = anchor_poses.shape[0]
    dtype = anchor_poses.dtype
    centers = anchor_poses[:, :2]

    rad = drift_radius_matrix(
        a, cfg.loop_radius, rate, cfg.radius_max, dtype
    )
    uncov = coverage == 0
    pair_uncov = uncov[:, None] | uncov[None, :]
    if rate0 is None:
        rate0 = jnp.asarray(cfg.drift_rate, dtype)
    rad0 = drift_radius_matrix(
        a, cfg.loop_radius, rate0, cfg.radius_max_uncov, dtype
    )
    rad = jnp.where(pair_uncov, jnp.maximum(rad, rad0), rad)
    pose_gate = gate_matrix(
        centers, radius=rad, min_gap=5, overlap_min=None
    )
    gate = (pose_gate | sig_gate) & ~tried
    # Coverage-focused waves (the trailing cov_rounds): spend the WHOLE
    # candidate budget on pairs that would bind an uncovered anchor.
    # In the mixed waves these pairs compete with thousands of easy
    # re-verifications around well-covered revisits and lose — measured
    # on intel-lab, 86 of 112 still-uncovered anchors had GT-true
    # revisit pairs that verification would have accepted (59% find,
    # 95% precision) but that were never proposed.
    gate = gate & jnp.where(
        jnp.asarray(focus_uncov), pair_uncov, jnp.ones_like(pair_uncov)
    )
    boost = 0.5 * pair_uncov.astype(dtype)
    cand = select_candidates(
        gate, centers, cfg.max_loops, radius=rad, per_dst=cfg.per_dst,
        boost=boost,
    )
    gap = jnp.abs(cand.dst - cand.src).astype(dtype)
    cand_uncov = uncov[cand.src] | uncov[cand.dst]
    trust_rate = jnp.where(cand_uncov, rate0, rate)
    trust = cfg.loop_radius + trust_rate * gap
    tried_new = tried.at[cand.src, cand.dst].set(
        tried[cand.src, cand.dst] | cand.valid
    )
    return cand, trust, tried_new


def _verify_chunk(
    cfg: SlamConfig,
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
    trust: Array,
):
    """Verify one fixed-size chunk of candidates with pre-gathered
    clouds. The compiled shape depends only on the chunk size and the
    narrow/wide point budgets — not the anchor count or laser beam
    count — so ONE executable serves every log, laser model, and
    growing online session."""
    from ..graph.loop_closure import verify_pairs_correlative

    return verify_pairs_correlative(
        refw_pts, refw_ok, ref_pts, ref_ok,
        curw_pts, curw_ok, cur_pts, cur_ok,
        odo_rel, valid, cand_radius=trust,
        search_xy=cfg.search_xy,
        search_theta=float(jnp.pi),
        n_theta=cfg.n_theta,
        coarse_res=cfg.coarse_res,
        n_peaks=cfg.n_peaks,
        chunk=0,
        quality_min=cfg.min_quality,
        identity_init=True,
        triage_steps_per_nn=2 if cfg.fast_triage else 1,
    )


def _solve_with_bank(
    cfg: SlamConfig,
    anchor_poses: Array,
    odo_anchor_poses: Array,
    rel_seq: Array,
    seq_weight: Array,
    bank_src: Array,
    bank_dst: Array,
    bank_rel: Array,
    bank_quality: Array,
    bank_active: Array,
    bank_strict: Array,
    bank_cov: Array | None = None,
):
    """Robust solve over the sequential chain + the accumulated loop
    bank: PCM pruning (drift-scaled mutual consistency through the raw
    odometry), tentative-loop promotion, LAGO linear initialization, LM
    with Huber/DCS kernels, then one residual-trim + re-solve pass.

    Two complementary residual mechanisms act around the solves:

    - **trim** removes strict loops whose measurement disagrees with the
      first solution: with ~90%+ of strict loops correct the first
      solution is mostly right, so a grossly false loop (perceptual
      alias, typically 10-25 m wrong) shows a huge residual and is
      deactivated. PCM alone cannot make this separation (an aliased
      cluster stays self-consistent under drift-scaled thresholds), and
      DCS only downweights — it cannot un-bend LAGO's linear stage.
    - **promotion** adds loose-tier loops whose residual under the
      current estimate is small: correct tentative matches sit within
      centimeters of a near-correct solution while wrong ones are
      meters off (measured 36-correct / 3-wrong at 0.7 m on intel-lab),
      so each solve unlocks the low-overlap loops — exactly the long-gap
      constraints the strict gates are too conservative to pass."""
    a = anchor_poses.shape[0]
    dtype = anchor_poses.dtype
    bank = VerifiedLoops(
        src=bank_src, dst=bank_dst, rel=bank_rel, quality=bank_quality,
        accept=bank_active,
    )
    keep = pcm_prune(bank, odo_anchor_poses, rate_t=cfg.pcm_rate,
                     conflict_k=cfg.pcm_conflict_k)

    # Anchored promotion support: a tentative may only ever promote when
    # it is ALSO odometry-cycle-consistent (PCM kernel) with at least
    # two active strict loops — topological support that does not
    # depend on the current estimate. The residual-only gate promotes
    # exactly the drift-consistent wrong tentatives in still-drifted
    # regions (their residual is ~0 by construction) while the true
    # rescues there sit meters off the unconverged estimate (measured
    # on mit-cscail: residual-only promotion 1.48 vs 1.26 baseline).
    from ..graph.loop_closure import pcm_cycle_errors

    et_b, er_b, gi_b, gj_b = pcm_cycle_errors(
        bank_src, bank_dst, bank_rel, odo_anchor_poses
    )
    g_b = jnp.sqrt(gi_b + gj_b)
    thr_tb = jnp.minimum(0.3 + cfg.pcm_rate * g_b, 2.0)
    thr_rb = jnp.minimum(0.15 + 0.03 * g_b, 0.4)
    cons_b = (et_b <= thr_tb) & (er_b <= thr_rb)
    strict_on = bank_active & bank_strict
    anchored = (
        jnp.sum(cons_b & strict_on[None, :], axis=1) >= 2
    )

    def promoted(poses):
        pred = se2.relative(poses[bank_src], poses[bank_dst])
        d = se2.relative(bank_rel, pred)
        dt = jnp.linalg.norm(d[:, :2], axis=-1)
        dr = jnp.abs(se2.normalize_angle(d[:, 2]))
        near = (dt < cfg.promote_residual_t) & (dr < cfg.promote_residual_r)
        # Anchored tentatives may CORRECT the estimate (their residual
        # is the local drift, not an error signal), so their residual
        # bound is drift-sized rather than convergence-sized.
        near_anchored = (dt < cfg.promote_anchored_t) & (
            dr < cfg.promote_anchored_r
        )
        return bank_active & ~bank_strict & anchored & (
            near | near_anchored
        )

    # Strict loops only for the first solve: promotion under a still-
    # drifted estimate admits exactly the drift-consistent (wrong)
    # tentatives and anchors the drift (measured: ATE 9.8 vs 6.2 when
    # promoting pre-solve on intel-lab).
    keep = keep & bank_strict

    seq_i = jnp.arange(a - 1, dtype=jnp.int32)
    eye = jnp.eye(3, dtype=dtype)
    i_all = jnp.concatenate([seq_i, bank_src.astype(jnp.int32)])
    j_all = jnp.concatenate([seq_i + 1, bank_dst.astype(jnp.int32)])
    meas = jnp.concatenate([rel_seq, bank_rel], axis=0)
    if cfg.use_censi_info and bank_cov is not None:
        # Per-loop information from the matcher covariance, normalized
        # so the *median* active loop carries INFO_LOOP: raw Censi info
        # (~1e5 for a 500-point match at 2 cm residual) would let DCS
        # annihilate every drift-sized residual before the solve can
        # close it, so only the relative weighting is kept.
        w = jnp.linalg.inv(
            bank_cov + 1e-6 * jnp.eye(3, dtype=dtype)[None]
        )
        tr = 0.5 * (w[:, 0, 0] + w[:, 1, 1])
        tr_act = jnp.where(bank_active, tr, jnp.nan)
        med = jnp.nanmedian(tr_act)
        scale = INFO_LOOP / jnp.maximum(med, 1e-6)
        loop_info = jnp.clip(
            w * scale, 0.0, 10.0 * INFO_LOOP
        )
        loop_info = 0.5 * (loop_info + jnp.swapaxes(loop_info, -1, -2))
    else:
        loop_info = jnp.tile(
            eye[None] * INFO_LOOP, (bank_src.shape[0], 1, 1)
        ) * jnp.clip(bank_quality, 0.0, 1.0)[:, None, None]
    info = jnp.concatenate(
        [
            jnp.tile(eye[None] * INFO_ADJ, (a - 1, 1, 1))
            * seq_weight[:, None, None],
            loop_info,
        ],
        axis=0,
    )
    active = jnp.concatenate([jnp.ones(a - 1, bool), keep])
    kernel = jnp.concatenate(
        [jnp.zeros(a - 1, jnp.int32),
         jnp.ones(bank_src.shape[0], jnp.int32)]
    )
    g = PoseGraph(
        poses=anchor_poses,
        v_active=jnp.ones(a, bool),
        i=i_all,
        j=j_all,
        meas=meas,
        info=info,
        e_active=active,
        kernel=kernel,
    )
    g_opt, chi = optimize_with_init(g, cfg.gn_iters)

    # Residual trim + promotion under the first solution, then re-solve.
    pred = se2.relative(g_opt.poses[bank_src], g_opt.poses[bank_dst])
    d = se2.relative(bank_rel, pred)
    bad = (jnp.linalg.norm(d[:, :2], axis=-1) > cfg.trim_residual_t) | (
        jnp.abs(se2.normalize_angle(d[:, 2])) > cfg.trim_residual_r
    )
    promo = promoted(g_opt.poses) if cfg.promote_tentative else (
        jnp.zeros_like(bank_strict)
    )
    keep2 = ((keep & bank_strict) | promo) & ~bad
    active2 = jnp.concatenate([jnp.ones(a - 1, bool), keep2])
    g2 = g_opt._replace(e_active=active2)
    g_opt2, chi2_ = optimize(g2, cfg.gn_iters)
    # keep2 is the loop set the final solve actually used (post PCM,
    # post residual-trim, promotions included) — exposed so diagnostics
    # and the accuracy lane can audit the SOLVED constraint set rather
    # than the raw bank (banked-but-trimmed loops never touch the
    # result; VERDICT r4 #5).
    return g_opt2.poses, jnp.sum(keep2), chi2_, keep2


def run_correlative_rounds(
    cfg: SlamConfig,
    submaps: Submaps,
    anchor_poses: Array,
    rel_seq: Array,
    seq_weight: Array,
    bank: dict | None = None,
    tried: Array | None = None,
    odo_anchor_poses: Array | None = None,
    block_id: Array | None = None,
):
    """The init-free loop-closure backend: ``cfg.rounds`` waves of
    propose→verify→bank→robust-solve over prebuilt submaps.

    Factored out of :func:`slam_offline` so the online/deployable paths
    (and replay tooling) drive the *same* machinery incrementally: pass
    ``bank``/``tried`` from a previous call to continue a session. The
    reference's counterpart is the backend loop search performed on
    every submap insert (threadGlobal1.cpp:62-128 → addMapNodeCov,
    MapGraph.cpp:1272-1484).

    Returns ``(anchor_poses, n_loops, chi, bank, tried)``.
    """
    import os
    import sys
    import time as _time

    import numpy as np

    # Per-stage timing goes to stderr only when explicitly requested
    # (diag tooling sets LASER_SLAM_TIMING=1); silent as a library.
    _verbose = bool(os.environ.get("LASER_SLAM_TIMING"))

    def _t(msg, t0):
        if _verbose:
            print(f"[slam] {msg}: {_time.perf_counter() - t0:.1f}s",
                  file=sys.stderr, flush=True)
        return _time.perf_counter()

    dtype = anchor_poses.dtype
    t0 = _time.perf_counter()
    sig_gate = jax.jit(
        lambda p, v: signature_gate(
            submap_signatures(p, v), min_gap=5, per_dst=cfg.sig_per_dst
        )
    )(submaps.points, submaps.valid)
    jax.block_until_ready(sig_gate)
    t0 = _t("signature gate", t0)
    if odo_anchor_poses is None:
        # First call of a session: the incoming estimate IS the raw
        # odometry chain (the PCM/drift reference).
        odo_anchor_poses = anchor_poses
    if block_id is None:
        block_id = jnp.zeros(submaps.points.shape[0], jnp.int32)
    wide = jax.jit(
        lambda sm, op, bid: wide_clouds(
            sm, op, wing=cfg.wing, max_points=cfg.wide_points,
            block_id=bid,
        )
    )(submaps, odo_anchor_poses, block_id)
    jax.block_until_ready(wide)
    t0 = _t("wide clouds", t0)
    # Proposal and verification are SEPARATE compiled programs, and
    # verification runs as a host loop over fixed-size chunks: one
    # monolithic propose+verify program is large and slow to compile,
    # while the per-chunk program is small and is reused across chunks,
    # rounds and logs.
    propose_fn = jax.jit(
        lambda ap, rate, sg, tr, cov, fu, r0: _propose(
            cfg, ap, rate, sg, tr, cov, fu, r0
        )
    )
    chunk_fn = jax.jit(
        lambda *a: _verify_chunk(cfg, *a)
    )

    def verify_fn(ap, rate, sm, wd, sg, tr, cov, fu=False, r0=None):
        tp = _time.perf_counter()
        if r0 is None:
            r0 = rate
        cand, trust, tr_new = propose_fn(
            ap, rate, sg, tr, cov, jnp.asarray(fu), jnp.asarray(r0)
        )
        jax.block_until_ready(cand.src)
        tp = _t("  propose", tp)
        # Host-side gather of each chunk's clouds keeps the compiled
        # chunk program independent of the anchor count (the gathers
        # themselves are tiny device ops).
        rel_all = se2.relative(ap[cand.src], ap[cand.dst])
        c = cfg.verify_chunk
        n_all = int(cand.src.shape[0])
        outs = []
        for i in range(0, n_all, c):
            sl = slice(i, i + c)
            s_, d_ = cand.src[sl], cand.dst[sl]
            outs.append(
                chunk_fn(
                    wd[0][s_], wd[1][s_], sm.points[s_], sm.valid[s_],
                    wd[0][d_], wd[1][d_], sm.points[d_], sm.valid[d_],
                    rel_all[sl], cand.valid[sl], trust[sl],
                )
            )
        # One bulk fetch of every chunk's outputs: per-chunk np.asarray
        # costs a synchronous device round-trip per field per chunk;
        # device_get batches the whole pytree after the async
        # dispatches queue.
        outs, src_np, dst_np = jax.device_get(
            (outs, cand.src, cand.dst)
        )
        tp = _t(f"  verify {n_all // c} chunks", tp)
        loops = jax.tree.map(
            lambda *xs: np.concatenate(xs), *outs
        )
        loops = loops._replace(src=src_np, dst=dst_np)
        return loops, tr_new

    solve_fn = jax.jit(
        lambda ap, op, rels, w, bs, bd, br, bq, ba, bt, bc:
        _solve_with_bank(
            cfg, ap, op, rels, w, bs, bd, br, bq, ba, bt, bc
        )
    )
    a = int(anchor_poses.shape[0])
    if tried is None:
        tried = jnp.zeros((a, a), bool)
    cap = cfg.bank_cap or cfg.max_loops
    if bank is None:
        bank = {
            "src": np.zeros(cap, np.int32),
            "dst": np.zeros(cap, np.int32),
            "rel": np.zeros((cap, 3), np.float32),
            "q": np.zeros(cap, np.float32),
            "act": np.zeros(cap, bool),
            "strict": np.zeros(cap, bool),
            "cov": np.tile(np.eye(3, dtype=np.float32), (cap, 1, 1)),
        }
    n_loops = jnp.asarray(0)
    chi = jnp.asarray(0.0, dtype)
    # Adaptive drift rate: cfg.drift_rate is the prior (measured on
    # intel-lab, ~0.15 m per anchor step); once the bank holds enough
    # strict loops, the p90 of their |correction| / gap re-estimates
    # the log's ACTUAL drift. fr079 drifts ~10× less than intel — with
    # the intel-tuned rate its trust radii reach 14 m at gap 80, wide
    # enough to admit perceptually-aliased corridor matches 12-18 m
    # wrong (30 of 214 strict accepts); the adaptive gate rejects them.
    rate_hat = float(cfg.drift_rate)
    rate_hat_uncov = float(cfg.drift_rate)
    odo_np = np.asarray(odo_anchor_poses)
    bid_np = np.asarray(block_id)
    for r in range(cfg.rounds + cfg.cov_rounds):
        focus = r >= cfg.rounds
        on_r = bank["act"] & bank["strict"]
        if on_r.sum() >= 20:
            orel = se2.np_relative(
                odo_np[bank["src"][on_r]], odo_np[bank["dst"][on_r]]
            )
            dd = se2.np_relative(orel, bank["rel"][on_r])
            gaps = np.maximum(
                np.abs(bank["dst"][on_r].astype(np.int64)
                       - bank["src"][on_r].astype(np.int64)), 1
            )
            per_gap = np.linalg.norm(dd[:, :2], axis=-1) / gaps
            rate_hat = float(
                np.clip(1.5 * np.percentile(per_gap, 90),
                        0.02, cfg.drift_rate)
            )
            # The UNCOVERED-pair escalation rate must come from loops
            # that actually spanned long gaps: incremental sessions
            # fill the bank with short local loops first, whose tiny
            # per-gap corrections collapse rate_hat and shrink the
            # trust radius BELOW real long-gap drift — the true global
            # revisits then fail verification once and are blacklisted
            # in `tried` forever (measured on the intel-lab loopback:
            # 28-47 anchors lost all correct coverage, ATE 6.5 vs 0.84
            # offline, whose round-0 full-budget wave closes the long
            # loops before the estimator adapts).
            long_g = gaps >= 50
            if long_g.sum() >= 10:
                rate_hat_uncov = float(
                    np.clip(1.5 * np.percentile(per_gap[long_g], 90),
                            0.02, cfg.drift_rate)
                )
            else:
                rate_hat_uncov = float(cfg.drift_rate)
        # The drift-rate anneals: once a solve has absorbed the
        # loops found so far, pose distances are trustworthy at
        # tighter radii and the budget shifts to nearby pairs.
        # Already-verified pairs are excluded, so every round spends
        # its full budget on a new slice of the candidate space;
        # accepted loops persist in the bank across rounds.
        rate = jnp.asarray(
            rate_hat * (cfg.drift_anneal ** min(r, cfg.rounds - 1)),
            dtype,
        )
        # Coverage = loops that bind an anchor to a DISTANT part of the
        # trajectory (long index gap or another fracture block) AND are
        # consistent with the current solution. Short intra-block loops
        # (gap 6-20) polish local geometry but cannot place a drifted
        # block globally, and a *wrong* loop on a still-misplaced anchor
        # must not mark it covered — both failure modes shrank the
        # search gates of exactly the anchors that most needed wide ones
        # (intel-lab anchors 13-39 sat 15 m / 90° off with cov 1-3).
        ap_np = np.asarray(anchor_poses)
        on = bank["act"] & bank["strict"]
        gapb = np.abs(
            bank["dst"].astype(np.int64) - bank["src"].astype(np.int64)
        )
        pred = se2.np_relative(ap_np[bank["src"]], ap_np[bank["dst"]])
        resid = se2.np_relative(bank["rel"], pred)
        consistent = (
            np.linalg.norm(resid[:, :2], axis=-1) < 1.0
        ) & (np.abs((resid[:, 2] + np.pi) % (2 * np.pi) - np.pi) < 0.3)
        binds = on & consistent & (
            (gapb >= 20) | (bid_np[bank["src"]] != bid_np[bank["dst"]])
        )
        cov = np.zeros(a, np.int32)
        np.add.at(cov, bank["src"][binds], 1)
        np.add.at(cov, bank["dst"][binds], 1)
        # Adaptive hinges: a fractured edge is freed (HINGE_WEIGHT) only
        # while the blocks on BOTH sides carry binding loops — a block
        # with no loops would swing on a free hinge like a pendulum
        # (measured on fr079: the never-revisited final stretch went
        # from 3.2 m odometry error to 12 m with −170° heading swings).
        # Until loops arrive, the fracture keeps corridor-grade weight:
        # drifted odometry beats no constraint at all.
        sw_np = np.array(np.asarray(seq_weight))
        # Exact-zero weights are the online backend's inactive padding
        # edges (seq_w=0 by convention) — not hinges; re-activating them
        # would chain dummy anchors to real ones (ADVICE r3).
        frac_e = (sw_np > 0) & (sw_np < 2.0 * HINGE_WEIGHT)
        if frac_e.any():
            n_blocks = int(bid_np.max()) + 1
            block_cov = np.zeros(n_blocks, np.int64)
            np.add.at(block_cov, bid_np, cov.astype(np.int64))
            lo_ok = block_cov[bid_np[np.arange(a - 1)]] >= 2
            hi_ok = block_cov[bid_np[np.arange(1, a)]] >= 2
            sw_np[frac_e & ~(lo_ok & hi_ok)] = INFO_WEAK / INFO_ADJ
        seq_weight_round = jnp.asarray(sw_np, dtype)
        t0 = _t(f"round {r} host bookkeeping", t0)
        loops, tried = verify_fn(
            anchor_poses, rate, submaps, wide, sig_gate, tried,
            jnp.asarray(cov), focus,
            r0=jnp.asarray(rate_hat_uncov, dtype),
        )
        acc = np.asarray(loops.accept)
        t0 = _t(f"round {r} verify", t0)
        # Bank both tiers: strict accepts enter the solve directly;
        # tentative matches wait in the bank until the promotion
        # residual check in _solve_with_bank unlocks them (ADVICE r2:
        # banking only `acc` made the whole promotion path dead code).
        take = acc | np.asarray(loops.tentative)
        src = np.concatenate([bank["src"][bank["act"]],
                              np.asarray(loops.src)[take]])
        dst = np.concatenate([bank["dst"][bank["act"]],
                              np.asarray(loops.dst)[take]])
        rel = np.concatenate([bank["rel"][bank["act"]],
                              np.asarray(loops.rel)[take]])
        q = np.concatenate([bank["q"][bank["act"]],
                            np.asarray(loops.quality)[take]])
        strict = np.concatenate([bank["strict"][bank["act"]],
                                 acc[take]])
        cov = np.concatenate([bank["cov"][bank["act"]],
                              np.asarray(loops.cov)[take]])
        # Strict loops outrank tentative ones when the cap binds.
        # (A long-gap bonus was tried here and REJECTED: perceptual
        # aliases are long-gap too, and boosting them cost intel-lab
        # 0.84→1.54 offline. Online sessions instead raise bank_cap —
        # see SlamConfig.bank_cap.)
        order = np.argsort(-(q + 10.0 * strict))[:cap]
        n = len(order)
        for key, val in (("src", src), ("dst", dst), ("rel", rel),
                         ("q", q), ("strict", strict), ("cov", cov)):
            bank[key][:n] = val[order]
        bank["act"][:] = False
        bank["act"][:n] = True
        anchor_poses, n_loops, chi, used = solve_fn(
            anchor_poses, odo_anchor_poses, rel_seq, seq_weight_round,
            jnp.asarray(bank["src"]), jnp.asarray(bank["dst"]),
            jnp.asarray(bank["rel"]), jnp.asarray(bank["q"]),
            jnp.asarray(bank["act"]), jnp.asarray(bank["strict"]),
            jnp.asarray(bank["cov"]),
        )
        bank["used"] = np.asarray(used)
        jax.block_until_ready(anchor_poses)
        t0 = _t(f"round {r} solve (bank={int(bank['act'].sum())})", t0)
    return anchor_poses, n_loops, chi, bank, tried


def slam_offline(
    model: LaserModel,
    ranges: Array,
    cfg: SlamConfig = SlamConfig(),
    diag: dict | None = None,
    timestamps=None,
) -> SlamResult:
    """End-to-end SLAM over a ``[T, N]`` range log.

    Host-orchestrated: the odometry chain, the loop round, and the
    re-attachment each compile once; the loop round is re-invoked
    ``cfg.rounds`` times with updated poses (same shapes → cached
    executable), keeping XLA program size independent of round count.
    """
    # _frontend is host-orchestrated (two-pass odometry) — no outer jit.
    (scans, odo_poses, anchor_idx, anchor_scans, anchor_poses, rel_seq,
     seq_weight, block_id) = _frontend(model, cfg, ranges, timestamps)

    submaps = None
    if cfg.use_submaps or cfg.use_correlative:
        submaps = jax.jit(
            lambda s, p: build_submaps(
                model, s, p, cfg.anchor_stride, cfg.submap_points
            )
        )(scans, odo_poses)

    n_loops = jnp.asarray(0)
    chi = jnp.asarray(0.0, ranges.dtype)

    if cfg.use_correlative:
        odo_anchor_poses = anchor_poses
        anchor_poses, n_loops, chi, bank, tried = run_correlative_rounds(
            cfg, submaps, anchor_poses, rel_seq, seq_weight,
            odo_anchor_poses=odo_anchor_poses, block_id=block_id,
        )
    else:
        round_fn = jax.jit(
            lambda a_scans, a_poses, rels, radius, w, sm: _loop_round(
                model, cfg, a_scans, a_poses, rels, radius, w, sm
            )
        )
        for r in range(cfg.rounds):
            # Escalating search radius: early rounds close tight,
            # reliable loops; later rounds, with drift already reduced,
            # reach farther (the role of the reference's covariance-
            # scaled isLoopyArea search, MapGraph.cpp:1012-1017).
            radius = jnp.asarray(cfg.loop_radius * (2.0**r), ranges.dtype)
            anchor_poses, n_loops, chi = round_fn(
                anchor_scans, anchor_poses, rel_seq, radius, seq_weight,
                submaps if cfg.use_submaps else None,
            )

    final = jax.jit(
        lambda ap, op: _reattach(cfg, ap, op)
    )(anchor_poses, odo_poses)

    if diag is not None and cfg.use_correlative:
        import numpy as np

        diag["bank"] = {k: np.array(v) for k, v in bank.items()}
        diag["anchor_poses"] = np.asarray(anchor_poses)
        diag["odo_anchor_poses"] = np.asarray(odo_anchor_poses)
        diag["tried"] = np.asarray(tried)
        diag["seq_weight"] = np.asarray(seq_weight)

    return SlamResult(
        poses=final,
        odo_poses=odo_poses,
        anchor_idx=anchor_idx,
        n_loops=n_loops,
        chi2=chi,
    )


def _frontend(model: LaserModel, cfg: SlamConfig, ranges: Array,
              timestamps=None):
    """Preprocess + two-pass odometry + anchor/edge derivation. Host-
    orchestrated (odometry_keyframe re-matches flagged steps in separate
    small programs) — callers must NOT wrap this in jit."""
    import os
    import sys
    import time as _time

    _verbose = bool(os.environ.get("LASER_SLAM_TIMING"))
    t0 = _time.perf_counter()
    scans = jax.jit(lambda r: preprocess(r, model))(ranges)
    jax.block_until_ready(scans.ranges)
    if _verbose:
        print(f"[slam] preprocess: {_time.perf_counter() - t0:.1f}s",
              file=sys.stderr, flush=True)
        t0 = _time.perf_counter()
    odo = odometry_keyframe(model, scans, timestamps=timestamps)
    jax.block_until_ready(odo.poses)
    if _verbose:
        print(f"[slam] odometry: {_time.perf_counter() - t0:.1f}s",
              file=sys.stderr, flush=True)
    return (scans,) + _frontend_post(
        cfg, scans, odo.poses, odo.weak, odo.fracture
    )


def _frontend_post(cfg, scans, poses, weak, fracture):
    t = scans.ranges.shape[0]
    anchor_idx = jnp.arange(0, t - (t % cfg.anchor_stride), cfg.anchor_stride)
    anchor_scans = jax.tree.map(lambda x: x[anchor_idx], scans)
    anchor_poses = poses[anchor_idx]
    rel_seq = se2.relative(anchor_poses[:-1], anchor_poses[1:])
    # An anchor interval containing any weak odometry step gets the
    # reference's corridor-grade information (INFO_WEAK vs INFO_ADJ).
    k = anchor_idx.shape[0]
    # Step t (the match scan t-1 → t) is covered by anchor edge
    # floor((t-1)/stride); sum weak flags per edge.
    edge_of_step = jnp.clip(
        (jnp.arange(t) - 1) // cfg.anchor_stride, 0, k - 2
    )
    weak_per_edge = jax.ops.segment_sum(
        weak.astype(jnp.int32), edge_of_step, num_segments=k - 1
    )
    # Fractured steps (unrecoverable matches — see OdometryResult) make
    # the spanning anchor edge a near-free hinge: its measured relative
    # rotation can be wrong by >90° (intel-lab scans 119-121), and any
    # non-negligible information there fights the loop closures that are
    # the only way to place the blocks on either side.
    frac_per_edge = jax.ops.segment_sum(
        fracture.astype(jnp.int32), edge_of_step, num_segments=k - 1
    )
    # Weak (low-overlap) steps keep near-full weight by default: the
    # weak flag measures matcher difficulty, not odometry error, and
    # softening those edges was what let wrong loops bend fr079/mit
    # (see SlamConfig.weak_seq_weight). Only true fractures hinge.
    seq_weight = jnp.where(
        frac_per_edge > 0,
        HINGE_WEIGHT,
        jnp.where(weak_per_edge > 0, cfg.weak_seq_weight, 1.0),
    )
    # Block id per anchor: increments at each fractured edge; map
    # context (wide clouds) must never merge across blocks.
    block_id = jnp.concatenate(
        [jnp.zeros(1, jnp.int32),
         jnp.cumsum((frac_per_edge > 0).astype(jnp.int32))]
    )
    return (poses, anchor_idx, anchor_scans, anchor_poses,
            rel_seq, seq_weight, block_id)


def _reattach(cfg: SlamConfig, anchor_poses: Array, odo_poses: Array) -> Array:
    t = odo_poses.shape[0]
    seg = jnp.arange(t) // cfg.anchor_stride
    seg = jnp.clip(seg, 0, anchor_poses.shape[0] - 1)
    anchors_of_t = seg * cfg.anchor_stride
    rel_to_anchor = se2.relative(odo_poses[anchors_of_t], odo_poses)
    return se2.compose(anchor_poses[seg], rel_to_anchor)
