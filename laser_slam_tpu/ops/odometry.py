"""Scan-matching odometry over a whole log, on-device.

Two drivers:

- :func:`odometry_keyframe` — the reference's ``runlogImproved`` loop
  (src/zhpsm/ZHPolar_Match.cpp:736-854) re-designed as a single
  ``lax.scan`` over time. Keyframe switching, PSM→ICP fallback, and
  frame discarding become ``lax.cond`` branches on device instead of
  C++ exceptions; the entire trajectory is produced by one compiled
  program with no host round-trips.

- :func:`odometry_pairwise` — match all consecutive pairs **in
  parallel** with ``vmap`` and integrate relative poses with an
  associative scan. This batched mode has no reference equivalent (its
  serial loop can't do it) and is what batching buys: throughput
  scales with chip count and the whole chain compiles to a handful of
  large fused kernels.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import se2
from ..core.scan import LaserModel, Scan
from .correlative import match_correlative
from .icp import match_icp
from .psm import error_index, match_psm

Array = jnp.ndarray

# Keyframe switch threshold on sqrt(err_x + err_y), meters
# (runlogImproved's 5 cm gate, ZHPolar_Match.cpp:800).
KEYFRAME_ERR_THRESH = 0.05


class OdometryResult(NamedTuple):
    poses: Array       # [T, 3] global poses (pose[0] = origin)
    switched: Array    # [T] bool — keyframe switched at this step
    discarded: Array   # [T] bool — frame dropped (all matchers failed)
    weak: Array        # [T] bool — step estimate is low-confidence
    # (deep fallback on a low-overlap pair; the backend downweights the
    # sequential edges spanning such steps, like the reference's
    # corridor information matrix, MapGraph.cpp:250-261)
    fracture: Array | None = None  # [T] bool — step estimate is
    # *unrecoverable*: every matcher failed its own confidence gate on a
    # rotationally smeared pair (intel-lab scans 119-121 whip 210° in
    # two frames; even a full ±π correlative search scores a wrong pose
    # higher than the truth there). The chain is broken at such steps —
    # downstream consumers must treat the spanning edge as a free hinge
    # and must not merge map context across it.
    rematched: Array | None = None  # [T] bool — step re-matched by the
    # exhaustive correlative search (pass 2 of odometry_keyframe)


class _OdoCarry(NamedTuple):
    ref: Scan          # current keyframe scan
    last: Scan         # previous scan
    ref_gpose: Array   # [3] global pose of keyframe
    last_gpose: Array  # [3] global pose of previous scan
    prior_rel: Array   # [3] pose of previous scan in keyframe frame


def _step(model: LaserModel, carry: _OdoCarry, cur: Scan,
          deep_inline: bool = True):
    """One odometry step. ``deep_inline`` controls whether the
    exhaustive correlative fallback runs inside this program (fine for
    the per-scan online frontends) or is deferred: with
    ``deep_inline=False`` the step only FLAGS the need (``weak``) and
    the caller re-matches flagged steps in a separate small batched
    program (:func:`_deep_rematch_chunk`): a giant scan program is the
    wrong place for a rarely-taken exhaustive search."""
    # Match against the keyframe with the previous relative pose as prior
    # (ZHPolar_Match.cpp:786-791).
    res = match_psm(model, carry.ref, cur, carry.prior_rel)
    ex, ey, _ = error_index(model, carry.last, cur, res.pose)
    err_idx = jnp.sqrt(ex + ey)
    need_switch = res.fail | (err_idx > KEYFRAME_ERR_THRESH)

    def switched_branch(_):
        # Re-match against the previous scan from a zero prior
        # (ZHPolar_Match.cpp:806-831). Where the reference falls back to
        # its polar ICP — still limited to a ±window bearing band — we
        # escalate to the correlative matcher with a full ±180° search:
        # intel-lab contains single-frame rotations up to ~148°, beyond
        # any banded matcher (the reference simply discards such frames).
        res2 = match_psm(model, carry.last, cur)
        ex2, ey2, _ = error_index(model, carry.last, cur, res2.pose)
        bad2 = res2.fail | (jnp.sqrt(ex2 + ey2) > 2.0 * KEYFRAME_ERR_THRESH)

        if not deep_inline:
            # Defer: keep the PSM estimate as a placeholder, flag the
            # step for the batched exhaustive re-match.
            return res2.pose, res2.fail, bad2, jnp.asarray(False)

        def deep_fallback(_):
            corr = match_correlative(
                model, carry.last, cur, search_xy=1.2, n_theta=72
            )
            ex3, ey3, _ = error_index(model, carry.last, cur, corr.pose)
            err3 = jnp.sqrt(ex3 + ey3)
            weak = (corr.score < 0.4) | (err3 > 3.0 * KEYFRAME_ERR_THRESH)
            # Fracture needs corroboration, same rule as the batched
            # offline path (_deep_rematch_chunk): a low-confidence
            # exhaustive match alone over-fires on legitimate
            # low-overlap corridor steps (8 false hinges on fr079);
            # require the banded estimate to *disagree* too.
            low_conf = (corr.score < 0.35) | (
                err3 > 6.0 * KEYFRAME_ERR_THRESH
            )
            d = se2.relative(res2.pose, corr.pose)
            disagree = (jnp.linalg.norm(d[:2]) > 0.5) | (
                jnp.abs(se2.normalize_angle(d[2])) > 0.3
            )
            frac = low_conf & disagree
            return corr.pose, corr.fail, weak, frac

        def keep_psm(_):
            return res2.pose, res2.fail, jnp.asarray(False), jnp.asarray(False)

        rel, fail, weak, frac = jax.lax.cond(
            bad2, deep_fallback, keep_psm, None
        )
        return rel, fail, weak, frac

    def normal_branch(_):
        return (res.pose, jnp.asarray(False), jnp.asarray(False),
                jnp.asarray(False))

    rel, all_failed, weak, frac = jax.lax.cond(
        need_switch, switched_branch, normal_branch, None
    )
    base = jnp.where(need_switch, carry.last_gpose, carry.ref_gpose)
    gpose = se2.compose(base, rel)

    discarded = need_switch & all_failed
    keep = ~discarded

    def sel(new, old):
        return jax.tree.map(
            lambda a, b: jnp.where(keep, a, b), new, old
        )

    new_ref = jax.tree.map(
        lambda a, b: jnp.where(need_switch & keep, a, b), carry.last, carry.ref
    )
    new_carry = _OdoCarry(
        ref=new_ref,
        last=sel(cur, carry.last),
        ref_gpose=sel(jnp.where(need_switch, carry.last_gpose, carry.ref_gpose),
                      carry.ref_gpose),
        last_gpose=sel(gpose, carry.last_gpose),
        prior_rel=sel(jnp.where(need_switch, rel, res.pose), carry.prior_rel),
    )
    out_pose = jnp.where(keep, gpose, carry.last_gpose)
    return new_carry, (
        out_pose, need_switch & keep, discarded, weak | discarded,
        frac | discarded,
    )


def _deep_rematch_chunk(
    model: LaserModel, ref: Scan, cur: Scan, prior: Array, dt_big: Array
):
    """Batched exhaustive fallback: full ±π correlative match of each
    (previous, current) scan pair + confidence classification. One
    small compiled program per chunk shape, reused across the log.

    ``prior [B, 3]`` is the banded matcher's placeholder estimate. A
    step is a *fracture* only when the exhaustive matcher is
    unconfident AND disagrees with the banded estimate: two independent
    matchers agreeing is strong evidence the step is fine even when the
    correlative score is low (long corridors legitimately score low),
    and flagging such steps as fractures on fr079 turned its
    never-revisited final stretch into a free pendulum."""
    def one(r, c, p, big):
        corr = match_correlative(model, r, c, search_xy=1.2, n_theta=72)
        ex, ey, _ = error_index(model, r, c, corr.pose)
        err = jnp.sqrt(ex + ey)
        low_conf = (corr.score < 0.35) | (err > 6.0 * KEYFRAME_ERR_THRESH)
        weak = (corr.score < 0.4) | (err > 3.0 * KEYFRAME_ERR_THRESH)
        d = se2.relative(p, corr.pose)
        disagree = (jnp.linalg.norm(d[:2]) > 0.5) | (
            jnp.abs(se2.normalize_angle(d[2])) > 0.3
        )
        # Fracture needs BOTH a low-confidence exhaustive match AND a
        # corroborating anomaly (matcher disagreement or a frame-drop
        # time gap). Any single signal over-fires: low_conf alone flags
        # fr079's legitimate low-overlap corridor steps (8 false hinges
        # → its never-revisited final stretch swings freely), dt alone
        # flags ~20 benign intel steps (the early trajectory shredded
        # into floppy fragments, ATE 4.4 vs 3.2).
        frac = low_conf & (disagree | big)
        return corr.pose, corr.fail, weak, frac

    return jax.vmap(one)(ref, cur, prior, dt_big)


def odometry_keyframe(
    model: LaserModel,
    scans: Scan,
    deep_chunk: int = 128,
    timestamps=None,
) -> OdometryResult:
    """Run keyframe odometry over a preprocessed ``[T, N]`` scan log.

    Two passes, host-orchestrated (NOT wrappable in an outer ``jit``):

    1. one ``lax.scan`` of PSM + keyframe switching that *flags* steps
       whose banded matchers failed;
    2. a host loop of small batched correlative programs that re-match
       the flagged steps with a full ±π search, then an associative
       re-chaining of the per-step relatives.

    The exhaustive fallback is not a branch inside the whole-log scan:
    a giant scan program is the wrong home for a rarely-taken
    exhaustive search, and splitting it keeps every compiled program
    small and reusable.

    ``timestamps [T]`` (optional) drives frame-drop fracture detection:
    intel-lab's catastrophic heading breaks (scans 119-121, 393-394 —
    the robot whips 120-210° between frames) are exactly the steps
    whose inter-scan dt is 12× the median. A dt > 8× median marks the
    step *weak* unconditionally, and inside the deep re-match it counts
    as the corroborating anomaly: a deep-flagged step is fractured when
    the exhaustive matcher is low-confidence AND (the banded estimate
    disagrees OR the dt gap is big) — see ``_deep_rematch_chunk``.
    Neither signal alone fractures: a confident-but-wrong exhaustive
    match across a dt gap (scan 119→120 scores 0.70 at 79° off GT)
    stays weak, which the validated intel-lab runs tolerate because the
    surrounding loops place the blocks.
    """
    import numpy as np

    first = jax.tree.map(lambda x: x[0], scans)
    rest = jax.tree.map(lambda x: x[1:], scans)
    zero = jnp.zeros(3, scans.ranges.dtype)
    init = _OdoCarry(
        ref=first,
        last=first,
        ref_gpose=zero,
        last_gpose=zero,
        prior_rel=zero,
    )
    import os
    import sys
    import time as _time

    _verbose = bool(os.environ.get("LASER_SLAM_TIMING"))
    t0 = _time.perf_counter()
    pass1 = jax.jit(
        lambda i, r: jax.lax.scan(
            lambda c, s: _step(model, c, s, deep_inline=False), i, r
        )
    )
    _, (poses, switched, discarded, deep_flag, _unused) = pass1(init, rest)
    jax.block_until_ready(poses)
    if _verbose:
        print(f"[odo] pass1 scan: {_time.perf_counter() - t0:.1f}s",
              file=sys.stderr, flush=True)
        t0 = _time.perf_counter()

    poses = jnp.concatenate([zero[None], poses], axis=0)
    t = scans.ranges.shape[0]
    need = np.asarray(deep_flag | discarded)          # aligned to steps 1..T-1
    weak = np.array(need)
    disc = np.zeros(t - 1, bool)
    frac = np.zeros(t - 1, bool)

    if timestamps is not None:
        dts = np.diff(np.asarray(timestamps))
        med = max(float(np.median(dts)), 1e-6)
        dt_big = dts > 8.0 * med                  # [T-1], step j
        weak |= dt_big
    else:
        dt_big = np.zeros(t - 1, bool)

    idx = np.nonzero(need)[0]
    if idx.size:
        pad = (-idx.size) % deep_chunk
        idxp = np.concatenate([idx, np.zeros(pad, idx.dtype)])

        # Everything here is fused into TWO compiled programs (per-chunk
        # rematch incl. its gathers, and one final rechain-apply), so
        # the host pays two dispatches per chunk rather than one per
        # eager gather, update and ``se2.relative``.
        def _rematch_gather(sc, ps, sl, big):
            ref_b = jax.tree.map(lambda x: x[sl], sc)
            cur_b = jax.tree.map(lambda x: x[sl + 1], sc)
            prior_b = se2.relative(ps[sl], ps[sl + 1])
            return _deep_rematch_chunk(model, ref_b, cur_b, prior_b, big)

        rematch = jax.jit(_rematch_gather)
        pose_np = np.zeros((idxp.size, 3), np.float32)
        fail_np = np.zeros(idxp.size, bool)
        weak_np = np.zeros(idxp.size, bool)
        frac_np = np.zeros(idxp.size, bool)
        outs = []
        for i in range(0, idxp.size, deep_chunk):
            sl = idxp[i:i + deep_chunk]
            outs.append(
                rematch(scans, poses, jnp.asarray(sl),
                        jnp.asarray(dt_big[sl]))
            )
        # One bulk fetch after all chunks are queued.
        outs = jax.device_get(outs)
        for k, (pose_b, fail_b, weak_b, frac_b) in enumerate(outs):
            i = k * deep_chunk
            pose_np[i:i + deep_chunk] = pose_b
            fail_np[i:i + deep_chunk] = fail_b
            weak_np[i:i + deep_chunk] = weak_b
            frac_np[i:i + deep_chunk] = frac_b
        if _verbose:
            print(f"[odo]   {len(outs)} chunks fetched: "
                  f"{_time.perf_counter() - t0:.1f}s",
                  file=sys.stderr, flush=True)
        ok = ~fail_np[: idx.size]
        weak[idx] = weak_np[: idx.size] | ~ok | dt_big[idx]
        disc[idx] = ~ok
        frac[idx] = frac_np[: idx.size] | ~ok

        def _apply_rechain(ps, steps, new_rel, use):
            r = se2.relative(ps[:-1], ps[1:])
            upd = jnp.where(use[:, None], new_rel, r[steps])
            r = r.at[steps].set(upd)
            return jnp.concatenate([zero[None], se2.chain(r)], axis=0)

        poses = jax.jit(_apply_rechain)(
            poses, jnp.asarray(idxp),
            jnp.asarray(pose_np),
            jnp.asarray(
                np.concatenate([ok, np.zeros(pad, bool)])
            ),
        )
        jax.block_until_ready(poses)
        if _verbose:
            print(f"[odo] deep rematch ({idx.size} steps): "
                  f"{_time.perf_counter() - t0:.1f}s",
                  file=sys.stderr, flush=True)

    f = jnp.asarray(False)
    return OdometryResult(
        poses=poses,
        switched=jnp.concatenate([f[None], switched]),
        discarded=jnp.concatenate([f[None], jnp.asarray(disc)]),
        weak=jnp.concatenate([f[None], jnp.asarray(weak)]),
        fracture=jnp.concatenate([f[None], jnp.asarray(frac)]),
        rematched=jnp.concatenate([f[None], jnp.asarray(need)]),
    )


def odometry_pairwise(
    model: LaserModel, scans: Scan, use_icp: bool = False
) -> OdometryResult:
    """Batched consecutive-pair odometry: all T-1 matches run in
    parallel, then an O(log T) associative pose chain."""
    ref = jax.tree.map(lambda x: x[:-1], scans)
    cur = jax.tree.map(lambda x: x[1:], scans)
    matcher = match_icp if use_icp else match_psm
    res = jax.vmap(lambda a, b: matcher(model, a, b))(ref, cur)
    rel = jnp.where(res.fail[:, None], jnp.zeros_like(res.pose), res.pose)
    poses = jax.jit(se2.chain)(rel)
    zero = jnp.zeros((1, 3), poses.dtype)
    f = jnp.asarray(False)
    t1 = res.fail.shape[0]
    return OdometryResult(
        poses=jnp.concatenate([zero, poses], axis=0),
        switched=jnp.concatenate([f[None], jnp.ones(t1, bool)]),
        discarded=jnp.concatenate([f[None], res.fail]),
        weak=jnp.concatenate([f[None], res.fail]),
        fracture=jnp.concatenate([f[None], res.fail]),
    )
