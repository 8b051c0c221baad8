"""A/B the correlative verify stage across platforms on IDENTICAL inputs.

Stage 1 (--prep, CPU): build submaps/wide clouds from the saved odometry
chain and pick candidate pairs that are TRUE revisits under GT (within
2.5 m / any heading, gap > 20 anchors) — save everything to one npz.
Stage 2 (default): load the npz, run verify_loops_correlative, dump the
per-gate masks. Run once with JAX_PLATFORMS=cpu and once on the GPU; diff.
"""
import argparse
import json
import os
import sys

ap = argparse.ArgumentParser()
ap.add_argument("--prep", action="store_true")
ap.add_argument("--cpu", action="store_true")
ap.add_argument("--out", default="/tmp/probe_inputs.npz")
ap.add_argument("--res", default=None, help="result json path")
args = ap.parse_args()
if args.cpu:
    os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, "/root/repo")

import numpy as np
import jax
import jax.numpy as jnp

from laser_slam_tpu.io.carmen import read_carmen
from laser_slam_tpu.ops.preprocess import preprocess
from laser_slam_tpu.graph.submap import Submaps, build_submaps, wide_clouds
from laser_slam_tpu.graph.loop_closure import (
    LoopCandidates, verify_loops_correlative,
)
from laser_slam_tpu.runtime.slam import SlamConfig
import laser_slam_tpu.core.se2 as se2

cfg = SlamConfig()

if args.prep:
    log = read_carmen("/root/reference/data/intel-lab.log")
    d = np.load("/root/repo/diag_intel-lab.npz")
    odo = jnp.asarray(d["odo"])
    gt = np.asarray(d["gt"])
    scans = preprocess(jnp.asarray(log.ranges), log.model)
    submaps = jax.jit(
        lambda s, p: build_submaps(
            log.model, s, p, cfg.anchor_stride, cfg.submap_points
        )
    )(scans, odo)
    A = submaps.points.shape[0]
    aidx = np.arange(A) * cfg.anchor_stride
    odo_anchor = np.asarray(odo)[aidx]
    wide = jax.jit(
        lambda sm, op: wide_clouds(
            sm, op, wing=cfg.wing, max_points=cfg.wide_points
        )
    )(submaps, jnp.asarray(odo_anchor))
    ga = gt[aidx]
    # GT-true revisit pairs, spread over the trajectory.
    dxy = np.linalg.norm(ga[:, None, :2] - ga[None, :, :2], axis=-1)
    ii, jj = np.meshgrid(np.arange(A), np.arange(A), indexing="ij")
    mask = (dxy < 2.5) & ((jj - ii) > 20)
    src, dst = np.nonzero(mask)
    rng = np.random.default_rng(0)
    pick = rng.permutation(len(src))[:256]
    src, dst = src[pick], dst[pick]
    np.savez(
        args.out,
        sm_pts=np.asarray(submaps.points),
        sm_ok=np.asarray(submaps.valid),
        sm_aidx=np.asarray(submaps.anchor_idx),
        wide_pts=np.asarray(wide[0]), wide_ok=np.asarray(wide[1]),
        odo_anchor=odo_anchor, gt_anchor=ga,
        src=src.astype(np.int32), dst=dst.astype(np.int32),
    )
    print(f"saved {len(src)} GT-true pairs to {args.out}")
    sys.exit(0)

d = np.load(args.out)
submaps = Submaps(
    points=jnp.asarray(d["sm_pts"]), valid=jnp.asarray(d["sm_ok"]),
    anchor_idx=jnp.asarray(d["sm_aidx"]),
)
n = len(d["src"])
cand = LoopCandidates(
    src=jnp.asarray(d["src"]), dst=jnp.asarray(d["dst"]),
    valid=jnp.ones(n, bool),
)
anchor_poses = jnp.asarray(d["odo_anchor"])
trust = jnp.full(n, 1e9, jnp.float32)  # no in_gate constraint for probe

loops = verify_loops_correlative(
    submaps, anchor_poses, cand,
    cand_radius=trust,
    wide_pts=jnp.asarray(d["wide_pts"]), wide_ok=jnp.asarray(d["wide_ok"]),
    search_xy=cfg.search_xy, search_theta=float(jnp.pi),
    n_theta=cfg.n_theta, coarse_res=cfg.coarse_res, n_peaks=cfg.n_peaks,
    chunk=cfg.verify_chunk, quality_min=cfg.min_quality,
    identity_init=True,
)
g = loops.diag
ga = d["gt_anchor"]
rel_gt = np.asarray(se2.relative(jnp.asarray(ga[d["src"]]), jnp.asarray(ga[d["dst"]])))
pose = np.asarray(g["pose"])
diff = np.asarray(se2.relative(jnp.asarray(rel_gt), jnp.asarray(pose)))
t_err = np.linalg.norm(diff[:, :2], axis=-1)
acc = np.asarray(loops.accept)
tent = np.asarray(loops.tentative)

out = {
    "platform": str(jax.devices()[0].platform),
    "n_pairs": n,
    "accept": int(acc.sum()),
    "accept_correct(<0.5m)": int((acc & (t_err < 0.5)).sum()),
    "tentative": int(tent.sum()),
    "pose_found_correct": int((t_err < 0.5).sum()),
    "gates": {
        k: int(np.asarray(v).sum())
        for k, v in g.items()
        if np.asarray(v).dtype == bool
    },
    "mean_goodness": float(np.nanmean(np.asarray(g["goodness"]))),
    "mean_coarse": float(np.nanmean(np.asarray(g["coarse_score"]))),
}
print(json.dumps(out, indent=1))
res = args.res or f"/tmp/probe_{out['platform']}.npz"
np.savez(
    res, accept=acc, tent=tent, t_err=t_err,
    **{k: np.asarray(v) for k, v in g.items()},
)
