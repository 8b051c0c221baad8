"""Command-line interface.

Covers the reference's per-component executables (SURVEY appendix):
``odometry`` (zhpsm test), ``slam`` (mapGraph/slam test pipelines),
``draw`` (drawmap), ``localize`` (localization app), ``eval`` (accuracy
harnesses), ``bench`` (timing hooks).

Usage: ``python -m laser_slam_tpu.cli <command> [options]``
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _load(path, max_scans):
    from .io.carmen import read_carmen

    return read_carmen(path, max_scans=max_scans)


def cmd_odometry(args):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from .eval.metrics import ate, rpe
    from .ops.odometry import odometry_keyframe, odometry_pairwise
    from .ops.preprocess import preprocess

    log = _load(args.log, args.scans)
    scans = preprocess(jnp.asarray(log.ranges), log.model)
    t0 = time.time()
    if args.pairwise:
        res = jax.block_until_ready(odometry_pairwise(log.model, scans))
    else:
        # Timestamps drive frame-drop fracture detection (dt-gap
        # corroboration); CARMEN logs carry them.
        res = jax.block_until_ready(
            odometry_keyframe(log.model, scans, timestamps=log.timestamps)
        )
    dt = time.time() - t0
    est = np.asarray(res.poses)
    print(f"{log.n_scans} scans in {dt:.2f}s (incl. compile)")
    if log.gt_pose.size:
        a = ate(jnp.asarray(est), jnp.asarray(log.gt_pose[: est.shape[0]]))
        print(f"ATE rmse={float(a.rmse):.3f}m mean={float(a.mean):.3f}m")
    if args.out:
        np.savetxt(args.out, est, fmt="%.6f")
        print(f"trajectory -> {args.out}")


def cmd_slam(args):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from .eval.metrics import ate
    from .runtime.slam import SlamConfig, slam_offline

    log = _load(args.log, args.scans)
    cfg = SlamConfig(
        anchor_stride=args.stride, rounds=args.rounds,
        loop_radius=args.radius, max_loops=args.max_loops,
    )
    t0 = time.time()
    res = jax.block_until_ready(
        slam_offline(log.model, jnp.asarray(log.ranges), cfg,
                     timestamps=log.timestamps)
    )
    print(
        f"{log.n_scans} scans in {time.time()-t0:.1f}s; "
        f"loops={int(res.n_loops)} chi2={float(res.chi2):.2f}"
    )
    if log.gt_pose.size:
        gt = jnp.asarray(log.gt_pose)
        print(f"ATE odometry rmse={float(ate(res.odo_poses, gt).rmse):.3f}m")
        print(f"ATE slam     rmse={float(ate(res.poses, gt).rmse):.3f}m")
    if args.out:
        np.savetxt(args.out, np.asarray(res.poses), fmt="%.6f")
        print(f"trajectory -> {args.out}")
    if args.map:
        _render(log, np.asarray(res.poses), args.map, args.resolution)
    return res


def _render(log, poses, out, resolution):
    import jax
    import jax.numpy as jnp

    from .mapping.occupancy import (
        empty_grid, integrate_scans, spec_for_trajectory,
    )
    from .ops.preprocess import preprocess
    from .viz.render import render_map_png

    scans = preprocess(jnp.asarray(log.ranges), log.model)
    spec = spec_for_trajectory(poses, log.model.max_range, resolution)
    grid = jax.jit(
        lambda g, s, p: integrate_scans(g, log.model, s, p)
    )(empty_grid(spec), scans, jnp.asarray(poses))
    render_map_png(jax.device_get(grid), out, poses)
    print(f"map ({spec.width}x{spec.height} @ {resolution}m) -> {out}")


def cmd_draw(args):
    import numpy as np

    log = _load(args.log, args.scans)
    poses = (
        np.loadtxt(args.traj, dtype=np.float32)
        if args.traj
        else log.gt_pose[: log.n_scans]
    )
    _render(log, poses[: log.n_scans], args.out, args.resolution)


def cmd_localize(args):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from .core import se2
    from .localization import particle_filter as pf
    from .localization.raycast import likelihood_field
    from .mapping.occupancy import (
        empty_grid, integrate_scans, spec_for_trajectory,
    )
    from .ops.preprocess import preprocess

    log = _load(args.log, args.scans)
    model = log.model
    scans = preprocess(jnp.asarray(log.ranges), model)
    gt = jnp.asarray(log.gt_pose[: log.n_scans])

    # Build the map from the first part of the log, localize the rest.
    split = log.n_scans // 2
    spec = spec_for_trajectory(np.asarray(gt), model.max_range, args.resolution)
    grid = jax.jit(lambda g, s, p: integrate_scans(g, model, s, p))(
        empty_grid(spec),
        jax.tree.map(lambda x: x[:split], scans),
        gt[:split],
    )
    field = likelihood_field(grid)

    key = jax.random.PRNGKey(0)
    state = pf.init_gaussian(key, gt[split], args.particles)

    tick = jax.jit(lambda st, rel, r, v, k: pf.track_field(
        st, rel, r, v, k, field, grid, model))

    errs = []
    for t in range(split + 1, min(split + 1 + args.steps, log.n_scans)):
        key, k = jax.random.split(key)
        rel = se2.relative(gt[t - 1], gt[t])  # odometry stand-in
        valid = ~scans.bad[t] & (scans.ranges[t] < model.max_range)
        state, est = tick(state, rel, scans.ranges[t], valid, k)
        errs.append(float(jnp.linalg.norm(est[:2] - gt[t, :2])))
    errs = np.asarray(errs)
    print(
        f"tracked {len(errs)} steps with {args.particles} particles: "
        f"pos err mean={errs.mean():.3f}m p90={np.percentile(errs, 90):.3f}m"
    )


def cmd_view(args):
    """Replay a log in the live viewer (the reference's ui/rawseed
    viewer role); headless by default, writes a GIF with --out."""
    import numpy as np

    from .viz.live import replay_log

    log = _load(args.log, args.scans)
    if args.traj:
        # Clamp to the loaded scan count: a full-log trajectory file
        # replayed with --scans K would otherwise index past log.ranges.
        poses = np.loadtxt(args.traj, dtype=np.float32)[: log.n_scans]
    elif log.gt_pose.size:
        poses = log.gt_pose[: log.n_scans]
    else:
        raise SystemExit("no --traj and the log has no ground truth")
    gt = log.gt_pose[: log.n_scans] if (args.traj and log.gt_pose.size) else None
    v = replay_log(
        log,
        poses,
        out=args.out,
        stride=args.stride,
        gt=gt,
        interactive=args.interactive,
    )
    if args.out:
        print(f"animation -> {args.out}")
    if args.frame:
        v.save_frame(args.frame)
        print(f"final frame -> {args.frame}")
    if args.interactive:
        input("press enter to close...")
    v.close()


def cmd_eval(args):
    import jax.numpy as jnp
    import numpy as np

    from .eval.metrics import ate, rpe

    est = np.loadtxt(args.traj, dtype=np.float32)
    log = _load(args.log, None)
    gt = jnp.asarray(log.gt_pose[: est.shape[0]])
    a = ate(jnp.asarray(est), gt)
    tr, rot = rpe(jnp.asarray(est), gt)
    print(
        json.dumps(
            {
                "ate_rmse": round(float(a.rmse), 4),
                "ate_mean": round(float(a.mean), 4),
                "rpe_trans_mean": round(float(jnp.mean(tr)), 4),
                "rpe_rot_mean_deg": round(float(jnp.degrees(jnp.mean(rot))), 4),
            }
        )
    )


def cmd_serve(args):
    """Distributed SLAM server: accept one frontend stream, run the
    full correlative backend, push pose corrections back (the
    reference's main_server.cpp:10-31 role)."""
    import numpy as np

    from .core.scan import PRESETS
    from .native.api import ScanServer
    from .runtime.slam import SlamConfig
    from .runtime.tcp_slam import Backend

    model = PRESETS[args.model]
    server = ScanServer(args.port)
    print(f"listening on :{args.port} ({model.name})")
    conn = server.accept(timeout_ms=args.timeout * 1000)
    be = Backend(conn, model, SlamConfig())
    anchors = be.run()
    print(f"session done: {be.poses.shape[0]} scans, "
          f"{anchors.shape[0]} anchors, {be.n_loops_total} loops")
    if args.out:
        np.savetxt(args.out, be.poses, fmt="%.6f")
        print(f"trajectory -> {args.out}")
    conn.close()
    server.close()


def cmd_client(args):
    """Distributed SLAM client: local odometry on a log, scans streamed
    to the server, pose corrections applied (main_client.cpp:4-10)."""
    import numpy as np

    from .native.api import ScanSocket
    from .runtime.tcp_slam import Frontend

    log = _load(args.log, args.scans)
    fe = Frontend(ScanSocket.connect(args.host, args.port), log.model)
    t0 = time.time()
    for r in log.ranges:
        fe.feed_scan(np.asarray(r, np.float32))
    print(f"{log.n_scans} scans streamed in {time.time() - t0:.1f}s")
    fe.close()
    if args.out:
        np.savetxt(args.out, np.stack(fe.poses), fmt="%.6f")
        print(f"trajectory -> {args.out}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="laser_slam_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("log")
        sp.add_argument("--scans", type=int, default=None)

    sp = sub.add_parser("odometry", help="scan-matching odometry over a log")
    common(sp)
    sp.add_argument("--pairwise", action="store_true")
    sp.add_argument("--out")
    sp.set_defaults(fn=cmd_odometry)

    from .runtime.slam import SlamConfig as _SC

    _dflt = _SC()
    sp = sub.add_parser("slam", help="full SLAM with loop closure")
    common(sp)
    sp.add_argument("--stride", type=int, default=_dflt.anchor_stride)
    sp.add_argument("--rounds", type=int, default=_dflt.rounds)
    sp.add_argument("--radius", type=float, default=_dflt.loop_radius)
    sp.add_argument("--max-loops", type=int, default=_dflt.max_loops)
    sp.add_argument("--out")
    sp.add_argument("--map")
    sp.add_argument("--resolution", type=float, default=0.05)
    sp.set_defaults(fn=cmd_slam)

    sp = sub.add_parser("draw", help="render occupancy map PNG from a log")
    common(sp)
    sp.add_argument("--traj", help="trajectory file (default: GT poses)")
    sp.add_argument("--out", default="map.png")
    sp.add_argument("--resolution", type=float, default=0.05)
    sp.set_defaults(fn=cmd_draw)

    sp = sub.add_parser("localize", help="particle-filter localization demo")
    common(sp)
    sp.add_argument("--particles", type=int, default=2048)
    sp.add_argument("--steps", type=int, default=200)
    sp.add_argument("--resolution", type=float, default=0.05)
    sp.set_defaults(fn=cmd_localize)

    sp = sub.add_parser("view", help="live viewer replay of a log (GIF/window)")
    common(sp)
    sp.add_argument("--traj", help="trajectory file (default: GT poses)")
    sp.add_argument("--out", help="write an animated GIF here")
    sp.add_argument("--frame", help="write the final frame PNG here")
    sp.add_argument("--stride", type=int, default=25)
    sp.add_argument("--interactive", action="store_true")
    sp.set_defaults(fn=cmd_view)

    sp = sub.add_parser("eval", help="ATE/RPE of a trajectory vs log GT")
    sp.add_argument("traj")
    sp.add_argument("log")
    sp.set_defaults(fn=cmd_eval)

    sp = sub.add_parser(
        "serve", help="distributed SLAM backend server (tcp_slam server)"
    )
    sp.add_argument("--port", type=int, default=6188)  # main_server.cpp:14
    sp.add_argument("--model", default="LMS211")
    sp.add_argument("--timeout", type=int, default=300,
                    help="seconds to wait for a client")
    sp.add_argument("--out")
    sp.set_defaults(fn=cmd_serve)

    sp = sub.add_parser(
        "client", help="distributed SLAM frontend client (tcp_slam client)"
    )
    common(sp)
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=6188)
    sp.add_argument("--out")
    sp.set_defaults(fn=cmd_client)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
