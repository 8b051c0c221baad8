"""Smoke run of the SLAM main path on one GPU.

    python chip_smoke.py [--seed S]

One process, one card, the normal entry points at default ``SlamConfig``:

0. device check: exits non-zero unless JAX's first device is a GPU;
   prints the card's name and power limit (``nvidia-smi``) and JAX's
   ``device_kind``;
1. input: a seeded synthetic 2672-scan LMS211 CARMEN log carved around
   the intel-lab ground truth (``tools/synth_log.py``);
2. offline SLAM: ``laser_slam_tpu.cli.main(["slam", log])`` twice in this
   process (cold: compiles; warm: retraces and reuses the compile cache),
   with ``LASER_SLAM_TIMING=1`` stage walls, ATE of odometry and SLAM,
   loop count and peak device memory;
3. served path: ``runtime.tcp_slam.run_loopback`` over the first 300
   scans through the native socket transport, per-scan wall p50/p90;
4. localization: a 4096-particle tick on the map built in phase 2;
5. parity: JAX's CPU backend in this process as the plain reference for
   the odometry pass, one full-width loop-verification chunk and one
   correlative score volume (that one also against float64 NumPy).

Every phase checks its output and raises on failure. The last line of
standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "smoke_out")


def check(ok, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def say(*a) -> None:
    print(*a, flush=True)


def require_gpu():
    """The first JAX device, which must be a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"chip_smoke needs a GPU; JAX's first device is "
            f"{dev.platform} ({dev.device_kind})"
        )
    return dev


def card_name_and_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def phase_input(out_dir: str, seed: int, n_scans: int | None = None) -> str:
    from tools.synth_log import make_log

    t0 = time.perf_counter()
    path = make_log(os.path.join(out_dir, f"synth_intel_s{seed}.log"),
                    n_scans, seed)
    say(f"[input] synthetic log {path}: {time.perf_counter() - t0:.2f}s")
    return path


def phase_slam(log_path: str, cli_args=(), runs=("cold", "warm")):
    """Offline SLAM through the CLI; returns the last run's result."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from laser_slam_tpu import cli
    from laser_slam_tpu.eval.metrics import ate
    from laser_slam_tpu.io.carmen import read_carmen

    log = read_carmen(log_path)
    gt = jnp.asarray(log.gt_pose)
    timing = os.environ.get("LASER_SLAM_TIMING")
    os.environ["LASER_SLAM_TIMING"] = "1"
    res, walls = None, {}
    try:
        for run in runs:
            say(f"[slam] --- {run} run ---")
            t0 = time.perf_counter()
            # Stage walls go to stderr; keep them in order with ours.
            with contextlib.redirect_stderr(sys.stdout):
                res = cli.main(["slam", log_path, *cli_args])
            walls[run] = time.perf_counter() - t0
            say(f"[slam] {run} wall: {walls[run]:.2f}s")
    finally:
        if timing is None:
            del os.environ["LASER_SLAM_TIMING"]
        else:
            os.environ["LASER_SLAM_TIMING"] = timing
    poses = np.asarray(res.poses)
    a_odo = float(ate(res.odo_poses, gt).rmse)
    a_slam = float(ate(res.poses, gt).rmse)
    n_loops = int(res.n_loops)
    say(f"[slam] scans={poses.shape[0]} loops={n_loops} "
        f"ATE odometry={a_odo:.4f}m slam={a_slam:.4f}m")
    stats = jax.devices()[0].memory_stats() or {}
    say(f"[slam] peak_bytes_in_use={stats.get('peak_bytes_in_use', 'n/a')}")
    check(np.isfinite(poses).all(), "SLAM poses are finite")
    check(poses.shape == log.gt_pose.shape, "one pose per scan")
    check(n_loops >= 1, "at least one loop closed")
    check(a_slam <= a_odo, "SLAM ATE no worse than odometry ATE")
    return log, res


def phase_served(log, n_scans: int = 300, cfg=None):
    import jax.numpy as jnp
    import numpy as np

    from laser_slam_tpu.eval.metrics import ate
    from laser_slam_tpu.runtime.slam import SlamConfig
    from laser_slam_tpu.runtime.tcp_slam import run_loopback

    walls: list[float] = []
    t0 = time.perf_counter()
    traj, loops = run_loopback(log.model, log.ranges[:n_scans],
                               cfg or SlamConfig(), scan_walls=walls)
    total = time.perf_counter() - t0
    w = np.asarray(walls[1:])
    a = float(ate(jnp.asarray(traj), jnp.asarray(log.gt_pose[:n_scans])).rmse)
    say(f"[served] {n_scans} scans over loopback TCP: {total:.2f}s, "
        f"loops={loops}, ATE={a:.4f}m; first scan (compile) {walls[0]:.3f}s; "
        f"per-scan p50={np.percentile(w, 50) * 1e3:.2f}ms "
        f"p90={np.percentile(w, 90) * 1e3:.2f}ms")
    check(traj.shape == (n_scans, 3), "one served pose per scan")
    check(np.isfinite(traj).all(), "served poses are finite")
    return traj


def phase_localization(log, poses, n_particles: int = 4096,
                       ticks: int = 50, resolution: float = 0.05):
    """Particle-filter tracking on the map built from ``poses``."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from laser_slam_tpu.core import se2
    from laser_slam_tpu.localization import particle_filter as pf
    from laser_slam_tpu.localization.raycast import likelihood_field
    from laser_slam_tpu.mapping.occupancy import (
        empty_grid, integrate_scans, spec_for_trajectory,
    )
    from laser_slam_tpu.ops.preprocess import preprocess

    model = log.model
    poses = np.asarray(poses, np.float32)
    t0 = time.perf_counter()
    scans = jax.jit(lambda r: preprocess(r, model))(jnp.asarray(log.ranges))
    spec = spec_for_trajectory(poses, model.max_range, resolution)
    grid = jax.jit(lambda g, s, p: integrate_scans(g, model, s, p))(
        empty_grid(spec), scans, jnp.asarray(poses))
    field = jax.block_until_ready(jax.jit(likelihood_field)(grid))
    say(f"[loc] map {spec.width}x{spec.height} @ {resolution}m: "
        f"{time.perf_counter() - t0:.2f}s")

    # The tick SlamV1's localization mode runs, map passed as arguments.
    tick = jax.jit(functools.partial(pf.track_field, model=model))

    start = max(poses.shape[0] - ticks - 1, 0) // 2
    steps = range(start + 1, min(start + 1 + ticks, poses.shape[0]))
    key = jax.random.PRNGKey(0)
    state = pf.init_gaussian(key, jnp.asarray(poses[start]), n_particles)
    rel = se2.np_relative(poses[:-1], poses[1:]).astype(np.float32)
    ranges = np.asarray(scans.ranges)
    valid = ~np.asarray(scans.bad) & (ranges < model.max_range)
    errs, times = [], []
    for t in steps:
        key, k = jax.random.split(key)
        t0 = time.perf_counter()
        state, est = tick(state, rel[t - 1], ranges[t], valid[t], k,
                          field, grid)
        est = np.asarray(est)
        times.append(time.perf_counter() - t0)
        errs.append(float(np.linalg.norm(est[:2] - poses[t, :2])))
    warm = float(np.median(times[1:]))
    say(f"[loc] {n_particles} particles: first tick (compile) "
        f"{times[0]:.3f}s; warm {1.0 / warm:.1f} ticks/s "
        f"({n_particles / warm:,.0f} particle-updates/s); "
        f"err vs map poses mean={np.mean(errs):.3f}m max={np.max(errs):.3f}m")
    check(np.isfinite(errs).all(), "PF estimates are finite")
    check(np.max(errs) < 1.0, "PF tracks the map poses within 1 m")


# --- parity with JAX's CPU backend -----------------------------------------

def _on(dev, fn, *args):
    """Run ``fn(*args)`` with every array on ``dev``; fetch to host."""
    import jax

    with jax.default_device(dev):
        return jax.device_get(fn(*jax.device_put(args, dev)))


def _pose_delta(a, b):
    import numpy as np

    from laser_slam_tpu.core import se2

    d = se2.np_relative(np.asarray(a, np.float64), np.asarray(b, np.float64))
    return np.linalg.norm(d[..., :2], axis=-1), np.abs(d[..., 2])


def deep_search_flips(model, ranges, steps, dev, cpu) -> list[int]:
    """The ``steps`` (step t matches scan t against scan t-1) at which the
    deep re-match's exhaustive correlative search -- the only conv in
    odometry -- picks another cell or rotation on ``dev`` than on
    ``cpu``, before its ICP polish."""
    import jax
    import numpy as np

    from laser_slam_tpu.ops.correlative import match_correlative
    from laser_slam_tpu.ops.preprocess import preprocess

    steps = np.asarray(steps)
    if not steps.size:
        return []
    coarse = jax.jit(jax.vmap(lambda a, b: match_correlative(
        model, a, b, search_xy=1.2, n_theta=72, refine=False).pose))

    def grid_pose(x):
        sc = preprocess(x, model)
        return coarse(jax.tree.map(lambda s: s[steps - 1], sc),
                      jax.tree.map(lambda s: s[steps], sc))

    pg, pc = _on(dev, grid_pose, ranges), _on(cpu, grid_pose, ranges)
    return [int(t) for t, same in
            zip(steps, np.isclose(pg, pc, atol=1e-4).all(-1)) if not same]


def parity_odometry(log, n_scans: int, dev, cpu):
    """Odometry pass over the first ``n_scans``: per-step relative
    motions agree, step flags agree, and the deep re-match's correlative
    grid search picks the same cell and rotation on every re-matched step.
    Returns ``[(ok, what)]``."""
    import jax.numpy as jnp
    import numpy as np

    from laser_slam_tpu.core import se2
    from laser_slam_tpu.eval.metrics import ate
    from laser_slam_tpu.ops.odometry import odometry_keyframe
    from laser_slam_tpu.ops.preprocess import preprocess

    model = log.model
    ts = log.timestamps[:n_scans]

    def odo(r):
        return odometry_keyframe(model, preprocess(r, model), timestamps=ts)

    r = np.asarray(log.ranges[:n_scans])
    g, c = _on(dev, odo, r), _on(cpu, odo, r)
    rel_g = se2.np_relative(g.poses[:-1], g.poses[1:])
    rel_c = se2.np_relative(c.poses[:-1], c.poses[1:])
    dt, dr = _pose_delta(rel_g, rel_c)
    flips = sum(int((np.asarray(getattr(g, f)) != np.asarray(getattr(c, f))).sum())
                for f in ("switched", "discarded", "weak", "fracture"))
    rematch_flips = int((np.asarray(g.rematched)
                         != np.asarray(c.rematched)).sum())
    gt = jnp.asarray(log.gt_pose[:n_scans])
    a_g = float(ate(jnp.asarray(g.poses), gt).rmse)
    a_c = float(ate(jnp.asarray(c.poses), gt).rmse)

    deep = np.nonzero(np.asarray(c.rematched))[0]
    argmax_flips = len(deep_search_flips(model, r, deep, dev, cpu))
    say(f"[parity] odometry {n_scans} scans: step delta median "
        f"{np.median(dt) * 1e3:.4f}mm/{np.degrees(np.median(dr)):.5f}deg, "
        f"p99 {np.percentile(dt, 99) * 1e3:.4f}mm/"
        f"{np.degrees(np.percentile(dr, 99)):.5f}deg, "
        f"max {dt.max() * 1e3:.4f}mm/{np.degrees(dr.max()):.5f}deg; "
        f"{int(((dt > 1e-3) | (np.degrees(dr) > 0.05)).sum())} steps beyond "
        f"1 mm/0.05 deg; flag flips {flips}; re-match decision flips "
        f"{rematch_flips}; deep-search argmax flips "
        f"{argmax_flips} of {deep.size} re-matched steps; "
        f"ATE gpu={a_g:.4f}m cpu={a_c:.4f}m")
    # Tolerances. A typical step agrees to well under a millimetre:
    # median 1 mm / 0.01 deg. The tail comes from PSM steps of pass 1,
    # which has no dot or conv: on the H100 78 of the 83 steps beyond
    # 1 mm / 0.05 deg are pass-1 steps, and the readings do not move
    # under jax.default_matmul_precision("highest")
    # (tools/exp/gpu_parity_probe.py). PSM's stop counter and bearing
    # association are discrete, so last-bit differences between the two
    # backends' float32 arithmetic settle some steps elsewhere in a flat
    # minimum. Measured p99 14.2 mm / 0.60 deg (deterministic over
    # calls); limit p99 2 cm / 0.75 deg. Flags may flip on up to 1 % of
    # steps. Whether a step goes to the deep re-match is a threshold on
    # the pass-1 PSM residual, so steps at the threshold follow the same
    # last-bit differences: measured 6 of 299 steps (2 %); limit 3 %.
    # The deep search's argmax is where TF32 could act, and it must not
    # flip at all.
    return [
        (np.median(dt) < 1e-3 and np.degrees(np.median(dr)) < 0.01,
         "odometry median step delta within 1 mm / 0.01 deg"),
        (np.percentile(dt, 99) < 2e-2
         and np.degrees(np.percentile(dr, 99)) < 0.75,
         "odometry p99 step delta within 2 cm / 0.75 deg"),
        (flips <= max(1, n_scans // 100), "odometry flags agree"),
        (rematch_flips <= max(1, 3 * n_scans // 100),
         "re-match decisions agree on 97 % of steps"),
        (argmax_flips == 0, "deep re-match search argmax agrees"),
    ]


def verify_chunk_inputs(log, odo_poses, cfg, seed: int = 0):
    """One ``cfg.verify_chunk``-pair chunk of real loop candidates at the
    config's widths: three quarters ground-truth revisits, the rest
    random pairs; clouds built from the odometry as SLAM builds them."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from laser_slam_tpu.core import se2
    from laser_slam_tpu.graph.submap import build_submaps, wide_clouds
    from laser_slam_tpu.ops.preprocess import preprocess

    model = log.model
    scans = jax.jit(lambda r: preprocess(r, model))(jnp.asarray(log.ranges))
    sm = jax.jit(lambda s, p: build_submaps(
        model, s, p, cfg.anchor_stride, cfg.submap_points))(
            scans, jnp.asarray(odo_poses))
    a = sm.points.shape[0]
    oap = np.asarray(odo_poses)[np.asarray(sm.anchor_idx)]
    wp, wo = jax.jit(lambda s, p: wide_clouds(
        s, p, wing=cfg.wing, max_points=cfg.wide_points))(sm, jnp.asarray(oap))
    sm, wp, wo = jax.device_get((sm, wp, wo))

    gta = log.gt_pose[np.asarray(sm.anchor_idx)]
    i, j = np.triu_indices(a, k=1)
    near = np.linalg.norm(gta[i, :2] - gta[j, :2], axis=-1) < 2.0
    revisit = near & (j - i >= 10)
    rng = np.random.default_rng(seed)
    c = cfg.verify_chunk
    n_rev = min(int(revisit.sum()), 3 * c // 4)
    pick = list(rng.choice(np.nonzero(revisit)[0], n_rev, replace=False))
    rest = np.nonzero(~revisit)[0]
    pick += list(rng.choice(rest, c - n_rev, replace=len(rest) < c - n_rev))
    s, d = i[pick], j[pick]
    rel = se2.np_relative(oap[s], oap[d]).astype(np.float32)
    trust = (cfg.loop_radius + cfg.drift_rate * (d - s)).astype(np.float32)
    args = (wp[s], wo[s], sm.points[s], sm.valid[s],
            wp[d], wo[d], sm.points[d], sm.valid[d],
            rel, np.ones(c, bool), trust)
    return args, n_rev


def parity_verify_chunk(log, odo_poses, cfg, dev, cpu, seed: int = 0):
    """One ``_verify_chunk`` at the config's widths on both backends:
    accept and tentative flags agree, measured loop poses agree.
    Returns ``(chunk inputs, [(ok, what)])``."""
    import jax
    import numpy as np

    from laser_slam_tpu.runtime.slam import _verify_chunk

    args, n_rev = verify_chunk_inputs(log, odo_poses, cfg, seed)
    fn = jax.jit(lambda *a: _verify_chunk(cfg, *a))
    keep = ("accept", "tentative", "rel", "quality")
    g = _on(dev, lambda *a: {k: getattr(fn(*a), k) for k in keep}, *args)
    c = _on(cpu, lambda *a: {k: getattr(fn(*a), k) for k in keep}, *args)
    acc_flips = int((g["accept"] != c["accept"]).sum())
    ten_flips = int((g["tentative"] != c["tentative"]).sum())
    both = (g["accept"] | g["tentative"]) & (c["accept"] | c["tentative"])
    dt, dr = _pose_delta(g["rel"][both], c["rel"][both])
    dq = np.abs(g["quality"] - c["quality"])
    say(f"[parity] verify chunk {len(g['accept'])} pairs "
        f"({n_rev} GT revisits; {cfg.submap_points}/{cfg.wide_points} "
        f"points, n_theta={cfg.n_theta}): accepted gpu={int(g['accept'].sum())} "
        f"cpu={int(c['accept'].sum())}; accept flips {acc_flips}, "
        f"tentative flips {ten_flips}; loop pose delta max "
        f"{(dt.max() if dt.size else 0.0) * 1e3:.4f}mm/"
        f"{np.degrees(dr.max() if dr.size else 0.0):.5f}deg; "
        f"quality delta max {dq.max():.2e}")
    # Tolerances: no decision may flip; a loop both sides keep must land
    # in the same ICP basin, so its pose agrees to 1 cm / 0.1 deg (float32
    # ICP converges to ~0.1 mm; the rest is headroom for order effects).
    return args, [
        (acc_flips == 0 and ten_flips == 0, "loop decisions agree"),
        (dt.size == 0 or (dt.max() < 1e-2 and np.degrees(dr.max()) < 0.1),
         "accepted loop poses agree within 1 cm / 0.1 deg"),
    ]


def _score_volume_f64(grid, pts, ok, thetas, n_steps, res, half, base,
                      edge: float = 1e-3):
    """``correlative_score_volume`` (plain mean) in NumPy: the gather
    form, in float64. Returns ``(volume, slack, n_edge)``: a point that
    lies within ``edge`` cells of a cell boundary may fall on either side
    under float32 rotation, so ``slack`` bounds, per element, what
    choosing its other cell could change, and ``n_edge`` counts those
    (point, rotation) pairs."""
    import numpy as np

    g = grid.shape[0]
    t = 2 * n_steps + 1
    pad = np.pad(grid.astype(np.float64), n_steps + 1)   # room for +-1 cell
    th = thetas.astype(np.float64)[:, None]
    p = pts.astype(np.float64)
    rx = p[None, :, 0] * np.cos(th) - p[None, :, 1] * np.sin(th) + base[0]
    ry = p[None, :, 0] * np.sin(th) + p[None, :, 1] * np.cos(th) + base[1]
    fx, fy = (rx + half) / res, (ry + half) / res         # [K, N] in cells
    off = np.arange(t)
    n = max(int(ok.sum()), 1)

    def window(iy, ix):
        """Grid values a point in cell (iy, ix) adds over all shifts;
        zero for a cell outside the raster, as the conv drops it."""
        if not (0 <= ix < g and 0 <= iy < g):
            return 0.0
        return pad[iy + 1 + off[:, None], ix + 1 + off[None, :]]

    vol = np.zeros((len(thetas), t, t))
    slack = np.zeros_like(vol)
    n_edge = 0
    for k in range(len(thetas)):
        for x, y in zip(fx[k][ok], fy[k][ok]):
            ix, iy = int(np.floor(x)), int(np.floor(y))
            here = window(iy, ix)
            vol[k] += here
            alts = {(int(np.floor(y + dy)), int(np.floor(x + dx)))
                    for dx in (-edge, 0.0, edge) for dy in (-edge, 0.0, edge)}
            alts.discard((iy, ix))
            if alts:
                n_edge += 1
                slack[k] += max(np.max(np.abs(window(*c) - here)) for c in alts)
    return vol / n, slack / n, n_edge


def parity_score_volume(chunk_args, cfg, dev, cpu):
    """One loop-verification score volume (wide query of the first pair,
    the config's search window): GPU and CPU against float64 NumPy.
    Returns ``[(ok, what)]``."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from laser_slam_tpu.ops.correlative import (
        build_likelihood_grid_points, correlative_score_volume,
    )

    refw_pts, refw_ok, curw_pts, curw_ok = (chunk_args[0][0], chunk_args[1][0],
                                            chunk_args[4][0], chunk_args[5][0])
    stride = max(curw_pts.shape[0] // 192, 1)       # the coarse query
    pts, ok = curw_pts[::stride], curw_ok[::stride]
    res, half = cfg.coarse_res, 12.8
    n_steps = int(round(cfg.search_xy / res))
    thetas = np.linspace(-np.pi, np.pi, cfg.n_theta, dtype=np.float32)
    base = np.zeros(2, np.float32)
    grid = np.asarray(jax.jit(lambda p, o: build_likelihood_grid_points(
        p, o, res=res, half_extent=half, blur_sigma=1.0))(refw_pts, refw_ok))

    def vol(gr, p, o, th, b):
        return correlative_score_volume(gr, p, o, th, n_steps, res, half, b)

    fn = jax.jit(vol)
    v_gpu = _on(dev, fn, grid, pts, ok, thetas, base)
    v_cpu = _on(cpu, fn, grid, pts, ok, thetas, base)
    v64, slack, n_edge = _score_volume_f64(grid, pts, ok, thetas, n_steps,
                                           res, half, base)
    # Tolerance: 1e-4 on scores in [0, 1], plus the slack of points on a
    # cell edge. At default precision XLA's autotuner picks a full-f32
    # conv in some processes (measured max error 2e-7 on the H100) and a
    # TF32 one in others (1.1-1.5e-5), and TF32 flipped no loop decision;
    # a wrong conv or gather is off by about one point, 1/n ~ 5e-3.
    tol = 1e-4 + slack
    e_gpu = np.abs(v_gpu - v64) - slack
    e_cpu = np.abs(v_cpu - v64) - slack
    say(f"[parity] score volume {tuple(v64.shape)} ({int(ok.sum())} points, "
        f"{n_edge} point-rotations on a cell edge): max |gpu-f64| beyond "
        f"edge slack {e_gpu.max():.3e} (median {np.median(e_gpu):.3e}), "
        f"cpu {e_cpu.max():.3e}; argmax gpu={int(np.argmax(v_gpu))} "
        f"cpu={int(np.argmax(v_cpu))} f64={int(np.argmax(v64))}")
    return [
        (np.all(np.abs(v_gpu - v64) <= tol),
         "GPU score volume within 1e-4 (+ edge slack) of float64"),
        (np.all(np.abs(v_cpu - v64) <= tol),
         "CPU score volume within 1e-4 (+ edge slack) of float64"),
    ]


def phase_parity(log, odo_poses, dev, n_odo: int = 300, cfg=None):
    import jax

    from laser_slam_tpu.runtime.slam import SlamConfig

    cfg = cfg or SlamConfig()
    cpu = jax.devices("cpu")[0]
    t0 = time.perf_counter()
    checks = parity_odometry(log, n_odo, dev, cpu)
    args, more = parity_verify_chunk(log, odo_poses, cfg, dev, cpu)
    checks += more + parity_score_volume(args, cfg, dev, cpu)
    say(f"[parity] wall {time.perf_counter() - t0:.2f}s")
    failed = [what for ok, what in checks if not ok]
    check(not failed, "; ".join(failed))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the synthetic log")
    args = p.parse_args(argv)
    # The parity phase needs JAX's CPU backend beside the GPU.
    platforms = os.environ.get("JAX_PLATFORMS")
    if platforms and "cpu" not in platforms.split(","):
        os.environ["JAX_PLATFORMS"] = platforms + ",cpu"

    t_start = time.perf_counter()
    dev = require_gpu()
    say(f"[device] {card_name_and_power()}")
    say(f"[device] device_kind={dev.device_kind}")
    log_path = phase_input(OUT, args.seed)
    log, res = phase_slam(log_path)
    t0 = time.perf_counter()
    phase_served(log)
    say(f"[served] wall {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    phase_localization(log, res.poses)
    say(f"[loc] wall {time.perf_counter() - t0:.2f}s")
    phase_parity(log, res.odo_poses, dev)
    say(f"[smoke] total wall {time.perf_counter() - t_start:.2f}s")

    import jax

    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
