"""Layer rates on one GPU, on the synthetic intel-lab-shaped log.

    python bench.py

Input: ``tools/synth_log.py`` at seed 0 (2672 LMS211 scans carved around
the intel-lab ground truth). Measured, each with compilation kept apart
from the steady state:

- batched PSM: ``jax.vmap(match_psm(..., banded=True))`` over the 2671
  consecutive pairs, median of five runs (the headline);
- chunked loop verification at the default ``SlamConfig`` widths;
- a 4096-particle localization tick;
- the occupancy map update;
- cold ``slam_offline`` wall and ATE (skipped with ``BENCH_SLAM=0``).

No baseline ratio is printed: the reference's C++ matcher has not been
timed on these synthetic pairs.

Exits non-zero without a GPU. Prints ONE JSON line on stdout; progress
goes to stderr.
"""

import json
import os
import sys
import time

import numpy as np

from chip_smoke import card_name_and_power, require_gpu

HERE = os.path.dirname(os.path.abspath(__file__))


def log_err(*a):
    print(*a, file=sys.stderr, flush=True)


def timed(fn, *args):
    """Wall of ``fn(*args)`` with its whole output fetched to the host."""
    t0 = time.perf_counter()
    out = fn(*args)
    import jax

    jax.device_get(out)
    return time.perf_counter() - t0, out


def main():
    import jax
    import jax.numpy as jnp

    from laser_slam_tpu.io.carmen import read_carmen
    from laser_slam_tpu.ops.preprocess import preprocess
    from laser_slam_tpu.ops.psm import match_psm
    from tools.synth_log import make_log

    dev = require_gpu()
    card = card_name_and_power()
    log_err("card:", card, "device_kind:", dev.device_kind)
    log = read_carmen(make_log(os.path.join(HERE, "smoke_out", "bench.log")))
    model = log.model
    scans = jax.jit(lambda r: preprocess(r, model))(jnp.asarray(log.ranges))

    ref = jax.tree.map(lambda x: x[:-1], scans)
    cur = jax.tree.map(lambda x: x[1:], scans)
    b = ref.ranges.shape[0]  # 2671 pairs
    fn = jax.jit(jax.vmap(lambda a, c: match_psm(model, a, c, banded=True)))

    t_first, out = timed(fn, ref, cur)
    fails = int(np.asarray(out.fail).sum())
    log_err(f"batched PSM compile+first: {t_first:.3f}s, fails={fails}/{b}")
    times = [timed(fn, ref, cur)[0] for _ in range(5)]
    rate = b / float(np.median(times))
    log_err(f"batched PSM runs: {times} -> {rate:.1f} matches/s")

    extras = {
        "card": card,
        "psm_compile_first_s": t_first,
        "psm_fails": fails,
        "psm_run_times_s": times,
    }
    extras.update(bench_secondary(model, scans))
    if os.environ.get("BENCH_SLAM", "1") != "0":
        extras.update(bench_slam_wall(log))

    print(json.dumps({
        "metric": "psm_scan_matches_per_sec",
        "value": rate,
        "unit": "matches/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "extras": extras,
    }))


def bench_secondary(model, scans):
    """Loop-verification, localization and map-update rates at the
    shapes the SLAM pipeline runs them."""
    import jax
    import jax.numpy as jnp

    from laser_slam_tpu.graph.submap import build_submaps, wide_clouds
    from laser_slam_tpu.mapping.occupancy import (
        empty_grid, integrate_scans, spec_for_trajectory,
    )
    from laser_slam_tpu.runtime.slam import SlamConfig, _verify_chunk

    out = {}
    t_scans = 1280
    sub = jax.tree.map(lambda x: x[:t_scans], scans)
    zeros = jnp.zeros((t_scans, 3), jnp.float32)

    # Loop verification as shipped: host-gathered fixed-size chunks
    # through one compiled chunk program (runtime/slam.py verify_fn).
    cfg = SlamConfig()
    sm = jax.jit(lambda s, p: build_submaps(
        model, s, p, cfg.anchor_stride, cfg.submap_points))(sub, zeros)
    a = sm.points.shape[0]
    wp, wo = jax.jit(lambda s, o: wide_clouds(
        s, o, wing=cfg.wing, max_points=cfg.wide_points))(
            sm, jnp.zeros((a, 3), jnp.float32))
    chunk_fn = jax.jit(lambda *args: _verify_chunk(cfg, *args))
    c = cfg.verify_chunk
    n_pairs = 256
    src = np.arange(n_pairs) % (a // 2)
    dst = src + a // 2
    rel = jnp.zeros((c, 3), jnp.float32)
    valid = jnp.ones(c, bool)
    trust = jnp.full(c, 10.0, jnp.float32)

    def run_chunks():
        outs = []
        for i in range(0, n_pairs, c):
            s_, d_ = jnp.asarray(src[i:i + c]), jnp.asarray(dst[i:i + c])
            outs.append(chunk_fn(
                wp[s_], wo[s_], sm.points[s_], sm.valid[s_],
                wp[d_], wo[d_], sm.points[d_], sm.valid[d_],
                rel, valid, trust,
            ).accept)
        return outs

    t_first, _ = timed(run_chunks)
    steady = float(np.median([timed(run_chunks)[0] for _ in range(3)]))
    out["verify_pairs_per_sec"] = n_pairs / steady
    out["verify_first_s"] = t_first
    log_err(f"chunked loop verification: {n_pairs / steady:.1f} pairs/s "
            f"steady; first pass (compile) {t_first:.3f}s")

    out.update(bench_localization(model, scans))

    spec = spec_for_trajectory(np.zeros((2, 3)), model.max_range, 0.05)
    mfn = jax.jit(lambda g, s, p: integrate_scans(g, model, s, p).log_odds)
    g0 = empty_grid(spec)
    t_first, _ = timed(mfn, g0, sub, zeros)
    steady = float(np.median([timed(mfn, g0, sub, zeros)[0]
                              for _ in range(3)]))
    out["map_update_scans_per_sec"] = t_scans / steady
    out["map_update_first_s"] = t_first
    log_err(f"map update: {t_scans / steady:.1f} scans/s")
    return out


def bench_localization(model, scans, n_particles=4096, ticks=20):
    """Particle-filter tracking rate at production cloud size."""
    import jax
    import jax.numpy as jnp

    from laser_slam_tpu.localization import particle_filter as pf
    from laser_slam_tpu.localization.raycast import likelihood_field
    from laser_slam_tpu.mapping.occupancy import (
        empty_grid, integrate_scans, spec_for_trajectory,
    )

    n_map = 400
    sub = jax.tree.map(lambda x: x[:n_map], scans)
    zeros = jnp.zeros((n_map, 3), jnp.float32)
    spec = spec_for_trajectory(np.zeros((2, 3)), model.max_range, 0.1)
    grid = jax.jit(lambda g, s, p: integrate_scans(g, model, s, p))(
        empty_grid(spec), sub, zeros
    )
    field = likelihood_field(grid)

    key = jax.random.PRNGKey(0)
    state = pf.init_gaussian(key, jnp.zeros(3), n_particles)

    tick = jax.jit(lambda st, rel, r, v, k: pf.track_field(
        st, rel, r, v, k, field, grid, model))

    rel = jnp.asarray([0.02, 0.0, 0.005], jnp.float32)
    r0 = scans.ranges[0]
    v0 = ~scans.bad[0] & (r0 < model.max_range)
    t_first, (state, _) = timed(tick, state, rel, r0, v0, key)
    t0 = time.perf_counter()
    for t in range(1, ticks + 1):
        key, k = jax.random.split(key)
        state, est = tick(state, rel, scans.ranges[t % n_map], v0, k)
    np.asarray(est)
    dt = (time.perf_counter() - t0) / ticks
    log_err(f"pf localization: {1.0 / dt:.1f} ticks/s at {n_particles} "
            f"particles; first tick (compile) {t_first:.3f}s")
    return {
        "pf_particle_updates_per_sec": n_particles / dt,
        "pf_ticks_per_sec": 1.0 / dt,
        "pf_first_s": t_first,
    }


def bench_slam_wall(log):
    """Cold end-to-end ``slam_offline`` wall and ATE on the synthetic
    log: this process's first compile of every pipeline program."""
    import jax
    import jax.numpy as jnp

    from laser_slam_tpu.eval.metrics import ate
    from laser_slam_tpu.runtime.slam import SlamConfig, slam_offline

    t0 = time.perf_counter()
    res = slam_offline(log.model, jnp.asarray(log.ranges), SlamConfig(),
                       timestamps=log.timestamps)
    jax.block_until_ready(res.poses)
    wall = time.perf_counter() - t0
    a = float(ate(res.poses, jnp.asarray(log.gt_pose)).rmse)
    log_err(f"slam_offline synthetic intel: {wall:.2f}s cold, ATE {a:.4f} m")
    return {"slam_wall_cold_s": wall, "slam_ate_m": a}


if __name__ == "__main__":
    main()
