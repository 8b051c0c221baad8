"""Where the GPU and JAX's CPU backend part ways on the SLAM main path.

    python tools/exp/gpu_parity_probe.py [--scans 300] [--out FILE.json]

Needs a GPU; JAX's CPU backend in the same process is the reference.
Input is ``tools/synth_log.py`` at seed 0. Four parts, printed and
written to ``--out`` (default ``chiprun_out/gpu_parity_probe.json``):

- ``odometry``: the odometry pass over the first ``--scans`` scans on
  both backends, (a) as shipped, (b) under
  ``jax.default_matmul_precision("highest")``, (c) pass 1 alone (the PSM
  ``lax.scan``, no deep re-match). For each: step-delta median, p99 and
  max, and every step beyond 1 mm / 0.05 deg named as a pass-1 step or a
  deep-rematched one (as the CPU decides), and the steps whose re-match
  decision differs between the backends. For the deep-rematched steps,
  also whether the correlative search's grid argmax (before its ICP
  polish) differs.
- ``psm``: the matcher alone, ``match_psm`` on the same consecutive
  pairs from a zero prior with identical preprocessed inputs, and the
  preprocessing on both backends.
- ``precision``: for seeds 0-2 of the chunk sampler, one full-width
  loop-verification chunk and its score volume at the default and at
  ``"highest"`` precision: decision flips against the CPU, quality delta,
  score-volume error against float64 NumPy, and the chunk's wall.
- ``trace``: the compiled pass-1 program's ``while``/``conditional``
  count, its untraced wall, and a ``jax.profiler`` trace of a short
  window: kernels per step, device busy share and gaps over 20 us.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import io
import json
import os
import re
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402
from laser_slam_tpu.core import se2  # noqa: E402
from laser_slam_tpu.ops.odometry import (  # noqa: E402
    _OdoCarry, _step, odometry_keyframe,
)
from laser_slam_tpu.ops.preprocess import preprocess  # noqa: E402
from laser_slam_tpu.ops.psm import match_psm  # noqa: E402

# A step counts as diverged beyond these.
STEP_MM, STEP_DEG = 1.0, 0.05


def precision(mode: str):
    if mode == "highest":
        return jax.default_matmul_precision("highest")
    return contextlib.nullcontext()


def pass1(model, scans):
    """Pass 1 of ``odometry_keyframe`` alone: global poses ``[T, 3]`` and
    the steps it flags for the deep re-match ``[T-1]``."""
    first = jax.tree.map(lambda x: x[0], scans)
    rest = jax.tree.map(lambda x: x[1:], scans)
    zero = jnp.zeros(3, scans.ranges.dtype)
    init = _OdoCarry(first, first, zero, zero, zero)
    _, (poses, _, discarded, deep, _) = jax.lax.scan(
        lambda c, s: _step(model, c, s, deep_inline=False), init, rest)
    return jnp.concatenate([zero[None], poses]), deep | discarded


def odometry_modes(log, n: int, dev, cpu, modes=("shipped", "highest",
                                                   "pass1")):
    """Per-mode step deltas between ``dev`` and ``cpu``, with every
    diverged step named pass-1 or deep."""
    model = log.model
    ts = log.timestamps[:n]
    r = np.asarray(log.ranges[:n])
    p1 = jax.jit(pass1, static_argnums=0)
    need, need_dev = (np.asarray(chip_smoke._on(
        d, lambda x: p1(model, preprocess(x, model))[1], r)) for d in (cpu, dev))

    def shipped(x):
        return odometry_keyframe(model, preprocess(x, model),
                                 timestamps=ts).poses

    out = {"n_scans": n, "deep_steps": int(need.sum()),
           "rematch_decision_flips": [int(j) + 1 for j in
                                      np.nonzero(need != need_dev)[0]]}
    print(f"[odometry] re-match decision differs on steps "
          f"{out['rematch_decision_flips']}", flush=True)
    for mode in modes:
        fn = ((lambda x: p1(model, preprocess(x, model))[0])
              if mode == "pass1" else shipped)
        with precision(mode):
            g = chip_smoke._on(dev, fn, r)
            c = chip_smoke._on(cpu, fn, r)
        dt, dr = chip_smoke._pose_delta(se2.np_relative(g[:-1], g[1:]),
                                        se2.np_relative(c[:-1], c[1:]))
        dd = np.degrees(dr)
        off = np.nonzero((dt * 1e3 > STEP_MM) | (dd > STEP_DEG))[0]
        rows = sorted(((int(j) + 1, "deep" if need[j] else "pass1",
                        float(dt[j] * 1e3), float(dd[j])) for j in off),
                      key=lambda row: -row[2])
        rec = {
            "median_mm": float(np.median(dt) * 1e3),
            "median_deg": float(np.median(dd)),
            "p99_mm": float(np.percentile(dt, 99) * 1e3),
            "p99_deg": float(np.percentile(dd, 99)),
            "max_mm": float(dt.max() * 1e3), "max_deg": float(dd.max()),
            "diverged_pass1": sum(row[1] == "pass1" for row in rows),
            "diverged_deep": sum(row[1] == "deep" for row in rows),
            "diverged_steps": rows,
        }
        out[mode] = rec
        print(f"[odometry] {mode}: median {rec['median_mm']:.4f}mm/"
              f"{rec['median_deg']:.5f}deg p99 {rec['p99_mm']:.4f}mm/"
              f"{rec['p99_deg']:.5f}deg max {rec['max_mm']:.4f}mm/"
              f"{rec['max_deg']:.5f}deg; beyond {STEP_MM}mm/{STEP_DEG}deg: "
              f"{rec['diverged_pass1']} pass-1 steps, "
              f"{rec['diverged_deep']} deep steps of {out['deep_steps']}",
              flush=True)
        for row in rows[:12]:
            print(f"[odometry]   step {row[0]} ({row[1]}): "
                  f"{row[2]:.4f}mm {row[3]:.5f}deg", flush=True)

    # The deep re-match's grid argmax on both backends, before ICP.
    for mode in ("shipped", "highest"):
        with precision(mode):
            flips = chip_smoke.deep_search_flips(
                model, r, np.nonzero(need)[0] + 1, dev, cpu)
        out[f"deep_argmax_flips_{mode}"] = flips
        print(f"[odometry] deep re-match grid argmax ({mode}): "
              f"{len(flips)} of {out['deep_steps']} steps differ {flips}",
              flush=True)
    return out


def psm_pairs(log, n: int, dev, cpu):
    """The matcher alone: ``match_psm`` on the first ``n - 1`` consecutive
    pairs from a zero prior, on identical preprocessed inputs, plus the
    preprocessing itself on both backends."""
    model = log.model
    r = np.asarray(log.ranges[:n])
    pre = jax.jit(lambda x: preprocess(x, model))
    sg, sc = chip_smoke._on(dev, pre, r), chip_smoke._on(cpu, pre, r)
    out = {
        "preprocess_ranges_maxdiff": float(np.abs(sg.ranges - sc.ranges).max()),
        "preprocess_bad_flips": int((sg.bad != sc.bad).sum()),
        "preprocess_seg_flips": int((sg.seg != sc.seg).sum()),
    }
    fn = jax.jit(jax.vmap(lambda a, b: match_psm(model, a, b)))
    ref = jax.tree.map(lambda x: x[:-1], sc)
    cur = jax.tree.map(lambda x: x[1:], sc)
    g, c = chip_smoke._on(dev, fn, ref, cur), chip_smoke._on(cpu, fn, ref, cur)
    dt, dr = chip_smoke._pose_delta(g.pose, c.pose)
    dd = np.degrees(dr)
    off = (dt * 1e3 > STEP_MM) | (dd > STEP_DEG)
    out.update({
        "pairs": int(dt.size),
        "median_mm": float(np.median(dt) * 1e3),
        "p99_mm": float(np.percentile(dt, 99) * 1e3),
        "p99_deg": float(np.percentile(dd, 99)),
        "max_mm": float(dt.max() * 1e3), "max_deg": float(dd.max()),
        "diverged_pairs": int(off.sum()),
        "fail_flips": int((g.fail != c.fail).sum()),
    })
    print(f"[psm] {json.dumps(out)}", flush=True)
    return out


def precision_modes(log, odo_poses, cfg, dev, cpu, seeds=(0, 1, 2),
                    repeats: int = 5):
    """The smoke's verify-chunk and score-volume parity at default and
    ``"highest"`` precision for several chunk samples, with the chunk's
    steady wall on ``dev``."""
    from laser_slam_tpu.runtime.slam import _verify_chunk

    fn = jax.jit(lambda *a: _verify_chunk(cfg, *a))
    out = {}
    for seed in seeds:
        for mode in ("shipped", "highest"):
            buf = io.StringIO()
            with precision(mode), contextlib.redirect_stdout(buf):
                args, checks = chip_smoke.parity_verify_chunk(
                    log, odo_poses, cfg, dev, cpu, seed)
                checks += chip_smoke.parity_score_volume(args, cfg, dev, cpu)
                on_dev = jax.device_put(args, dev)
                walls = []
                for _ in range(repeats):
                    t0 = time.perf_counter()
                    jax.block_until_ready(fn(*on_dev))
                    walls.append(time.perf_counter() - t0)
            rec = {"lines": buf.getvalue().splitlines(),
                   "failed": [what for ok, what in checks if not ok],
                   "chunk_ms_median": float(np.median(walls) * 1e3)}
            out[f"seed{seed}_{mode}"] = rec
            print(f"[precision] seed {seed} {mode}: {json.dumps(rec)}",
                  flush=True)
    return out


def device_busy(xspace: str, plane_prefix: str = "/device:GPU:0",
                gap_ns: int = 20_000, top: int = 8):
    """Per line of the trace's device plane: events, span, busy (union
    of event intervals), gaps longer than ``gap_ns`` and the top kernels
    by summed duration."""
    from jax.profiler import ProfileData

    out = {}
    for plane in ProfileData.from_file(xspace).planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            ev = sorted((e.start_ns, e.end_ns, e.name) for e in line.events)
            if not ev:
                continue
            busy, gaps, gap_total, end = 0.0, 0, 0.0, ev[0][0]
            per_name: dict[str, list[float]] = {}
            for s, e, name in ev:
                if s > end:
                    if s - end > gap_ns:
                        gaps += 1
                        gap_total += s - end
                    end = s
                if e > end:
                    busy += e - end
                    end = e
                k = per_name.setdefault(name, [0, 0.0])
                k[0] += 1
                k[1] += e - s
            span = end - ev[0][0]
            out[f"{plane.name}|{line.name}"] = {
                "events": len(ev), "span_ms": span / 1e6,
                "busy_ms": busy / 1e6,
                "busy_share": busy / span if span else 0.0,
                f"gaps_over_{gap_ns // 1000}us": gaps,
                "gap_ms": gap_total / 1e6,
                "top": sorted(([n, c, d / 1e6] for n, (c, d) in
                               per_name.items()), key=lambda t: -t[2])[:top],
            }
    return out


def trace_pass1(log, trace_dir: str, window: int = 300,
                plane_prefix: str = "/device:GPU:0"):
    """Compiled pass-1 structure, untraced walls, and one traced window
    (its trace written under ``trace_dir``)."""
    model = log.model
    scans = jax.jit(lambda r: preprocess(r, model))(jnp.asarray(log.ranges))
    p1 = jax.jit(pass1, static_argnums=0)
    win = jax.tree.map(lambda x: x[:window], scans)
    t0 = time.perf_counter()
    compiled = p1.lower(model, win).compile()
    out = {"compile_s": time.perf_counter() - t0}
    hlo = compiled.as_text()
    for op in ("while", "conditional", "fusion"):
        out[f"hlo_{op}"] = len(re.findall(rf" {op}\(", hlo))
    for name, sc in (("full", scans), ("window", win)):
        jax.block_until_ready(p1(model, sc))            # compile / warm
        t0 = time.perf_counter()
        jax.block_until_ready(p1(model, sc))
        out[f"untraced_{name}_s"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(dir=trace_dir) as d:
        t0 = time.perf_counter()
        with jax.profiler.trace(d):
            jax.block_until_ready(p1(model, win))
        out["traced_window_s"] = time.perf_counter() - t0
        (xspace,) = glob.glob(os.path.join(d, "**", "*.xplane.pb"),
                              recursive=True)
        lines = device_busy(xspace, plane_prefix)
    out["steps"] = window - 1
    out["lines"] = lines
    for k, v in lines.items():
        if "Stream" in k or not plane_prefix.startswith("/device"):
            print(f"[trace] {k}: {v['events'] / (window - 1):.1f} events "
                  f"per step, busy {v['busy_share']:.3f} of "
                  f"{v['span_ms']:.1f} ms, {v['gaps_over_20us']} gaps > "
                  f"20us ({v['gap_ms']:.1f} ms)", flush=True)
    print(f"[trace] {json.dumps({k: v for k, v in out.items() if k != 'lines'})}",
          flush=True)
    return out


def main(argv=None) -> None:
    from laser_slam_tpu.io.carmen import read_carmen
    from laser_slam_tpu.runtime.slam import SlamConfig

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--scans", type=int, default=300)
    p.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                 "gpu_parity_probe.json"))
    p.add_argument("--parts", default="odometry,psm,precision,trace")
    args = p.parse_args(argv)
    dev = chip_smoke.require_gpu()
    cpu = jax.devices("cpu")[0]
    card = chip_smoke.card_name_and_power()
    print(f"[device] {card}; {dev.device_kind}", flush=True)
    os.makedirs(chip_smoke.OUT, exist_ok=True)
    log = read_carmen(chip_smoke.phase_input(chip_smoke.OUT, 0))
    out = {"card": card, "device_kind": dev.device_kind}
    parts = args.parts.split(",")
    if "odometry" in parts:
        out["odometry"] = odometry_modes(log, args.scans, dev, cpu)
    if "psm" in parts:
        out["psm"] = psm_pairs(log, args.scans, dev, cpu)
    if "precision" in parts:
        odo = chip_smoke._on(dev, lambda r: odometry_keyframe(
            log.model, preprocess(r, log.model),
            timestamps=log.timestamps).poses, np.asarray(log.ranges))
        out["precision"] = precision_modes(log, odo, SlamConfig(), dev, cpu)
    if "trace" in parts:
        out["trace"] = trace_pass1(log, chip_smoke.OUT)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    # The CPU reference needs JAX's CPU backend beside the GPU.
    platforms = os.environ.get("JAX_PLATFORMS")
    if platforms and "cpu" not in platforms.split(","):
        os.environ["JAX_PLATFORMS"] = platforms + ",cpu"
    main()
