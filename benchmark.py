#!/usr/bin/env python
"""Benchmark sweep harness — the reference benchmark.py equivalent.

Runs the CLI binary over a {scene} x {depth} x {samples} x {renderer}
matrix via subprocess, scrapes the stdout contract lines
(`Time measured` / `Total rays` / `Rays/sec`, identical strings to
render_megakernel.cpp:181-183), discards run 0 (XLA compile, the analog
of the reference's SYCL JIT warm-up), and writes benchmark_raw.csv /
benchmark_avg.csv with the same column layout as the reference's CSVs.

Defaults are scaled for practical wall time on one chip; the full
reference matrix (depths 10..50, samples 32..512) is available with
--full.
"""

from __future__ import annotations

import argparse
import csv
import re
import statistics
import subprocess
import sys
import time

RAYS_RE = re.compile(r"Rays/sec: ([0-9.]+)M")
TIME_RE = re.compile(r"Time measured: ([0-9.]+) seconds")
TOTAL_RE = re.compile(r"Total rays: ([0-9]+)")


def run_once(scene, renderer_flag, depth, samples, width, height,
             timeout=3600, seed=0, devices=1):
    cmd = [sys.executable, "-m", "sycl_ray_tracer_tpu", scene,
           renderer_flag, "-d", str(depth), "-s", str(samples),
           "--width", str(width), "--height", str(height),
           "--seed", str(seed)]
    if devices > 1:
        cmd += ["--devices", str(devices)]
    out = subprocess.run(cmd, capture_output=True, text=True,
                         timeout=timeout)
    if out.returncode != 0:
        raise RuntimeError(f"run failed: {' '.join(cmd)}\n{out.stderr[-2000:]}")
    text = out.stdout
    return (float(TIME_RE.search(text).group(1)),
            int(TOTAL_RE.search(text).group(1)),
            float(RAYS_RE.search(text).group(1)))


def run_once_inproc(ctx, scene, renderer, depth, samples, width,
                    height, seed=0, devices=1):
    """One timed render sharing a process (and its XLA compilations)
    with every other config: the d/spp sweeps reuse the same compiled
    bucket programs, where the subprocess-per-run mode (the
    reference's structure — it times a native binary) reloads them
    from the persistent cache in every process."""
    import jax
    import numpy as np

    key = scene
    if key not in ctx:
        from sycl_ray_tracer_tpu.models.scene import build_device_scene
        from sycl_ray_tracer_tpu.utils.cli import resolve_scene_bytes
        from sycl_ray_tracer_tpu.utils.gltf import load_glb

        host = load_glb(resolve_scene_bytes(scene))
        dev = build_device_scene(host)
        ctx[key] = (dev, host)
    dev, host = ctx[key]
    from sycl_ray_tracer_tpu.models.camera import make_camera
    from sycl_ray_tracer_tpu.models.renderer import get_renderer

    cam = make_camera(width, height, host.camera_position,
                      host.camera_direction, host.camera_focal_length)
    if devices > 1:
        # sharded benchmark mode (--devices N): the same sweep over a
        # sample-axis mesh (parallel/mesh.py)
        from sycl_ray_tracer_tpu.parallel.mesh import (make_mesh,
                                                       render_sharded)
        mesh_key = f"mesh{devices}"
        if mesh_key not in ctx:
            ctx[mesh_key] = make_mesh(dp=devices)
        t0 = time.perf_counter()
        img, rays = jax.block_until_ready(render_sharded(
            dev, cam, width=width, height=height, spp=samples,
            max_depth=depth, seed=seed, mesh=ctx[mesh_key],
            renderer=renderer))
        total = int(np.asarray(rays).astype(np.int64).sum())
        secs = time.perf_counter() - t0
        return secs, total, total / secs / 1e6
    render = get_renderer(renderer)
    t0 = time.perf_counter()
    img, rays = jax.block_until_ready(
        render(dev, cam, width=width, height=height, spp=samples,
               max_depth=depth, seed=seed))
    total = int(np.asarray(rays).astype(np.int64).sum())
    secs = time.perf_counter() - t0
    return secs, total, total / secs / 1e6


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", nargs="*",
                    default=["sponza_proc", "minecraft_proc"])
    ap.add_argument("--depths", nargs="*", type=int, default=[10])
    ap.add_argument("--samples", nargs="*", type=int, default=[4])
    ap.add_argument("--runs", type=int, default=3,
                    help="timed runs per config (plus 1 discarded warm-up)")
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--height", type=int, default=1024)
    ap.add_argument("--resolutions", nargs="*", default=None,
                    help="WxH list overriding --width/--height; all "
                         "resolutions run in ONE process so the "
                         "resolution-independent wavefront bucket "
                         "programs compile once (the matrix shapes "
                         "are bucket sizes, not image sizes)")
    ap.add_argument("--pairs", nargs="*", default=None,
                    help="explicit depth:samples pairs (e.g. 30:128 "
                         "10:512), overriding --depths/--samples and "
                         "--full — for filling in individual matrix "
                         "rows without redoing the cross product")
    ap.add_argument("--full", action="store_true",
                    help="reference matrix: the exact 9 (depth, spp) "
                         "pairs of /root/reference/benchmark.py "
                         "(36 avg rows over 2 scenes x 2 renderers)")
    ap.add_argument("--renderers", nargs="*",
                    default=["megakernel", "wavefront"])
    ap.add_argument("--timeout", type=int, default=3600,
                    help="per-run subprocess timeout (s)")
    ap.add_argument("--inproc", action="store_true",
                    help="render in-process instead of one CLI "
                         "subprocess per run (shares compilations "
                         "across the whole sweep; see run_once_inproc)")
    ap.add_argument("--devices", type=int, default=1,
                    help="shard every run over this many devices "
                         "(sample-axis mesh; parallel/mesh.py)")
    ap.add_argument("--append", action="store_true",
                    help="keep existing CSV rows; new rows replace "
                         "only matching (renderer, scene, res, depth, "
                         "samples) configs — for adding resolution "
                         "subsets without redoing the whole matrix")
    args = ap.parse_args()
    ctx = {}
    # In subprocess mode the parent never opens a backend, so each
    # child CLI process has the card to itself.
    if args.inproc:
        from sycl_ray_tracer_tpu.utils.runtime import (
            configure_compile_cache)

        configure_compile_cache()

    if args.pairs:
        pairs = [tuple(int(x) for x in p.split(":")) for p in args.pairs]
    elif args.full:
        # verbatim reference depth_samples list, including its
        # duplicated (10, 128) row (benchmark.py:6-19)
        pairs = [(10, 128), (20, 128), (30, 128), (40, 128), (50, 128),
                 (10, 32), (10, 128), (10, 256), (10, 512)]
    else:
        pairs = [(d, s) for d in args.depths for s in args.samples]
    # the reference's matrix lists 10:128 on both sweep axes; running
    # it twice would append two avg rows for one config (the round-3
    # CSVs shipped with such duplicates) — measure each config once
    pairs = list(dict.fromkeys(pairs))
    resolutions = [tuple(int(x) for x in r.split("x"))
                   for r in args.resolutions] if args.resolutions \
        else [(args.width, args.height)]

    raw_rows = []
    avg_rows = []
    old_raw, old_avg = ([], [])
    if args.append:
        old_raw, old_avg = _read_csvs()
    # wavefront groups run first: they are ~5x faster, so an
    # interrupted sweep retains the most rows (CSVs rewrite per config)
    for renderer, flag in (("wavefront", "-w"), ("megakernel", "-m")):
        if renderer not in args.renderers:
            continue
        for scene in args.scenes:
            for width, height in resolutions:
                res = f"{width}x{height}"
                for d, s in pairs:
                    per_run = []
                    # buffered per config: committed to raw_rows only
                    # if a measured run lands, so a config that fails
                    # after its warm-up leaves NO raw rows — otherwise
                    # the stray warm-up row evicts the config's old
                    # raw rows under --append while its nan avg row
                    # (filtered by _merge) keeps the old avg row, and
                    # the two CSVs contradict each other
                    cfg_raw = []
                    try:
                        for r in range(args.runs + 1):
                            if args.inproc:
                                t, total, mrays = run_once_inproc(
                                    ctx, scene, renderer, d, s,
                                    width, height, seed=r,
                                    devices=args.devices)
                            else:
                                t, total, mrays = run_once(
                                    scene, flag, d, s, width,
                                    height, timeout=args.timeout,
                                    seed=r, devices=args.devices)
                            print(f"{scene} {renderer} {res} d={d} "
                                  f"s={s} run={r}: {mrays:.2f} Mrays/s"
                                  + (" (warm-up, discarded)"
                                     if r == 0 else ""), flush=True)
                            row = [renderer, scene, res,
                                   d, s, r, t, mrays, total]
                            cfg_raw.append(row)
                            if r > 0:
                                per_run.append((t, mrays, total))
                    except (RuntimeError,
                            subprocess.TimeoutExpired) as e:
                        # keep sweeping; a failed config gets a nan row
                        print(f"{scene} {renderer} {res} d={d} s={s} "
                              f"FAILED: {str(e)[:200]}", flush=True)
                    if per_run:
                        raw_rows.extend(cfg_raw)
                        warn = _stall_warning(per_run)
                        if warn:
                            print(f"{scene} {renderer} {res} d={d} "
                                  f"s={s} {warn}", flush=True)
                        avg_rows.append([
                            renderer, scene, res, d, s,
                            statistics.mean(x[0] for x in per_run),
                            statistics.mean(x[1] for x in per_run),
                            statistics.mean(x[2] for x in per_run),
                        ])
                    else:
                        avg_rows.append([renderer, scene, res,
                                         d, s, "nan", "nan", "nan"])
                    # rewrite CSVs after EVERY config: a multi-hour
                    # sweep that dies mid-way leaves finished rows
                    _write_csvs(_merge(old_raw, raw_rows),
                                _merge(old_avg, avg_rows))

    _write_csvs(_merge(old_raw, raw_rows), _merge(old_avg, avg_rows))
    print("wrote benchmark_raw.csv, benchmark_avg.csv")


def _stall_warning(per_run):
    """Flag a timed run whose wall time is wildly off its siblings.

    A run that stalls (a busy host, a throttled card) makes the mean
    record neither the device's rate nor the stall. The methodology
    stays mean-of-runs (matching the reference's benchmark.py
    averaging) — this only makes the pollution loud so
    the config gets re-measured instead of shipped.

    Returns a warning string, or None if the spread is normal.
    """
    times = [x[0] for x in per_run]
    if len(times) < 2 or min(times) <= 0:
        return None
    ratio = max(times) / min(times)
    if ratio <= 2.0:
        return None
    return (f"WARNING: run time spread {ratio:.1f}x "
            f"(min {min(times):.1f}s, max {max(times):.1f}s) — "
            f"likely a device stall; re-measure this config "
            f"(--append replaces its rows)")


def _merge(old_rows, new_rows):
    """Old rows first, minus any whose (renderer, scene, res, depth,
    samples) config was re-measured in this sweep.

    A FAILED config (nan row) never evicts previously measured data:
    a transient failure under --append must not destroy a good row
    (and would leave avg/raw CSVs contradicting each other, since the
    failed config produced no raw rows)."""
    def k(r):
        return tuple(str(x) for x in r[:5])

    def is_nan(r):
        return str(r[5]) == "nan"

    if not old_rows:
        return new_rows
    old_keys = {k(r) for r in old_rows}
    new_rows = [r for r in new_rows
                if not (is_nan(r) and k(r) in old_keys)]
    redone = {k(r) for r in new_rows}
    kept = [r for r in old_rows if k(r) not in redone]
    return kept + new_rows


def _read_csvs():
    """Existing CSV rows (raw, avg), tolerant of the pre-round-3
    7/8-column schema (no res column): legacy rows get res=512x512,
    the resolution every checked-in round-2 row was measured at."""
    out = []
    for path, ncols in (("benchmark_raw.csv", 9),
                        ("benchmark_avg.csv", 8)):
        rows = []
        try:
            with open(path, newline="") as f:
                for i, row in enumerate(csv.reader(f)):
                    if i == 0 or not row:
                        continue
                    if len(row) == ncols - 1:
                        row = row[:2] + ["512x512"] + row[2:]
                    rows.append(row)
        except FileNotFoundError:
            pass
        out.append(rows)
    return out[0], out[1]


def _write_csvs(raw_rows, avg_rows):
    with open("benchmark_raw.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["renderer", "scene", "res", "depth", "samples",
                    "run", "time_s", "mrays_per_sec", "total_rays"])
        w.writerows(raw_rows)
    with open("benchmark_avg.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["renderer", "scene", "res", "depth", "samples",
                    "time_s", "mrays_per_sec", "total_rays"])
        w.writerows(avg_rows)


if __name__ == "__main__":
    main()
