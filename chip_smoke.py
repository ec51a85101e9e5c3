#!/usr/bin/env python
"""Smoke test of the path tracer on NVIDIA GPUs.

    python chip_smoke.py             # one card: every phase below
    python chip_smoke.py --cards 4   # four cards: only the sharded renders

Phases (each prints its own lines; any failure exits non-zero):

1. device   -- the cards' name and power limit (nvidia-smi, in a child).
2. build    -- the native loader and the CUDA traversal library.
3. tests    -- `pytest -m gpu` in a child, before this process opens
               the card (one JAX process per card at a time).
4. kernel   -- the CUDA walk against its plain twin (XLA traverse8) on
               sponza_proc: ~1M camera rays and ~1M first-bounce rays.
5. render   -- sponza_proc 1024^2 (wavefront and megakernel) and
               minecraft_proc 1024^2 (wavefront), each with the kernel
               and with traverse8, same seed, images within the
               repo's oracle gate (2e-3 RMSE, models/oracle.py).
6. oracle   -- triangle, cube and dielectric (russian roulette) on the
               card against the numpy oracle; the RNG against numpy.
7. sharded  -- (--cards 4 only) render_sharded, both engines, at dp=4
               and dp=2 x sp=2 against the one-card render.

There is no CPU fallback: without a GPU the script fails. The last line
of stdout is one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
RES = 1024
DEPTH = 10
# kernel-vs-twin gates (phase 4); phase 5 holds the two walks' images
# to the repo's oracle gate (models/oracle.py oracle_gate: 2e-3 RMSE
# past a bounded tail of paths that one near-tie sent elsewhere), and
# phase 7 the sharded images to SHARDED_RMSE
T_RTOL = 1e-5
# An id mismatch must be an exact tie: the planes of both triangles
# cross the ray at one distance up to float32 rounding. (sponza_proc has
# such ties by the hundred: wall stripes lie on the walls, coplanar.)
T_TIE = 1e-6
TRI_AGREE_MIN = 0.9999
SHARDED_RMSE = 1e-5


class PhaseFailed(RuntimeError):
    pass


def say(msg: str = "") -> None:
    print(msg, flush=True)


def phase(name: str) -> None:
    say(f"== {name}")


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise PhaseFailed(msg)


def result_line(dev_platform: str, kind: str, count: int) -> str:
    """The contract line printed last."""
    return json.dumps({"ok": True, "device": {
        "platform": dev_platform, "kind": kind, "count": count}})


# ---------------------------------------------------------------- phase 4

def slot_triangles(nodes, num_internal: int, leaf_size: int, slots):
    """(v0, e1, e2), each [N, 3] float64, of sorted triangle slots,
    read back from the WBVH8 leaf rows (ops/wbvh.py layout)."""
    import numpy as np

    k = leaf_size
    rows = np.asarray(nodes)[num_internal + slots // k][:, :9 * k]
    comp = rows.reshape(-1, 9, k)[np.arange(len(slots)), :, slots % k]
    comp = comp.astype(np.float64)
    return comp[:, 0:3], comp[:, 3:6], comp[:, 6:9]


def plane_t64(o, d, v0, e1, e2):
    """Distance along each ray to its triangle's plane, in float64."""
    import numpy as np

    n = np.cross(e1, e2)
    with np.errstate(divide="ignore", invalid="ignore"):
        return ((n * (v0 - o)).sum(-1)) / (n * d).sum(-1)


def compare_hits(plain, kernel, nodes, num_internal: int, leaf_size: int,
                 o, d, active) -> dict:
    """Kernel hits against the plain twin's. plain/kernel: (t, tri)
    numpy pairs; o, d: [R, 3]; active: [R] bool. Hit vs miss must
    agree exactly, t within T_RTOL, triangle ids on >= TRI_AGREE_MIN
    of the hits, and every id mismatch must be a tie: the planes of
    both triangles cross the ray at the same distance (float64, within
    T_TIE), so which one holds the hit point (a shared edge, or
    coplanar overlapping triangles) is a decision that float32
    rounding may take either way."""
    import numpy as np

    t_p, tri_p = (np.asarray(a) for a in plain)
    t_k, tri_k = (np.asarray(a) for a in kernel)
    hit_p, hit_k = tri_p >= 0, tri_k >= 0
    both = hit_p & hit_k
    n_hits = int(both.sum())
    rel = np.abs(t_p[both] - t_k[both]) / np.maximum(np.abs(t_p[both]),
                                                     1e-30)
    diff = np.nonzero(both & (tri_p != tri_k))[0]
    ties, detail = 0, []
    if len(diff):
        ta = plane_t64(o[diff], d[diff], *slot_triangles(
            nodes, num_internal, leaf_size, tri_p[diff]))
        tb = plane_t64(o[diff], d[diff], *slot_triangles(
            nodes, num_internal, leaf_size, tri_k[diff]))
        ties = int((np.abs(ta - tb) <= T_TIE * np.abs(ta)).sum())
        detail = [dict(ray=int(i), slot_xla=int(tri_p[i]),
                       slot_kernel=int(tri_k[i]), t_xla=float(t_p[i]),
                       t_kernel=float(t_k[i]), plane_t64_xla=float(a),
                       plane_t64_kernel=float(b))
                  for i, a, b in list(zip(diff, ta, tb))[:5]]
    out = dict(
        rays=int(np.asarray(active).sum()), hits=n_hits,
        hit_miss_mismatch=int((hit_p != hit_k).sum()),
        inactive_hits=int((hit_k & ~np.asarray(active)).sum()),
        t_max_rel=float(rel.max()) if n_hits else 0.0,
        tri_mismatch=len(diff), tri_mismatch_ties=ties,
        tri_agree=(1.0 - len(diff) / n_hits) if n_hits else 1.0,
        mismatches=detail)
    out["ok"] = (out["hit_miss_mismatch"] == 0
                 and out["inactive_hits"] == 0
                 and out["t_max_rel"] <= T_RTOL
                 and out["tri_agree"] >= TRI_AGREE_MIN
                 and ties == len(diff))
    return out


def warm_seconds(fn, *args, reps: int = 5) -> float:
    """Median wall time of warm calls, each ending in
    block_until_ready."""
    import statistics

    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def load_scene(name: str, intersector: str = "auto"):
    from sycl_ray_tracer_tpu.models.camera import make_camera
    from sycl_ray_tracer_tpu.models.scene import build_device_scene
    from sycl_ray_tracer_tpu.utils.cli import resolve_scene_bytes
    from sycl_ray_tracer_tpu.utils.gltf import load_glb

    import jax

    t0 = time.perf_counter()
    host = load_glb(resolve_scene_bytes(name))
    scene = jax.block_until_ready(
        build_device_scene(host, intersector=intersector))
    cam = make_camera(RES, RES, host.camera_position,
                      host.camera_direction, host.camera_focal_length)
    say(f"{name}: {host.num_triangles} triangles, bvh_nodes "
        f"{scene.bvh_nodes.shape} ({scene.bvh_nodes.nbytes / 1e6:.1f} MB), "
        f"load+build {time.perf_counter() - t0:.1f} s")
    return scene, host, cam


def phase_kernel(scene, cam) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from sycl_ray_tracer_tpu.models import wavefront as wf
    from sycl_ray_tracer_tpu.models.trace import intersect_scene
    from sycl_ray_tracer_tpu.ops.vec import V3

    n = RES * RES
    plain = dataclasses.replace(scene, intersector="xla")
    _, state = wf._gen_queue(plain, cam, 0, 0, width=RES, height=RES,
                             return_keys=False)
    cam_rays = (V3(*state[0:3]), V3(*state[3:6]), jnp.ones((n,), bool))
    # one real wavefront bounce through the plain walk: the compacted,
    # coherence-sorted survivors are the first-bounce rays
    _, state2 = wf._gen_queue(plain, cam, 0, 0, width=RES, height=RES,
                              return_keys=False)
    key_seed = (jnp.uint32(0), jnp.uint32(0), jnp.uint32(0))
    st, _ = wf._bounce_step(plain, state2, key_seed, 0, capacity=n)
    live = int(st[13])
    bounce_rays = (V3(*st[0:3]), V3(*st[3:6]),
                   jnp.arange(n, dtype=jnp.int32) < live)

    def walk(kind):
        s = dataclasses.replace(scene, intersector=kind)
        return jax.jit(lambda o, d, a: intersect_scene(s, o, d, active=a))

    f_plain, f_kernel = walk("xla"), walk("cuda")
    nodes = np.asarray(scene.bvh_nodes)
    for name, (o, d, a) in (("camera", cam_rays), ("bounce-1", bounce_rays)):
        hp = jax.block_until_ready(f_plain(o, d, a))
        hk = jax.block_until_ready(f_kernel(o, d, a))
        o_np = np.stack([np.asarray(c) for c in o], -1).astype(np.float64)
        d_np = np.stack([np.asarray(c) for c in d], -1).astype(np.float64)
        r = compare_hits((hp.t, hp.tri), (hk.t, hk.tri), nodes,
                         scene.bvh_ni, scene.leaf_size, o_np, d_np,
                         np.asarray(a))
        tp = warm_seconds(f_plain, o, d, a)
        tk = warm_seconds(f_kernel, o, d, a)
        say(f"{name} rays: {json.dumps(r)}")
        say(f"{name} rays: warm walk time xla traverse8 {tp * 1e3:.3f} ms, "
            f"cuda kernel {tk * 1e3:.3f} ms ({tp / tk:.1f}x)")
        check(r["ok"], f"kernel disagrees with traverse8 on {name} rays")


# ---------------------------------------------------------------- phase 5

def render_both(label, scene, cam, engine: str, spp: int, dev) -> None:
    import jax
    import numpy as np

    from sycl_ray_tracer_tpu.models.oracle import oracle_gate
    from sycl_ray_tracer_tpu.models.renderer import get_renderer

    render = get_renderer(engine)
    imgs = {}
    for kind in ("cuda", "xla"):
        s = dataclasses.replace(scene, intersector=kind)
        kw = dict(width=RES, height=RES, spp=spp, max_depth=DEPTH, seed=0)
        t0 = time.perf_counter()
        jax.block_until_ready(render(s, cam, **kw))
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        img, rays = jax.block_until_ready(render(s, cam, **kw))
        warm = time.perf_counter() - t0
        total = int(np.asarray(rays).astype(np.int64).sum())
        img = np.asarray(img)
        check(img.shape == (RES, RES, 3) and np.isfinite(img).all(),
              f"{label} {kind}: bad image")
        imgs[kind] = img
        peak = (dev.memory_stats() or {}).get("peak_bytes_in_use", 0)
        say(f"{label} {engine} spp{spp} d{DEPTH} walk={kind}: "
            f"{total / warm / 1e6:.3f} Mrays/s, frame {warm:.3f} s, "
            f"compile ~{max(cold - warm, 0.0):.1f} s (first call "
            f"{cold:.1f} s), {total} rays, process peak "
            f"{peak / 2**30:.2f} GiB")
    g = oracle_gate(imgs["cuda"], imgs["xla"])
    say(f"{label} {engine}: kernel vs traverse8 image gate {json.dumps(g)}")
    check(g["ok"], f"{label} {engine}: images differ ({g})")


def bounce_memory(scene, cam) -> None:
    import jax.numpy as jnp

    from sycl_ray_tracer_tpu.models import wavefront as wf

    n = RES * RES
    _, state = wf._gen_queue(scene, cam, 0, 0, width=RES, height=RES,
                             return_keys=False)
    key_seed = (jnp.uint32(0), jnp.uint32(0), jnp.uint32(0))
    comp = wf._bounce_step.lower(scene, state, key_seed, 0,
                                 capacity=n).compile()
    say(f"bounce program (1M-ray bucket) memory_analysis: "
        f"{comp.memory_analysis()}")


# ---------------------------------------------------------------- phase 6

def phase_oracle() -> None:
    import jax.numpy as jnp
    import numpy as np

    from sycl_ray_tracer_tpu.models.oracle import oracle_gate, render_oracle
    from sycl_ray_tracer_tpu.models.renderer import get_renderer
    from sycl_ray_tracer_tpu.ops import rng
    from sycl_ray_tracer_tpu.utils import fixtures

    cases = [  # BASELINE.json configs 1-3
        ("triangle", fixtures.triangle_scene_glb(), 256, 1, 5, False),
        ("cube", fixtures.cube_scene_glb(), 256, 4, 8, False),
        ("dielectric", fixtures.dielectric_scene_glb(subdiv=1), 128, 16,
         12, True),
    ]
    for name, glb, res, spp, depth, rr in cases:
        scene, host, cam = fixtures.load_pair(glb, res, res)
        kw = dict(width=res, height=res, spp=spp, max_depth=depth, seed=0,
                  rr=rr)
        ref = render_oracle(host, cam, **kw)
        for engine in ("megakernel", "wavefront"):
            img, _ = get_renderer(engine)(scene, cam, **kw)
            g = oracle_gate(np.asarray(img), ref)
            say(f"oracle {name} {res}^2 spp{spp} d{depth} rr={rr} "
                f"{engine}: {json.dumps(g)}")
            check(g["ok"], f"oracle gate failed: {name} {engine}")
    lanes = np.arange(1 << 20, dtype=np.uint32)
    k_np = rng.make_key_np(np.uint32(7), lanes)
    k_dev = np.asarray(rng.make_key(jnp.uint32(7), jnp.asarray(lanes)))
    u_np = rng.uniform_np(k_np, np.uint32(5))
    u_dev = np.asarray(rng.uniform(jnp.asarray(k_np), 5))
    same = bool((k_np == k_dev).all() and (u_np.view(np.uint32)
                                           == u_dev.view(np.uint32)).all())
    say(f"rng: 1M keys and uniforms bit-identical to numpy: {same}")
    check(same, "counter RNG differs from numpy")


# ---------------------------------------------------------------- phase 7

def phase_sharded(n_cards: int) -> None:
    import jax
    import numpy as np

    from sycl_ray_tracer_tpu.models.oracle import rmse
    from sycl_ray_tracer_tpu.models.renderer import get_renderer
    from sycl_ray_tracer_tpu.parallel.mesh import (make_mesh, render_sharded,
                                                   replicate)

    check(len(jax.devices()) >= n_cards,
          f"need {n_cards} GPUs, JAX sees {len(jax.devices())}")
    scene, _, cam = load_scene("sponza_proc")
    spp = 8
    kw = dict(width=RES, height=RES, spp=spp, max_depth=DEPTH, seed=0)

    def timed(fn):
        jax.block_until_ready(fn())
        t0 = time.perf_counter()
        img, rays = jax.block_until_ready(fn())
        dt = time.perf_counter() - t0
        total = int(np.asarray(rays).astype(np.int64).sum())
        return np.asarray(img), total, dt

    for dp, sp in ((n_cards, 1), (2, n_cards // 2)):
        mesh = make_mesh(dp=dp, sp=sp)
        placed = replicate(scene, mesh)
        devs = set(mesh.devices.flat)
        for leaf in jax.tree_util.tree_leaves(placed):
            check({s.device for s in leaf.addressable_shards} == devs,
                  "scene not replicated onto every card")
        used = [(d.memory_stats() or {}).get("bytes_in_use", 0)
                for d in sorted(devs, key=lambda d: d.id)]
        say(f"mesh dp={dp} sp={sp}: scene on cards "
            f"{sorted(d.id for d in devs)}, bytes in use per card "
            f"{used} (scene {placed.bvh_nodes.nbytes} B of nodes)")
        check(all(u >= placed.bvh_nodes.nbytes for u in used),
              "a card holds less than the scene's node table")

    for engine in ("wavefront", "megakernel"):
        render = get_renderer(engine)
        one, total1, t1 = timed(lambda: render(scene, cam, **kw))
        say(f"one card {engine} sponza_proc spp{spp} d{DEPTH}: "
            f"{total1 / t1 / 1e6:.3f} Mrays/s, frame {t1:.3f} s")
        for dp, sp in ((n_cards, 1), (2, n_cards // 2)):
            mesh = make_mesh(dp=dp, sp=sp)
            img, total, dt = timed(lambda: render_sharded(
                scene, cam, mesh=mesh, renderer=engine, **kw))
            e = rmse(img, one)
            say(f"{n_cards} cards dp={dp} sp={sp} {engine}: "
                f"{total / dt / 1e6:.3f} Mrays/s, frame {dt:.3f} s, "
                f"{dt and t1 / dt:.2f}x one card, RMSE vs one card {e:.3g}, "
                f"rays {total} vs {total1}")
            check(e <= SHARDED_RMSE,
                  f"sharded {engine} dp={dp} sp={sp} differs (RMSE {e})")
            check(total == total1, "sharded ray count differs")


# ------------------------------------------------------------------ main

def run_phases(args) -> str:
    from sycl_ray_tracer_tpu.utils.runtime import gpu_cards

    phase("1 device")
    cards = gpu_cards()
    check(bool(cards), "nvidia-smi finds no NVIDIA GPU")
    for name, limit in cards:
        say(f"card: {name}, {limit}")
    check(len(cards) >= args.cards,
          f"--cards {args.cards} but nvidia-smi lists {len(cards)}")

    phase("2 build")
    t0 = time.perf_counter()
    mk = subprocess.run(["make", "-C", os.path.join(HERE, "native"),
                         "all", "cuda"], capture_output=True, text=True)
    say(mk.stdout[-2000:] + mk.stderr[-4000:])
    check(mk.returncode == 0, "native build failed")
    say(f"built native/build/ in {time.perf_counter() - t0:.1f} s")

    if args.cards == 1:
        phase("3 card-only tests (pytest -m gpu, child process)")
        env = dict(os.environ, JAX_PLATFORMS="cuda")
        pt = subprocess.run(
            [sys.executable, "-m", "pytest", "-m", "gpu", "-q",
             "-p", "no:cacheprovider", "tests"], cwd=HERE, env=env)
        check(pt.returncode == 0, f"pytest -m gpu exit code {pt.returncode}")

    import jax

    from sycl_ray_tracer_tpu.utils.runtime import configure_compile_cache

    configure_compile_cache()
    devs = jax.devices()
    dev = devs[0]
    say(f"jax: platform={dev.platform} device_kind={dev.device_kind} "
        f"count={len(devs)}")
    check(dev.platform == "gpu", f"JAX's first device is {dev.platform}, "
          "not a GPU")

    if args.cards > 1:
        phase(f"7 sharded renders on {args.cards} cards")
        phase_sharded(args.cards)
    else:
        scene, _, cam = load_scene("sponza_proc")
        phase("4 kernel vs traverse8 (sponza_proc)")
        phase_kernel(scene, cam)
        phase("5 end-to-end renders")
        render_both("sponza_proc", scene, cam, "wavefront", 8, dev)
        render_both("sponza_proc", scene, cam, "megakernel", 8, dev)
        bounce_memory(scene, cam)
        del scene
        mc, _, mc_cam = load_scene("minecraft_proc")
        render_both("minecraft_proc", mc, mc_cam, "wavefront", 4, dev)
        del mc
        phase("6 oracle and RNG")
        phase_oracle()

    for name, limit in cards:
        say(f"{name}, {limit}")
    return result_line(dev.platform, dev.device_kind, len(devs))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded renders on four cards")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    try:
        line = run_phases(args)
    except PhaseFailed as e:
        print(f"FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
