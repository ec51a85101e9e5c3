"""CLI driver with the reference's flags and stdout contract.

Parity target: main.cpp:8-77 plus the three benchmark-scraped lines
(render_megakernel.cpp:181-183 / render_wavefront.cpp:425-427):

    Time measured: {:.6f} seconds
    Total rays: {}
    Rays/sec: {:.2f}M

Flags match main.cpp:11-28 (-d/--max-depth default 10, -s/--sample-count
default 32, -m, -w with wavefront as the default renderer, positional
scene path defaulting to ./assets/sponza.glb). Deviation (documented):
--width/--height lift the reference's hardcoded 1920x1080 (main.cpp:36)
because BASELINE.json benchmarks at 1024x1024; defaults stay 1920x1080.
Additions: --seed, --output, --devices (multi-chip sample sharding),
procedural scene names (sponza_proc / minecraft_proc / triangle / cube /
dielectric) for when no .glb is at hand.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


DEFAULT_SCENE = "./assets/sponza.glb"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sycl_ray_tracer_tpu",
        description="Monte-Carlo path tracer (JAX)")
    p.add_argument("scene_path", nargs="?", default=DEFAULT_SCENE,
                   help="path to .glb, or a procedural name: sponza_proc, "
                        "minecraft_proc, triangle, cube, dielectric")
    p.add_argument("-d", "--max-depth", type=int, default=10)
    p.add_argument("-s", "--sample-count", type=int, default=32)
    p.add_argument("-m", "--megakernel", action="store_true",
                   help="use megakernel renderer")
    p.add_argument("-w", "--wavefront", action="store_true",
                   help="use wavefront renderer (default)")
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--rr", action="store_true",
                   help="russian-roulette path termination (unbiased; "
                        "extension over the reference)")
    p.add_argument("--scale", type=float, nargs=3, default=(1.0, 1.0, 1.0),
                   metavar=("SX", "SY", "SZ"),
                   help="global scene scale (Scene ctor's global_scale)")
    p.add_argument("-o", "--output", default="out.png")
    p.add_argument("--devices", type=int, default=1,
                   help="shard samples over this many devices")
    p.add_argument("--warmup", action="store_true",
                   help="run one untimed warmup frame first (XLA compile)")
    return p


def resolve_scene_bytes(scene_path: str):
    from sycl_ray_tracer_tpu.utils import fixtures, procgen

    named = {
        "triangle": fixtures.triangle_scene_glb,
        "cube": fixtures.cube_scene_glb,
        "dielectric": fixtures.dielectric_scene_glb,
        "sponza_proc": procgen.sponza_like_glb,
        "minecraft_proc": procgen.minecraft_like_glb,
        # instance-heavy fixture (SRT_INSTANCED_R cubes, baked)
        "instanced_proc": lambda: fixtures.instanced_scene_glb(
            int(os.environ.get("SRT_INSTANCED_R", "1000"))),
    }
    if scene_path in named:
        return named[scene_path]()
    if not os.path.exists(scene_path):
        # The reference's default is ./assets/sponza.glb, an asset it
        # does not ship (.gitignore:4). So a bare invocation works out
        # of the box, the un-overridden default falls back to the
        # procedural Sponza stand-in instead of erroring.
        if scene_path == DEFAULT_SCENE:
            print(f"note: {scene_path} not found; using procedural "
                  f"stand-in 'sponza_proc'")
            return procgen.sponza_like_glb()
        raise SystemExit(
            f"error: scene not found: {scene_path} "
            f"(procedural names: {', '.join(sorted(named))})")
    with open(scene_path, "rb") as f:
        return f.read()


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # Both flags set -> megakernel, matching main.cpp:58 (the -m branch
    # is checked first there).
    use_megakernel = args.megakernel

    import jax

    from sycl_ray_tracer_tpu.utils.runtime import configure_compile_cache

    # Persistent compile cache: the analog of the reference's
    # SYCL_CACHE_PERSISTENT JIT cache (app.hpp:21-29).
    configure_compile_cache()

    print(f"Loading scene: {args.scene_path}")
    import numpy as np

    from sycl_ray_tracer_tpu.models.camera import make_camera
    from sycl_ray_tracer_tpu.models.scene import build_device_scene
    from sycl_ray_tracer_tpu.utils.gltf import load_glb
    from sycl_ray_tracer_tpu.utils.image_io import write_png

    scene_bytes = resolve_scene_bytes(args.scene_path)
    host = load_glb(scene_bytes, global_scale=tuple(args.scale))
    print(f"Triangles: {host.num_triangles}")
    scene = build_device_scene(host)
    cam = make_camera(args.width, args.height, host.camera_position,
                      host.camera_direction, host.camera_focal_length)

    kw = dict(width=args.width, height=args.height,
              spp=args.sample_count, max_depth=args.max_depth,
              seed=args.seed)
    if args.rr:
        kw["rr"] = True

    renderer_name = "megakernel" if use_megakernel else "wavefront"
    if args.devices > 1:
        from sycl_ray_tracer_tpu.parallel.mesh import make_mesh, render_sharded
        mesh = make_mesh(dp=args.devices)

        def run(**ov):
            return render_sharded(scene, cam, mesh=mesh,
                                  renderer=renderer_name, **{**kw, **ov})
    else:
        from sycl_ray_tracer_tpu.models.renderer import get_renderer
        renderer = get_renderer(renderer_name)

        def run(**ov):
            return renderer(scene, cam, **{**kw, **ov})

    if args.warmup:
        # same frame as the timed one, so every program it needs is
        # compiled before the clock starts
        jax.block_until_ready(run())

    # SRT_TRACE_DIR=<dir> captures a JAX profiler trace of the timed
    # render (view with tensorboard / xprof) — the deep version of the
    # reference's dormant per-phase profiler
    # (render_wavefront.cpp:129-137); SRT_PROFILE=1 remains the
    # lightweight per-bounce wall clock.
    trace_dir = os.environ.get("SRT_TRACE_DIR")
    if trace_dir:
        jax.profiler.start_trace(trace_dir)

    begin = time.perf_counter()
    img, rays = jax.block_until_ready(run())
    img = np.asarray(img)
    total_rays = int(np.asarray(rays).astype(np.int64).sum())
    secs = time.perf_counter() - begin
    if trace_dir:
        jax.profiler.stop_trace()
    print(f"Time measured: {secs:.6f} seconds")
    print(f"Total rays: {total_rays}")
    print(f"Rays/sec: {total_rays / secs / 1e6:.2f}M")

    print("Writing image to disk")
    write_png(args.output, np.asarray(img))
    return 0


if __name__ == "__main__":
    sys.exit(main())
