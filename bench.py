#!/usr/bin/env python
"""Headline benchmark: Sponza-class scene, wavefront, 1024x1024.

The configuration of BASELINE.json's primary metric (wavefront,
1024x1024, 64 spp). The real sponza.glb is not distributed with the
reference (.gitignore:4), so a procedural atrium at the same triangle
scale (~250K) stands in; see sycl_ray_tracer_tpu/utils/procgen.py.

Prints ONE json line:
  {"metric": ..., "value": N, "unit": "Mrays/s", "runs": [...],
   "spread": N, "device": {...}, "cards": [[name, power limit], ...]}

Methodology mirrors the reference's benchmark.py: run 0 discarded
(XLA compile, the analog of SYCL JIT warm-up), remaining runs averaged.
"""

import json
import os
import sys
import time

# spp 64 = BASELINE.json's own Sponza config ("64 spp at 1024x1024")
SPP = int(os.environ.get("BENCH_SPP", 64))
DEPTH = int(os.environ.get("BENCH_DEPTH", 10))
RES = int(os.environ.get("BENCH_RES", 1024))
RUNS = int(os.environ.get("BENCH_RUNS", 3))
SCALE = int(os.environ.get("BENCH_SCENE_SCALE", 2))


def main():
    import numpy as np

    from sycl_ray_tracer_tpu.utils.runtime import (configure_compile_cache,
                                                   gpu_cards)

    cards = gpu_cards()
    import jax

    configure_compile_cache()

    from sycl_ray_tracer_tpu.models.camera import make_camera
    from sycl_ray_tracer_tpu.models.scene import build_device_scene
    from sycl_ray_tracer_tpu.models.wavefront import render_wavefront
    from sycl_ray_tracer_tpu.utils.gltf import load_glb
    from sycl_ray_tracer_tpu.utils.procgen import sponza_like_glb

    # Backend bring-up is not scene build — the reference's Embree
    # commit timing doesn't include SYCL device discovery either
    # (app.hpp vs scene.cpp:107).
    dev = jax.devices()[0]

    t0 = time.perf_counter()
    host = load_glb(sponza_like_glb(scale=SCALE))
    scene = jax.block_until_ready(build_device_scene(host))
    cam = make_camera(RES, RES, host.camera_position,
                      host.camera_direction, host.camera_focal_length)
    print(f"# scene: {host.num_triangles} tris, build "
          f"{time.perf_counter() - t0:.1f}s, device {dev.device_kind}",
          file=sys.stderr)

    def run(seed):
        img, rays = jax.block_until_ready(render_wavefront(
            scene, cam, width=RES, height=RES, spp=SPP, max_depth=DEPTH,
            seed=seed))
        return img, int(np.asarray(rays).astype(np.int64).sum())

    run(0)  # warm-up (compile), discarded like the reference's run 0

    rates = []
    for i in range(RUNS):
        t = time.perf_counter()
        _, total = run(i)
        dt = time.perf_counter() - t
        rates.append(total / dt / 1e6)
        print(f"# run {i}: {total} rays in {dt:.3f}s = {rates[-1]:.1f} "
              f"Mrays/s", file=sys.stderr)

    value = float(np.mean(rates))
    print(json.dumps({
        "metric": f"Mrays/s sponza_proc({host.num_triangles}tris) "
                  f"wavefront {RES}x{RES} spp{SPP} d{DEPTH}",
        "value": round(value, 2),
        "unit": "Mrays/s",
        "runs": [round(r, 2) for r in rates],
        "spread": round(float(np.max(rates) - np.min(rates)), 2),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "cards": [list(c) for c in cards],
    }))


if __name__ == "__main__":
    main()
