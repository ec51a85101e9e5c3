"""sycl_ray_tracer_tpu — a Monte-Carlo path-tracing framework in JAX.

A ground-up JAX/XLA re-design of the capabilities of
felipeagc/sycl-ray-tracer (C++17 / SYCL / Embree 4), with one CUDA
kernel (the per-ray BVH walk) called through the XLA FFI on a GPU:

- glTF binary (.glb) ingest -> flat structure-of-arrays device scene
  (replaces tiny_gltf + Embree two-level instancing; instances are baked
  into world space at load, ref: scene.cpp:444-510).
- Morton-ordered implicit 8-wide BVH (ops/wbvh.py) replacing Embree's
  BVH, walked per ray by the CUDA kernel (native/srt_traverse.cu) on a
  GPU and by its batched XLA twin elsewhere.
- Two renderers behind one protocol (ref: render.hpp:11-18):
  * megakernel: one jitted program, sample loop x masked bounce loop
    (ref: render_megakernel.cpp:20-63).
  * wavefront: bounce-synchronous lax.scan over compacted ray queues
    (ref: render_wavefront.cpp:396-431); compaction is a scan-based
    (cumsum+scatter) rewrite of the reference's work-group atomic staging
    (render_wavefront.cpp:162-311).
- Counter-based PCG RNG replacing the stateful xorshift32 + per-pixel
  RNG-state buffer (ref: xorshift.hpp:8-49, render_wavefront.cpp:48-77).
- Multi-device scaling via jax.sharding.Mesh: samples are sharded across
  devices and accumulated with psum (the reference is single-device).

No code is copied from the reference; file:line citations exist so
behavioral parity can be audited.
"""

__version__ = "0.1.0"

from sycl_ray_tracer_tpu.models.scene import DeviceScene, build_device_scene
from sycl_ray_tracer_tpu.models.camera import Camera, make_camera
from sycl_ray_tracer_tpu.models.megakernel import render_megakernel
from sycl_ray_tracer_tpu.models.wavefront import render_wavefront
from sycl_ray_tracer_tpu.utils.gltf import load_glb

__all__ = [
    "DeviceScene",
    "build_device_scene",
    "Camera",
    "make_camera",
    "render_megakernel",
    "render_wavefront",
    "load_glb",
]
