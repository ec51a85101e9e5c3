"""The CUDA traversal kernel (native/srt_traverse.cu) as a JAX op.

One thread per ray walks the WBVH8 implicit heap (`bvh_nodes`, see
ops/wbvh.py) with a private trail of pending-sibling masks and runs
closest-hit Moller-Trumbore at the leaves. `wbvh.traverse8` is its
plain twin: the same table, visit order and arithmetic (reciprocals
included: see the .cu file), so both return bit-identical t and the
same closest hit.

The library is built from the tracked source into native/build/ by
`make -C native cuda` (nvcc, sm_90a), on first use when it is missing
or older than its source. A failed build or load raises: a GPU run
never falls back to the plain walk silently.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import jax
import jax.numpy as jnp
import numpy as np

from sycl_ray_tracer_tpu.ops.intersect import Hit
from sycl_ray_tracer_tpu.ops.vec import V3

TARGET = "srt_traverse8"
# The kernel packs one 8-bit pending mask per level into a uint64
# (8 levels: 8**8 leaves, far past any scene that fits one card).
MAX_DEPTH = 8
MAX_LEAF_SIZE = 8

_NATIVE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")
LIB_PATH = os.path.join(_NATIVE, "build", "libsrt_traverse.so")
_SOURCES = ("srt_traverse.cu", "Makefile")

_lock = threading.Lock()
_registered = False


def _stale(lib_path: str = LIB_PATH, src_dir: str = _NATIVE) -> bool:
    if not os.path.exists(lib_path):
        return True
    built = os.path.getmtime(lib_path)
    return any(os.path.getmtime(os.path.join(src_dir, f)) > built
               for f in _SOURCES)


def build() -> str:
    """Build the library if it is missing or stale; returns its path.
    Raises RuntimeError with the compiler's output on failure."""
    if _stale():
        proc = subprocess.run(["make", "-C", _NATIVE, "cuda"],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {LIB_PATH} failed (make -C native cuda):\n"
                f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
    return LIB_PATH


def ensure_registered() -> None:
    """Build and load the library once per process and register its
    handler with XLA for the CUDA platform."""
    global _registered
    with _lock:
        if _registered:
            return
        lib = ctypes.cdll.LoadLibrary(build())
        jax.ffi.register_ffi_target(
            TARGET, jax.ffi.pycapsule(lib.SrtTraverse8), platform="CUDA")
        _registered = True


def check_tree(depth: int, leaf_size: int) -> None:
    if depth > MAX_DEPTH:
        raise ValueError(f"CUDA traversal supports trees up to depth "
                         f"{MAX_DEPTH}, this scene's is {depth}")
    if not 1 <= leaf_size <= MAX_LEAF_SIZE:
        raise ValueError(f"CUDA traversal supports leaf sizes 1.."
                         f"{MAX_LEAF_SIZE}, got {leaf_size}")


def traverse8_cuda(nodes: jnp.ndarray, num_internal: int, depth: int,
                   leaf_size: int, o: V3, d: V3,
                   active_in: jnp.ndarray | None = None) -> Hit:
    """Same contract as wbvh.traverse8: o/d are V3 of [R]; returns Hit
    with tri ids in sorted-slot order (-1 = miss)."""
    check_tree(depth, leaf_size)
    r = o.x.shape[0]
    active = (jnp.ones((r,), bool) if active_in is None
              else active_in.astype(bool))
    f32 = jax.ShapeDtypeStruct((r,), jnp.float32)
    i32 = jax.ShapeDtypeStruct((r,), jnp.int32)
    call = jax.ffi.ffi_call(TARGET, (f32, i32, f32, f32))
    t, tri, u, v = call(
        nodes.astype(jnp.float32),
        *(c.astype(jnp.float32) for c in (o.x, o.y, o.z, d.x, d.y, d.z)),
        active,
        num_internal=np.int64(num_internal),
        leaf_size=np.int64(leaf_size), depth=np.int64(depth))
    return Hit(t=t, tri=tri, u=u, v=v)
