"""ctypes bindings for the native C++ GLB loader (native/srt_native.cpp).

The native core handles the heavy ingest (GLB/JSON/accessors/transform
baking/material classification — the tiny_gltf-equivalent layer); image
decoding stays in Python (utils/image_io.py). Falls back silently to
the pure-Python loader when the library hasn't been built (SRT_NATIVE=0
disables it explicitly). Auto-builds via `make -C native` on first use when a
compiler is available.
"""

from __future__ import annotations

import ctypes
import io
import os
import subprocess
from typing import Optional

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_LIB_PATH = os.path.join(_REPO_ROOT, "native", "build", "libsrt_native.so")

_lib = None
_lib_tried = False


def _load_library():
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    if os.environ.get("SRT_NATIVE", "1") == "0":
        return None
    def _stale():
        if not os.path.exists(_LIB_PATH):
            return True
        lib_mtime = os.path.getmtime(_LIB_PATH)
        src_dir = os.path.join(_REPO_ROOT, "native")
        try:
            # Makefile counts as a source: a CXXFLAGS/-D change must
            # trigger a rebuild too, or ctypes silently loads a .so
            # built with the old flags
            return any(
                (f.endswith(".cpp") or f == "Makefile")
                and os.path.getmtime(os.path.join(src_dir, f)) > lib_mtime
                for f in os.listdir(src_dir))
        except OSError:
            return False

    if _stale():
        makefile = os.path.join(_REPO_ROOT, "native", "Makefile")
        if not os.path.exists(makefile):
            return None
        try:
            subprocess.run(["make", "-C", os.path.dirname(makefile)],
                           check=True, capture_output=True, timeout=120)
        except Exception:
            if not os.path.exists(_LIB_PATH):
                return None  # no library at all; rebuild failures
                # with a stale lib fall through and load it
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None

    lib.srt_load_glb.restype = ctypes.c_void_p
    lib.srt_load_glb.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                 ctypes.POINTER(ctypes.c_float)]
    lib.srt_error.restype = ctypes.c_char_p
    lib.srt_error.argtypes = [ctypes.c_void_p]
    for name in ("srt_num_triangles", "srt_num_materials",
                 "srt_num_images"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p]
    lib.srt_image_size.restype = ctypes.c_int64
    lib.srt_image_size.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.srt_copy_geometry.argtypes = [ctypes.c_void_p] + [
        ctypes.c_void_p] * 4
    lib.srt_copy_materials.argtypes = [ctypes.c_void_p] + [
        ctypes.c_void_p] * 6
    lib.srt_scene_info.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 5
    lib.srt_copy_image.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                   ctypes.c_void_p]
    lib.srt_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def available() -> bool:
    return _load_library() is not None


def load_glb_native(data: bytes, global_scale=(1.0, 1.0, 1.0)):
    """Parse GLB with the native core. Returns a HostScene or None if
    the native library is unavailable."""
    from sycl_ray_tracer_tpu.utils.gltf import (TEX_RES, HostMaterialTable,
                                                HostScene)

    lib = _load_library()
    if lib is None:
        return None

    scale = (ctypes.c_float * 3)(*[float(x) for x in global_scale])
    handle = lib.srt_load_glb(data, len(data), scale)
    if not handle:
        raise RuntimeError("native loader returned null")
    handle = ctypes.c_void_p(handle)
    try:
        err = lib.srt_error(handle)
        if err:
            raise ValueError(f"native GLB parse failed: {err.decode()}")

        n = lib.srt_num_triangles(handle)
        m = lib.srt_num_materials(handle)

        tri_v = np.empty((n, 3, 3), np.float32)
        tri_n = np.empty((n, 3, 3), np.float32)
        tri_uv = np.empty((n, 3, 2), np.float32)
        tri_mat = np.empty((n,), np.int32)
        lib.srt_copy_geometry(
            handle,
            tri_v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            tri_n.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            tri_uv.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            tri_mat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))

        mtype = np.empty((m,), np.int32)
        albedo = np.empty((m, 3), np.float32)
        tex = np.empty((m,), np.int32)
        rough = np.empty((m,), np.float32)
        ior = np.empty((m,), np.float32)
        emissive = np.empty((m, 3), np.float32)
        lib.srt_copy_materials(
            handle,
            mtype.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            albedo.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            tex.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            rough.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ior.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            emissive.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))

        sky = (ctypes.c_float * 3)()
        pos = (ctypes.c_float * 3)()
        dirn = (ctypes.c_float * 3)()
        focal = ctypes.c_float()
        has_cam = ctypes.c_int32()
        lib.srt_scene_info(handle, sky, pos, dirn,
                           ctypes.byref(focal), ctypes.byref(has_cam))

        # image decode in Python (native hands back raw embedded bytes);
        # shared sRGB-aware resize keeps both ingest paths identical
        n_img = lib.srt_num_images(handle)
        if n_img:
            from sycl_ray_tracer_tpu.utils.gltf import decode_image_bytes

            imgs = []
            for i in range(n_img):
                size = lib.srt_image_size(handle, i)
                buf = np.empty((size,), np.uint8)
                lib.srt_copy_image(
                    handle, i,
                    buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
                imgs.append(decode_image_bytes(buf.tobytes()))
            textures = np.stack(imgs)
        else:
            textures = np.zeros((1, TEX_RES, TEX_RES, 4), np.uint8)

        mats = HostMaterialTable(
            mtype=mtype.astype(np.uint8), albedo=albedo, tex_id=tex,
            roughness=rough, ior=ior, emissive=emissive)
        return HostScene(
            tri_v=tri_v, tri_n=tri_n, tri_uv=tri_uv, tri_mat=tri_mat,
            materials=mats, textures=textures,
            sky_color=np.asarray(sky, np.float32),
            camera_position=np.asarray(pos, np.float32),
            camera_direction=np.asarray(dirn, np.float32),
            camera_focal_length=float(focal.value),
        )
    finally:
        lib.srt_free(handle)
