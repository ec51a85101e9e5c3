"""Binned-SAH BVH8 (binding of the native build).

The quality replacement for the implicit Morton heap: Embree gives the
reference an SAH tree for free (scene.cpp:101-107); ours is built by
native/srt_bvh.cpp (binary binned SAH -> surface-area-optimal 8-wide
collapse). No renderer walks it yet: the GPU walks read the Morton
heap (ops/wbvh.py). A walk over this tree would report hits in
SAH-slot space (leaf_row * K + j) and translate them through `order`
to the scene's canonical triangle order.
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple, Optional

import numpy as np

from sycl_ray_tracer_tpu.utils import native_loader

_INF = np.float32(3.0e38)

# Spatial splits (SBVH, Stich et al. 2009 shape — see
# native/srt_bvh.cpp): duplicate references for triangles straddling
# an overlap-heavy split plane, clipping the polygon to each side.
# The parity analog of Embree's RTC_BUILD_QUALITY_HIGH build the
# reference could request (scene.cpp:101-107 uses the default medium
# quality, which — like our default — does object splits only).
# Default OFF; SRT_SBVH=1 turns them on.
_SBVH_ALPHA = float(os.environ.get("SRT_SBVH_ALPHA", "1e-5"))
_SBVH_FACTOR = float(os.environ.get("SRT_SBVH_FACTOR", "1.4"))


def _sbvh_default() -> bool:
    return os.environ.get("SRT_SBVH", "0") == "1"


class SahBvh(NamedTuple):
    children: np.ndarray   # [NI, 6W] component-major child boxes
    child_ids: np.ndarray  # [NI, W] int32 (leaf child = NI + leaf_row)
    order: np.ndarray      # [L*K] int32 original tri ids (-1 pad);
                           # ids may REPEAT when spatial splits fired
    num_internal: int
    num_leaves: int
    depth: int
    leaf_size: int
    num_refs: int = 0      # leaf references (> num tris after splits)
    width: int = 8         # wide-node fanout (8 in production)


def _bind(lib):
    if getattr(lib, "_srt_bvh_bound", False):
        return True
    try:
        lib.srt_bvh_build.restype = ctypes.c_void_p
        lib.srt_bvh_build.argtypes = [ctypes.POINTER(ctypes.c_float),
                                      ctypes.c_int64, ctypes.c_int32]
        for name in ("srt_bvh_ni", "srt_bvh_nleaves"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int64
            fn.argtypes = [ctypes.c_void_p]
        lib.srt_bvh_depth.restype = ctypes.c_int32
        lib.srt_bvh_depth.argtypes = [ctypes.c_void_p]
        lib.srt_bvh_copy.argtypes = [ctypes.c_void_p] + [
            ctypes.c_void_p] * 3
        lib.srt_bvh_free.argtypes = [ctypes.c_void_p]
    except AttributeError:
        return False  # stale library without the bvh entry points
    try:
        lib.srt_bvh_build2.restype = ctypes.c_void_p
        lib.srt_bvh_build2.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.c_int32, ctypes.c_float, ctypes.c_float]
        lib.srt_bvh_nrefs.restype = ctypes.c_int64
        lib.srt_bvh_nrefs.argtypes = [ctypes.c_void_p]
        lib._srt_bvh_spatial = True
    except AttributeError:
        lib._srt_bvh_spatial = False  # pre-SBVH library: object only
    try:
        lib.srt_bvh_build3.restype = ctypes.c_void_p
        lib.srt_bvh_build3.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32]
        lib._srt_bvh_width = True
    except AttributeError:
        lib._srt_bvh_width = False  # pre-width library: 8-wide only
    try:
        lib.srt_bvh_build4.restype = ctypes.c_void_p
        lib.srt_bvh_build4.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.c_int32, ctypes.c_float]
        lib._srt_bvh_dilate = True
    except AttributeError:
        lib._srt_bvh_dilate = False  # pre-dilate library
    lib._srt_bvh_bound = True
    return True


def available() -> bool:
    lib = native_loader._load_library()
    return lib is not None and _bind(lib)


def build_sah(tri_v: np.ndarray, leaf_size: int = 8,
              spatial: Optional[bool] = None,
              width: int = 8,
              dilate: float = 0.0) -> Optional[SahBvh]:
    """Build the SAH BVH on host. Returns None when the native
    library is unavailable (callers fall back to the Morton heap).
    `spatial` enables SBVH spatial splits (default: the SRT_SBVH env
    knob, which is OFF unless SRT_SBVH=1); silently degrades to
    object-only with a stale library. `width` != 8 selects a
    wide-node fanout for tree-shape probes; it is mutually exclusive
    with `spatial` and requires a fresh library."""
    lib = native_loader._load_library()
    if lib is None or not _bind(lib):
        return None
    if spatial is None:
        spatial = _sbvh_default() and width == 8
    tri_v = np.ascontiguousarray(tri_v, np.float32)
    n = tri_v.shape[0]
    if width != 8:
        if spatial:
            raise ValueError("width != 8 is object-splits only")
        if not getattr(lib, "_srt_bvh_width", False):
            return None  # stale library: no width entry point
        h = lib.srt_bvh_build3(
            tri_v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
            leaf_size, width)
    elif dilate > 0.0:
        if spatial:
            raise ValueError("dilate is object-splits only")
        if not getattr(lib, "_srt_bvh_dilate", False):
            return None  # stale library: no dilate entry point
        h = lib.srt_bvh_build4(
            tri_v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
            leaf_size, dilate)
    elif spatial and getattr(lib, "_srt_bvh_spatial", False):
        h = lib.srt_bvh_build2(
            tri_v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
            leaf_size, _SBVH_ALPHA, _SBVH_FACTOR)
    else:
        h = lib.srt_bvh_build(
            tri_v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
            leaf_size)
    try:
        ni = lib.srt_bvh_ni(h)
        nl = lib.srt_bvh_nleaves(h)
        depth = lib.srt_bvh_depth(h)
        nrefs = (lib.srt_bvh_nrefs(h)
                 if getattr(lib, "_srt_bvh_spatial", False) else n)
        children = np.empty((ni, 6 * width), np.float32)
        ids = np.empty((ni, width), np.int32)
        order = np.empty((nl * leaf_size,), np.int32)
        lib.srt_bvh_copy(
            h, children.ctypes.data_as(ctypes.c_void_p),
            ids.ctypes.data_as(ctypes.c_void_p),
            order.ctypes.data_as(ctypes.c_void_p))
    finally:
        lib.srt_bvh_free(h)
    return SahBvh(children=children, child_ids=ids, order=order,
                  num_internal=int(ni), num_leaves=int(nl),
                  depth=int(depth), leaf_size=leaf_size,
                  num_refs=int(nrefs), width=width)


def validate(bvh: SahBvh, tri_v: np.ndarray) -> None:
    """Structural invariants (mirrors lbvh.validate's role):
    every triangle reachable; children contained in parents; ids in
    range. Spatial splits legitimately DUPLICATE references (each
    covering part of the triangle), so with duplicates present the
    full-triangle-in-leaf-box check is skipped — coverage of every
    part of a split triangle is instead guaranteed by construction
    (the clipped polygon boxes partition the triangle) and checked
    end-to-end by the traversal-vs-brute-force parity tests."""
    ni, k = bvh.num_internal, bvh.leaf_size
    seen = bvh.order[bvh.order >= 0]
    assert len(seen) >= tri_v.shape[0]
    assert len(np.unique(seen)) == tri_v.shape[0], "tri lost"
    # Spatial-ness comes from the builder's DECLARED ref count, not
    # from the data being validated: an object-split builder bug that
    # duplicated a reference must fail the exact-count check below,
    # not silently flip this into "spatial" mode and skip it.
    split = bvh.num_refs > tri_v.shape[0]
    if split:
        assert len(seen) == bvh.num_refs, "ref count mismatch"
    else:
        assert len(seen) == tri_v.shape[0], "duplicated reference"

    # child boxes contain their triangles / sub-boxes
    w = bvh.children.shape[1] // 6
    boxes = bvh.children.reshape(ni, 6, w)
    for node in range(ni):
        for j in range(w):
            cid = bvh.child_ids[node, j]
            lo = boxes[node, 0:3, j]
            hi = boxes[node, 3:6, j]
            if lo[0] >= _INF:  # empty slot
                continue
            if cid >= ni:  # leaf
                if split:
                    continue  # clipped refs: boxes bound fragments
                leaf = cid - ni
                sl = bvh.order[leaf * k:(leaf + 1) * k]
                tv = tri_v[sl[sl >= 0]].reshape(-1, 3)
                assert (tv >= lo - 1e-4).all(), f"leaf {leaf} lo"
                assert (tv <= hi + 1e-4).all(), f"leaf {leaf} hi"
            else:
                cb = boxes[cid]
                real = cb[0] < _INF
                if real.any():
                    assert (cb[0:3, real] >= lo[:, None] - 1e-4).all()
                    assert (cb[3:6, real] <= hi[:, None] + 1e-4).all()
