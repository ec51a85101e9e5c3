"""Device-resident flat scene: one pytree of arrays.

The kernel-visible "world". Replaces the reference's RenderContext +
pointer-laden GeometryData (render_context.hpp:12-24, scene.hpp:17-24):
instead of per-instance buffers fetched by instance id in-kernel
(trace_ray.hpp:29-30), everything is baked into triangle-order SoA
arrays at load, already Morton-sorted into BVH leaf order so traversal
hits contiguous rows.

Acceleration structure: WBVH8 (ops/wbvh.py) — an 8-wide implicit heap
whose rows pack all 8 children AABBs (one gather per traversal step).
The binary LBVH (ops/lbvh.py) remains available for cross-validation.
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np

from sycl_ray_tracer_tpu.ops import wbvh
from sycl_ray_tracer_tpu.utils.gltf import HostScene, load_glb

DEFAULT_LEAF_SIZE = 8
# "auto" = the CUDA kernel on a GPU, the XLA walk elsewhere; "xla" and
# "cuda" force one of the two WBVH8 walks; "lbvh" = binary LBVH
# (ops/traverse.py), an independent cross-check (models/trace.py).
INTERSECTORS = ("auto", "xla", "cuda", "lbvh")


def _static(default):
    return dataclasses.field(default=default, metadata=dict(static=True))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DeviceScene:
    # WBVH8 (ops/wbvh.py): unified node table -- internal rows pack the
    # 8 children AABBs, leaf rows pack K triangles, component-major.
    # Both GPU walks (the CUDA kernel and the XLA traverse8) read it.
    bvh_nodes: jnp.ndarray  # [NI + L, max(48, 9K)]
    # Binary LBVH (ops/lbvh.py + ops/traverse.py) as an independently
    # selectable intersector (intersector="lbvh"): the cross-check
    # path used by the Sponza-scale convergence gate. Dummy [1, 3]
    # arrays unless requested (the Embree analog of selecting a
    # different RTC build quality; same triangle order as the WBVH8).
    lbvh_lo: jnp.ndarray       # [2L, 3] or dummy
    lbvh_hi: jnp.ndarray       # [2L, 3] or dummy
    lbvh_v0: jnp.ndarray       # [LK, 3] or dummy
    lbvh_e1: jnp.ndarray       # [LK, 3] or dummy
    lbvh_e2: jnp.ndarray       # [LK, 3] or dummy
    # Packed shading table, row-major (triangle-major) in sorted leaf
    # order, padded to L*K rows: the per-ray geometry a bounce's
    # shading gather needs in ONE row take. Material constants stay in
    # the small [M] tables below, taken by the gathered material id.
    # Cols: 0-8 unit vertex normals, 9-14 uv, 15 material id.
    shade_tbl: jnp.ndarray  # [LK, 16] float32
    # Material table (SoA tagged union; utils/gltf.py classification)
    mat_type: jnp.ndarray      # [M] int32 (0 diffuse, 1 metallic, 2 dielectric)
    mat_albedo: jnp.ndarray    # [M, 3]
    mat_tex: jnp.ndarray       # [M] int32, -1 = solid
    mat_rough: jnp.ndarray     # [M]
    mat_ior: jnp.ndarray       # [M]
    mat_emissive: jnp.ndarray  # [M, 3]
    # Texture atlas (nearest/repeat sampling; image_manager.hpp parity),
    # texels packed RGBA into one uint32 each: the per-bounce atlas
    # sample is ONE [R] gather plus a bit unpack. The host's uint8
    # [T, 512, 512, 4] atlas stays host-side.
    tex_packed: jnp.ndarray    # [T*512*512] uint32
    sky_color: jnp.ndarray     # [3]
    scene_lo: jnp.ndarray      # [3] world bounds (for ray-sort Morton keys)
    scene_hi: jnp.ndarray      # [3]
    # Static fields: part of every jit cache key, so switching e.g. the
    # intersector retraces instead of reusing stale code.
    intersector: str = _static("auto")
    # True iff any material references a texture: textureless scenes
    # statically skip the per-bounce atlas gather (the HostScene
    # contract always emits a dummy atlas, so its size says nothing).
    has_textures: bool = _static(True)
    # Atlas edge length in texels (tex_packed rows are tex_res^2 long)
    tex_res: int = _static(512)
    leaf_size: int = _static(DEFAULT_LEAF_SIZE)
    bvh_depth: int = _static(1)
    bvh_ni: int = _static(1)
    num_triangles: int = _static(0)

    @property
    def num_rows(self) -> int:
        return self.shade_tbl.shape[0]


def scene_bytes(num_triangles: int,
                leaf_size: int = DEFAULT_LEAF_SIZE) -> int:
    """Device bytes of the two per-triangle tables (bvh_nodes and
    shade_tbl), exact: both are sized by the padded heap of wbvh.plan,
    so a scene just past a power of 8 leaves costs up to 8x."""
    _, ni, l_leaves, width = wbvh.plan(num_triangles, leaf_size)
    return 4 * ((ni + l_leaves) * width + l_leaves * leaf_size * 16)


def check_scene_fits(num_triangles: int, leaf_size: int = DEFAULT_LEAF_SIZE,
                     device=None) -> None:
    """Pre-OOM guard: ingest bakes every glTF instance to world space
    (utils/gltf.py), so R instances of one mesh cost R x geometry here,
    unlike the reference's shared-BLAS instancing (scene.cpp:435-439).
    Fail fast with the arithmetic instead of an out-of-memory error
    mid-render when the scene tables exceed half of the accelerator's
    memory (`bytes_limit`; the other half holds ray queues and
    accumulators). The CPU backend has host RAM behind it and only
    warns. SRT_MAX_SCENE_BYTES overrides the bound."""
    need = scene_bytes(num_triangles, leaf_size)
    device = device if device is not None else jax.devices()[0]
    limit = os.environ.get("SRT_MAX_SCENE_BYTES")
    if limit is not None:
        bound = int(float(limit))
    else:
        stats = device.memory_stats() or {}
        if not stats.get("bytes_limit"):
            return
        bound = int(stats["bytes_limit"]) // 2
    if need <= bound:
        return
    msg = (f"scene has {num_triangles:,} baked world-space triangles: "
           f"{need / 1e9:.2f} GB of device tables vs a "
           f"{bound / 1e9:.2f} GB bound on {device.platform}. "
           "Instancing is baked at ingest (utils/gltf.py): R glTF "
           "instances of one mesh cost R x geometry here. Reduce "
           "instance count/mesh density or set SRT_MAX_SCENE_BYTES.")
    if device.platform != "cpu":
        raise ValueError(msg)
    print(f"# WARNING: {msg}")


def build_device_scene(host: HostScene,
                       leaf_size: int = DEFAULT_LEAF_SIZE,
                       dtype=jnp.float32,
                       intersector: str = "auto") -> DeviceScene:
    """Upload + BVH-build a HostScene.

    The build runs on the HOST in numpy (wbvh.build_np: a Morton sort
    plus reshapes, the analog of Embree's sub-second rtcCommitScene,
    scene.cpp:107). SRT_JIT_BUILD=1 runs the jitted on-device build
    instead.
    """
    if intersector not in INTERSECTORS:
        raise ValueError(f"unknown intersector {intersector!r}; "
                         f"choices: {INTERSECTORS}")
    check_scene_fits(host.num_triangles, leaf_size)

    depth, ni, _, _ = wbvh.plan(host.num_triangles, leaf_size)
    if os.environ.get("SRT_JIT_BUILD") == "1":
        tri_v = jnp.asarray(host.tri_v, dtype)
        bvh, sorted_v, valid = jax.jit(
            lambda t: wbvh.build(t, leaf_size))(tri_v)
        bvh = wbvh.Wbvh8(
            nodes=np.asarray(bvh.nodes), order=np.asarray(bvh.order),
            num_internal=bvh.num_internal, depth=bvh.depth,
            leaf_size=bvh.leaf_size)
    else:
        bvh, sorted_v, valid = wbvh.build_np(host.tri_v, leaf_size)

    order = np.asarray(bvh.order)
    safe = np.maximum(order, 0)
    validm = order >= 0

    tri_n = host.tri_n[safe]
    # Unit-normalize vertex normals (reference normalizes the
    # interpolated normal, trace_ray.hpp:52-55; unit inputs keep the
    # interpolation equivalent up to anisotropic-scale corner cases).
    ln = np.linalg.norm(tri_n, axis=-1, keepdims=True)
    tri_n = (tri_n / np.maximum(ln, 1e-20)).astype(np.float32)
    tri_n[~validm] = 0.0
    tri_uv = host.tri_uv[safe].astype(np.float32)
    tri_uv[~validm] = 0.0
    tri_mat = host.tri_mat[safe].astype(np.int32)
    tri_mat[~validm] = 0

    if intersector == "lbvh":
        # Binary-LBVH cross-check tables: same Morton triangle order
        # as the WBVH8 (lbvh.sorted_order and wbvh.build_np both
        # stable-argsort the same morton30 codes), so hit ids index
        # the same shading rows.
        from sycl_ray_tracer_tpu.ops import lbvh as _lbvh

        sv = np.asarray(sorted_v, np.float32)
        l_leaves = sv.shape[0] // leaf_size
        n_lo, n_hi = _lbvh.fit_nodes(jnp.asarray(sv),
                                     jnp.asarray(validm), l_leaves,
                                     leaf_size)
        lbvh_lo, lbvh_hi = jnp.asarray(n_lo), jnp.asarray(n_hi)
        lbvh_v0 = jnp.asarray(sv[:, 0, :])
        lbvh_e1 = jnp.asarray(sv[:, 1, :] - sv[:, 0, :])
        lbvh_e2 = jnp.asarray(sv[:, 2, :] - sv[:, 0, :])
    else:
        dummy = jnp.zeros((1, 3), jnp.float32)
        lbvh_lo = lbvh_hi = lbvh_v0 = lbvh_e1 = lbvh_e2 = dummy

    m = host.materials
    # Ints are stored as exact small f32.
    lk = tri_n.shape[0]
    stbl = np.empty((lk, 16), np.float32)
    stbl[:, 0:9] = tri_n.reshape(lk, 9)
    stbl[:, 9:15] = tri_uv.reshape(lk, 6)
    stbl[:, 15] = tri_mat
    return DeviceScene(
        shade_tbl=jnp.asarray(stbl),
        bvh_nodes=jnp.asarray(bvh.nodes),
        lbvh_lo=lbvh_lo, lbvh_hi=lbvh_hi,
        lbvh_v0=lbvh_v0, lbvh_e1=lbvh_e1, lbvh_e2=lbvh_e2,
        intersector=intersector,
        has_textures=bool(len(m.tex_id) and (np.asarray(m.tex_id) >= 0).any()),
        mat_type=jnp.asarray(m.mtype.astype(np.int32)),
        mat_albedo=jnp.asarray(m.albedo),
        mat_tex=jnp.asarray(m.tex_id),
        mat_rough=jnp.asarray(m.roughness),
        mat_ior=jnp.asarray(m.ior),
        mat_emissive=jnp.asarray(m.emissive),
        tex_res=int(host.textures.shape[1]),
        tex_packed=jnp.asarray(
            (host.textures[..., 0].astype(np.uint32)
             | (host.textures[..., 1].astype(np.uint32) << 8)
             | (host.textures[..., 2].astype(np.uint32) << 16)
             | (host.textures[..., 3].astype(np.uint32) << 24)
             ).reshape(-1)),
        sky_color=jnp.asarray(host.sky_color),
        scene_lo=jnp.asarray(
            host.tri_v.reshape(-1, 3).min(0) if host.num_triangles
            else np.zeros(3, np.float32)),
        scene_hi=jnp.asarray(
            host.tri_v.reshape(-1, 3).max(0) if host.num_triangles
            else np.ones(3, np.float32)),
        leaf_size=leaf_size,
        bvh_depth=depth,
        bvh_ni=ni,
        num_triangles=host.num_triangles,
    )


def load_scene(path: str, global_scale=(1.0, 1.0, 1.0),
               leaf_size: int = DEFAULT_LEAF_SIZE) -> tuple:
    """Convenience: .glb path -> (DeviceScene, HostScene)."""
    host = load_glb(path, global_scale)
    return build_device_scene(host, leaf_size), host
