"""Binary glTF (.glb) ingest -> flat host-side scene arrays.

Replaces the reference's tiny_gltf + Embree instancing pipeline
(scene.cpp:54-510). Differences by design:

- GLB is parsed directly (length-prefixed JSON + BIN container); no C++
  JSON/gltf dependency is needed for ingest correctness. A native C++
  fast path exists in native/ for large scenes.
- Instancing is *baked*: every (node, primitive) instance's vertices are
  transformed to world space at load (the reference instead builds
  Embree BLAS-per-primitive + TLAS-of-instances, scene.cpp:404-439,
  487-507, and transforms in-kernel). Flat world-space triangles remove
  a level of indirection from the traversal inner loop, at the cost
  of R x geometry memory for R instances.
- Shading normals are transformed by transpose(inverse(mat3(M))) exactly
  like the reference's GeometryData.obj_to_world (scene.cpp:502).

Material classification parity (scene.cpp:188-254):
  dielectric  iff KHR_materials_ior AND KHR_materials_transmission
  else metallic iff pbr.metallicFactor > 0.01
  else diffuse
  emissive = emissiveFactor * KHR_materials_emissive_strength (0 if the
  extension is absent — scene.cpp:198-206)

Documented deviations from reference quirks (SURVEY.md section 7):
- A primitive without a material gets a default diffuse(0.8) instead of
  tripping an assert (reference: scene.cpp:176; its own cube.glb violates
  this).
- Scenes without a camera node get a deterministic bbox-framing default
  camera (the reference reads nodes[-1], UB — scene.cpp:109).
- POSITION is required; missing NORMAL/TEXCOORD_0 fall back to geometric
  normals / zero UVs instead of asserting (scene.cpp:260-276).
"""

from __future__ import annotations

import dataclasses
import io
import json
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

GLB_MAGIC = 0x46546C67
CHUNK_JSON = 0x4E4F534A
CHUNK_BIN = 0x004E4942

# Fixed texture-atlas resolution, matching the reference's ImageManager
# (image_manager.hpp:12-14: 512x512 RGBA, at most 128 images).
TEX_RES = 512
MAX_IMAGES = 128

DEFAULT_SKY = (0.5, 0.7, 1.0)  # scene.hpp default sky_color

MAT_DIFFUSE = 0
MAT_METALLIC = 1
MAT_DIELECTRIC = 2

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COMPONENTS = {
    "SCALAR": 1,
    "VEC2": 2,
    "VEC3": 3,
    "VEC4": 4,
    "MAT3": 9,
    "MAT4": 16,
}


@dataclasses.dataclass
class HostMaterialTable:
    """SoA material table (tagged union -> parallel arrays)."""

    mtype: np.ndarray      # [M] uint8  (MAT_*)
    albedo: np.ndarray     # [M, 3] float32 (solid color / baseColorFactor)
    tex_id: np.ndarray     # [M] int32, -1 = solid color
    roughness: np.ndarray  # [M] float32 (metallic only)
    ior: np.ndarray        # [M] float32 (dielectric only)
    emissive: np.ndarray   # [M, 3] float32


@dataclasses.dataclass
class HostScene:
    """Flat world-space scene, ready for device upload."""

    # Geometry, SoA over triangles. v0/v1/v2 world-space positions.
    tri_v: np.ndarray       # [N, 3, 3] float32 (tri, vertex, xyz)
    tri_n: np.ndarray       # [N, 3, 3] float32 shading normals (unnormalized)
    tri_uv: np.ndarray      # [N, 3, 2] float32
    tri_mat: np.ndarray     # [N] int32 material index
    materials: HostMaterialTable
    textures: np.ndarray    # [T, TEX_RES, TEX_RES, 4] uint8 (T >= 1)
    sky_color: np.ndarray   # [3] float32 (already scaled by sky_strength)
    camera_position: np.ndarray   # [3] float32
    camera_direction: np.ndarray  # [3] float32 (normalized)
    camera_focal_length: float

    @property
    def num_triangles(self) -> int:
        return int(self.tri_v.shape[0])


def _parse_glb_container(data: bytes) -> Tuple[dict, bytes]:
    if len(data) < 12:
        raise ValueError("not a GLB file: too short")
    magic, version, length = struct.unpack_from("<III", data, 0)
    if magic != GLB_MAGIC:
        raise ValueError("not a GLB file: bad magic")
    if version != 2:
        raise ValueError(f"unsupported GLB version {version}")
    off = 12
    gltf_json: Optional[dict] = None
    blob = b""
    while off + 8 <= min(length, len(data)):
        clen, ctype = struct.unpack_from("<II", data, off)
        off += 8
        chunk = data[off:off + clen]
        off += clen
        if ctype == CHUNK_JSON and gltf_json is None:
            gltf_json = json.loads(chunk)
        elif ctype == CHUNK_BIN and not blob:
            blob = chunk
    if gltf_json is None:
        raise ValueError("GLB missing JSON chunk")
    return gltf_json, blob


def _read_accessor(gltf: dict, blob: bytes, accessor_index: int) -> np.ndarray:
    """Decode one accessor to [count, ncomp] (SCALAR -> [count, 1])."""
    acc = gltf["accessors"][accessor_index]
    ncomp = _TYPE_COMPONENTS[acc["type"]]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    count = acc["count"]
    if "bufferView" not in acc:  # spec: zero-filled when absent
        return np.zeros((count, ncomp), dtype=dtype)
    view = gltf["bufferViews"][acc["bufferView"]]
    base = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    itemsize = np.dtype(dtype).itemsize
    tight = ncomp * itemsize
    stride = view.get("byteStride", 0) or tight
    if stride == tight:
        out = np.frombuffer(blob, dtype=dtype, count=count * ncomp, offset=base)
        return out.reshape(count, ncomp).copy()
    # Strided: slice per element via as_strided on a bytes view.
    raw = np.frombuffer(blob, dtype=np.uint8,
                        count=stride * (count - 1) + tight, offset=base)
    strided = np.lib.stride_tricks.as_strided(
        raw, shape=(count, tight), strides=(stride, 1))
    return strided.copy().view(dtype).reshape(count, ncomp)


def _local_matrix(node: dict) -> np.ndarray:
    """TRS (or explicit matrix) -> 4x4, glTF column-major convention
    (ref: scene.cpp:18-21 local_matrix)."""
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float64).reshape(4, 4).T
    m = np.eye(4)
    if "scale" in node:
        m[:3, :3] = np.diag(np.asarray(node["scale"], np.float64))
    if "rotation" in node:
        x, y, z, w = [float(v) for v in node["rotation"]]
        r = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ])
        m[:3, :3] = r @ m[:3, :3]
    if "translation" in node:
        m[:3, 3] = np.asarray(node["translation"], np.float64)
    return m


def _invert3x3_transpose(m: np.ndarray) -> np.ndarray:
    """inverse-transpose normal matrix via the adjugate, mirroring
    native/srt_native.cpp invert3x3_transpose OP-FOR-OP so the two
    loaders stay bit-identical (loader-parity invariant). det == 0
    (e.g. a zero-scale node) zero-fills instead of raising — matching
    the native path and the reference's glm behavior for such nodes."""
    a = np.asarray(m, np.float64).reshape(3, 3)
    det = (a[0, 0] * (a[1, 1] * a[2, 2] - a[1, 2] * a[2, 1])
           - a[0, 1] * (a[1, 0] * a[2, 2] - a[1, 2] * a[2, 0])
           + a[0, 2] * (a[1, 0] * a[2, 1] - a[1, 1] * a[2, 0]))
    inv_det = 1.0 / det if det != 0.0 else 0.0
    inv = np.array([
        [a[1, 1] * a[2, 2] - a[1, 2] * a[2, 1],
         -(a[0, 1] * a[2, 2] - a[0, 2] * a[2, 1]),
         a[0, 1] * a[1, 2] - a[0, 2] * a[1, 1]],
        [-(a[1, 0] * a[2, 2] - a[1, 2] * a[2, 0]),
         a[0, 0] * a[2, 2] - a[0, 2] * a[2, 0],
         -(a[0, 0] * a[1, 2] - a[0, 2] * a[1, 0])],
        [a[1, 0] * a[2, 1] - a[1, 1] * a[2, 0],
         -(a[0, 0] * a[2, 1] - a[0, 1] * a[2, 0]),
         a[0, 0] * a[1, 1] - a[0, 1] * a[1, 0]],
    ], np.float64) * inv_det
    return inv.T


def _node_world_matrices(gltf: dict, scene_nodes: List[int],
                         global_scale: np.ndarray) -> Dict[int, np.ndarray]:
    """World matrix per reachable node.

    Composition matches Scene::node_global_matrix (scene.cpp:137-146):
    every node's own chain ends with an innermost scale(global_scale).
    """
    nodes = gltf.get("nodes", [])
    scale_m = np.diag(np.concatenate([global_scale, [1.0]]))
    world: Dict[int, np.ndarray] = {}

    def visit(idx: int, parent: np.ndarray):
        chain = parent @ _local_matrix(nodes[idx])
        world[idx] = chain @ scale_m
        for child in nodes[idx].get("children", []):
            visit(child, chain)

    for root in scene_nodes:
        visit(root, np.eye(4))
    return world


def decode_image_bytes(raw: bytes) -> np.ndarray:
    """Decode encoded image bytes to TEX_RES x TEX_RES RGBA uint8 with
    an sRGB-AWARE resize, mirroring the reference's
    stbir_resize_uint8_srgb (image_manager.hpp:51-61): color channels
    are converted to linear, filtered there, and re-encoded; alpha is
    filtered linearly as-is. Round 1 resized in sRGB space — a
    documented deviation that darkened every filtered edge (the sRGB
    average of black+white is 128; the correct linear average encodes
    to 188). Shared by the Python and native ingest paths so they stay
    byte-identical (tests/test_native.py)."""
    from sycl_ray_tracer_tpu.utils.image_io import (decode_image,
                                                    resize_bilinear)

    img = decode_image(raw)
    if img.shape[:2] == (TEX_RES, TEX_RES):
        return img
    a = img.astype(np.float32) / 255.0
    rgb = a[..., :3]
    lin = np.where(rgb <= 0.04045, rgb / 12.92,
                   ((rgb + 0.055) / 1.055) ** 2.4)
    chans = []
    for c in range(4):
        src = lin[..., c] if c < 3 else a[..., 3]
        chans.append(resize_bilinear(src, TEX_RES, TEX_RES))
    out = np.stack(chans, axis=-1)
    rgbo = np.clip(out[..., :3], 0.0, 1.0)
    srgb = np.where(rgbo <= 0.0031308, rgbo * 12.92,
                    1.055 * rgbo ** (1.0 / 2.4) - 0.055)
    out = np.concatenate([srgb, out[..., 3:]], axis=-1)
    return np.clip(np.round(out * 255.0), 0, 255).astype(np.uint8)


def _decode_image(gltf: dict, blob: bytes, image: dict) -> np.ndarray:
    """Extract an embedded image's bytes and decode (see
    decode_image_bytes)."""
    if "bufferView" in image:
        view = gltf["bufferViews"][image["bufferView"]]
        base = view.get("byteOffset", 0)
        raw = blob[base:base + view["byteLength"]]
    elif "uri" in image and image["uri"].startswith("data:"):
        import base64
        raw = base64.b64decode(image["uri"].split(",", 1)[1])
    else:
        raise ValueError("external image URIs are not supported in .glb ingest")
    return decode_image_bytes(raw)


def _default_material() -> dict:
    # Deviation: reference asserts on missing material (scene.cpp:176).
    return {"pbrMetallicRoughness": {
        "baseColorFactor": [0.8, 0.8, 0.8, 1.0],
        "metallicFactor": 0.0,
        "roughnessFactor": 0.5,
    }}


def _classify_materials(gltf: dict) -> HostMaterialTable:
    """Reference classification rules, scene.cpp:188-254."""
    gltf_mats = list(gltf.get("materials", []))
    gltf_mats.append(_default_material())  # slot M-1 = default material
    m = len(gltf_mats)
    mtype = np.zeros(m, np.uint8)
    albedo = np.ones((m, 3), np.float32)
    tex_id = np.full(m, -1, np.int32)
    roughness = np.zeros(m, np.float32)
    ior = np.full(m, 1.5, np.float32)
    emissive = np.zeros((m, 3), np.float32)

    textures = gltf.get("textures", [])
    for i, mat in enumerate(gltf_mats):
        pbr = mat.get("pbrMetallicRoughness", {})
        base_color = pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0])[:3]
        ext = mat.get("extensions", {})

        emissive_factor = np.asarray(
            mat.get("emissiveFactor", [0.0, 0.0, 0.0]), np.float32)
        strength = 0.0
        if "KHR_materials_emissive_strength" in ext:
            strength = float(
                ext["KHR_materials_emissive_strength"].get("emissiveStrength", 1.0))
        emissive[i] = emissive_factor * strength

        base_tex = -1
        bct = pbr.get("baseColorTexture")
        if bct is not None and bct.get("index", -1) > -1:
            base_tex = int(textures[bct["index"]].get("source", -1))

        if "KHR_materials_ior" in ext and "KHR_materials_transmission" in ext:
            mtype[i] = MAT_DIELECTRIC
            ior[i] = float(ext["KHR_materials_ior"].get("ior", 1.5))
            emissive[i] = 0.0  # dielectric never emits (material.hpp:158-160)
        elif float(pbr.get("metallicFactor", 1.0)) > 0.01:
            mtype[i] = MAT_METALLIC
            albedo[i] = base_color
            tex_id[i] = base_tex
            roughness[i] = float(pbr.get("roughnessFactor", 1.0))
        else:
            mtype[i] = MAT_DIFFUSE
            albedo[i] = base_color
            tex_id[i] = base_tex

    return HostMaterialTable(mtype=mtype, albedo=albedo, tex_id=tex_id,
                             roughness=roughness, ior=ior, emissive=emissive)


def _geometric_normals(v: np.ndarray) -> np.ndarray:
    """Per-face normals [N,3] from world positions [N,3,3] (fallback)."""
    n = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    return n / np.maximum(ln, 1e-20)


def load_glb(path_or_bytes, global_scale=(1.0, 1.0, 1.0),
             use_native: Optional[bool] = None) -> HostScene:
    """Parse a .glb file into a flat world-space HostScene.

    use_native: True forces the C++ ingest core (native/srt_native.cpp),
    False forces pure Python, None (default) tries native and falls back.
    The two paths produce identical arrays (tests/test_native.py).
    """
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()

    if use_native is not False:
        from sycl_ray_tracer_tpu.utils import native_loader
        try:
            host = native_loader.load_glb_native(data, global_scale)
        except Exception:
            if use_native:
                raise
            host = None
        if host is not None:
            return host
        if use_native:
            raise RuntimeError("native loader unavailable")

    gltf, blob = _parse_glb_container(data)

    scene_idx = gltf.get("scene", 0)
    scenes = gltf.get("scenes", [{}])
    scene = scenes[scene_idx if 0 <= scene_idx < len(scenes) else 0]
    scene_nodes = scene.get("nodes", [])

    # Sky (scene.extras, scene.cpp:80-94)
    extras = scene.get("extras", {})
    sky = np.asarray(extras.get("sky_color", DEFAULT_SKY),
                     np.float32).reshape(-1)[:3]
    if sky.shape[0] != 3:  # malformed extras: never emit a [2] sky
        sky = np.asarray(DEFAULT_SKY, np.float32)
    if "sky_strength" in extras:
        sky = sky * np.float32(extras["sky_strength"])

    gscale = np.asarray(global_scale, np.float64)
    world = _node_world_matrices(gltf, scene_nodes, gscale)

    materials = _classify_materials(gltf)
    default_mat_index = len(materials.mtype) - 1

    # Textures
    images = gltf.get("images", [])[:MAX_IMAGES]
    if images:
        textures = np.stack([_decode_image(gltf, blob, im) for im in images])
    else:
        textures = np.zeros((1, TEX_RES, TEX_RES, 4), np.uint8)

    nodes = gltf.get("nodes", [])
    meshes = gltf.get("meshes", [])

    tri_v_parts, tri_n_parts, tri_uv_parts, tri_mat_parts = [], [], [], []
    camera_node: Optional[int] = None

    for node_idx, mat4 in world.items():
        node = nodes[node_idx]
        if "camera" in node and camera_node is None:
            camera_node = node_idx
        if "mesh" not in node:
            continue
        mesh = meshes[node["mesh"]]
        m3 = mat4[:3, :3]
        normal_m = _invert3x3_transpose(m3)  # scene.cpp:502
        for prim in mesh.get("primitives", []):
            attrs = prim.get("attributes", {})
            if "POSITION" not in attrs:
                raise ValueError("primitive without POSITION attribute")
            pos = _read_accessor(gltf, blob, attrs["POSITION"]).astype(np.float64)
            if "indices" in prim:
                idx = _read_accessor(gltf, blob, prim["indices"]).reshape(-1)
                idx = idx.astype(np.int64)
            else:
                idx = np.arange(pos.shape[0], dtype=np.int64)
            if idx.size % 3 != 0:
                raise ValueError("index count not divisible by 3")
            world_pos = pos @ m3.T + mat4[:3, 3]
            v = world_pos[idx].reshape(-1, 3, 3).astype(np.float32)

            if "NORMAL" in attrs:
                nrm = _read_accessor(gltf, blob, attrs["NORMAL"]).astype(np.float64)
                n = (nrm @ normal_m.T)[idx].reshape(-1, 3, 3).astype(np.float32)
            else:
                gn = _geometric_normals(v)
                n = np.repeat(gn[:, None, :], 3, axis=1)

            if "TEXCOORD_0" in attrs:
                uv_all = _read_accessor(gltf, blob, attrs["TEXCOORD_0"])
                uv = uv_all.astype(np.float32)[idx].reshape(-1, 3, 2)
            else:
                uv = np.zeros((v.shape[0], 3, 2), np.float32)

            mat_index = prim.get("material", -1)
            if mat_index < 0:
                mat_index = default_mat_index
            tri_v_parts.append(v)
            tri_n_parts.append(n)
            tri_uv_parts.append(uv)
            tri_mat_parts.append(
                np.full(v.shape[0], mat_index, np.int32))

    if tri_v_parts:
        tri_v = np.concatenate(tri_v_parts)
        tri_n = np.concatenate(tri_n_parts)
        tri_uv = np.concatenate(tri_uv_parts)
        tri_mat = np.concatenate(tri_mat_parts)
    else:
        tri_v = np.zeros((0, 3, 3), np.float32)
        tri_n = np.zeros((0, 3, 3), np.float32)
        tri_uv = np.zeros((0, 3, 2), np.float32)
        tri_mat = np.zeros((0,), np.int32)

    cam_pos, cam_dir, focal = _extract_camera(gltf, world, camera_node, tri_v)

    return HostScene(
        tri_v=tri_v, tri_n=tri_n, tri_uv=tri_uv, tri_mat=tri_mat,
        materials=materials, textures=textures,
        sky_color=sky.astype(np.float32),
        camera_position=cam_pos.astype(np.float32),
        camera_direction=cam_dir.astype(np.float32),
        camera_focal_length=float(focal),
    )


def _extract_camera(gltf, world, camera_node, tri_v):
    """Camera pose per scene.cpp:109-128; deterministic bbox default
    when no camera node exists (deviation: the reference would index
    nodes[-1])."""
    if camera_node is not None and camera_node in world:
        m = world[camera_node]
        pos = m[:3, 3].copy()
        # rotation applied to glTF forward (0,0,-1); use the rotation
        # part of the world matrix with scale removed.
        r = m[:3, :3]
        r = r / np.maximum(np.linalg.norm(r, axis=0, keepdims=True), 1e-20)
        direction = r @ np.array([0.0, 0.0, -1.0])
        direction = direction / max(np.linalg.norm(direction), 1e-20)
        cam_ref = gltf["nodes"][camera_node]["camera"]
        persp = gltf.get("cameras", [{}])[cam_ref].get("perspective", {})
        yfov = float(persp.get("yfov", np.deg2rad(45.0)))
        focal = 1.0 / np.tan(yfov / 2.0)  # scene.cpp:127
        return pos, direction, focal

    # Default: frame the scene bbox from +Z.
    if tri_v.size:
        lo = tri_v.reshape(-1, 3).min(0)
        hi = tri_v.reshape(-1, 3).max(0)
        center = 0.5 * (lo + hi)
        extent = float(np.max(hi - lo))
    else:
        center = np.zeros(3)
        extent = 1.0
    pos = center + np.array([0.0, 0.0, 2.0 * max(extent, 1e-6)])
    direction = np.array([0.0, 0.0, -1.0])
    focal = 1.0 / np.tan(np.deg2rad(45.0) / 2.0)
    return pos, direction, focal
