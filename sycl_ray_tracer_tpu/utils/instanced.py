"""Instance-preserving glb ingest.

The default ingest (utils/gltf.py) BAKES every glTF instance to world
space — R instances of one mesh cost R x geometry in device memory.
The reference instead shares one Embree BLAS per primitive and
instances it per node transform (scene.cpp:435-439, 487-493).

This module parses the glb into UNIQUE primitives (local space) + an
instance list (primitive id, world transform), the input a two-level
(TLAS over shared BLAS) traversal would take. Today every renderer
reads baked scenes, so `bake()` turns it into the utils/gltf.py
representation, bit-identical to the default loader.

Reuses the container/accessor/material machinery of utils/gltf.py —
the parsing contract (and its documented deviations) is identical.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from sycl_ray_tracer_tpu.utils import gltf as _g


@dataclass
class UniquePrim:
    tri_v: np.ndarray   # [T, 3, 3] LOCAL-space vertices
    tri_n: np.ndarray   # [T, 3, 3] LOCAL-space shading normals (unit)
    tri_uv: np.ndarray  # [T, 3, 2]
    tri_mat: np.ndarray  # [T] int32


@dataclass
class InstancedHostScene:
    prims: List[UniquePrim]
    inst_prim: np.ndarray    # [I] int32 unique-prim index
    inst_mat: np.ndarray     # [I, 4, 4] float64 world matrices
    materials: object        # HostMaterialTable
    textures: np.ndarray
    sky_color: np.ndarray
    camera_position: np.ndarray
    camera_direction: np.ndarray
    camera_focal_length: float

    @property
    def num_instances(self) -> int:
        return int(self.inst_prim.shape[0])

    @property
    def num_unique_triangles(self) -> int:
        return int(sum(p.tri_v.shape[0] for p in self.prims))

    @property
    def num_world_triangles(self) -> int:
        return int(sum(self.prims[p].tri_v.shape[0]
                       for p in self.inst_prim))

    def bake(self) -> "_g.HostScene":
        """World-space bake (the utils/gltf.py representation)."""
        tv, tn, tu, tm = [], [], [], []
        for p, m4 in zip(self.inst_prim, self.inst_mat):
            pr = self.prims[p]
            m3 = m4[:3, :3]
            nm = _g._invert3x3_transpose(m3)
            v = pr.tri_v.astype(np.float64)
            tv.append((v @ m3.T + m4[:3, 3]).astype(np.float32))
            n = pr.tri_n.astype(np.float64) @ nm.T
            tn.append(n.astype(np.float32))
            tu.append(pr.tri_uv)
            tm.append(pr.tri_mat)
        z3 = np.zeros((0, 3, 3), np.float32)
        return _g.HostScene(
            tri_v=np.concatenate(tv) if tv else z3,
            tri_n=np.concatenate(tn) if tn else z3,
            tri_uv=(np.concatenate(tu) if tu
                    else np.zeros((0, 3, 2), np.float32)),
            tri_mat=(np.concatenate(tm) if tm
                     else np.zeros((0,), np.int32)),
            materials=self.materials, textures=self.textures,
            sky_color=self.sky_color,
            camera_position=self.camera_position,
            camera_direction=self.camera_direction,
            camera_focal_length=self.camera_focal_length)


def load_glb_instanced(path_or_bytes,
                       global_scale=(1.0, 1.0, 1.0)
                       ) -> InstancedHostScene:
    """Parse a .glb into unique primitives + instance transforms.

    The GLOBAL scale rides the world matrices (exactly where
    _node_world_matrices applies it), so local geometry stays as
    authored."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()

    gltf, blob = _g._parse_glb_container(data)
    scene_idx = gltf.get("scene", 0)
    scenes = gltf.get("scenes", [{}])
    scene = scenes[scene_idx if 0 <= scene_idx < len(scenes) else 0]
    scene_nodes = scene.get("nodes", [])

    extras = scene.get("extras", {})
    sky = np.asarray(extras.get("sky_color", _g.DEFAULT_SKY),
                     np.float32).reshape(-1)[:3]
    if sky.shape[0] != 3:
        sky = np.asarray(_g.DEFAULT_SKY, np.float32)
    if "sky_strength" in extras:
        sky = sky * np.float32(extras["sky_strength"])

    gscale = np.asarray(global_scale, np.float64)
    world = _g._node_world_matrices(gltf, scene_nodes, gscale)
    materials = _g._classify_materials(gltf)
    default_mat_index = len(materials.mtype) - 1

    images = gltf.get("images", [])[:_g.MAX_IMAGES]
    if images:
        textures = np.stack(
            [_g._decode_image(gltf, blob, im) for im in images])
    else:
        textures = np.zeros((1, _g.TEX_RES, _g.TEX_RES, 4), np.uint8)

    nodes = gltf.get("nodes", [])
    meshes = gltf.get("meshes", [])

    prims: List[UniquePrim] = []
    prim_key_to_id = {}
    inst_prim: List[int] = []
    inst_mat: List[np.ndarray] = []
    camera_node: Optional[int] = None

    for node_idx, mat4 in world.items():
        node = nodes[node_idx]
        if "camera" in node and camera_node is None:
            camera_node = node_idx
        if "mesh" not in node:
            continue
        mesh_idx = node["mesh"]
        mesh = meshes[mesh_idx]
        for prim_idx, prim in enumerate(mesh.get("primitives", [])):
            key = (mesh_idx, prim_idx)
            if key not in prim_key_to_id:
                attrs = prim.get("attributes", {})
                if "POSITION" not in attrs:
                    raise ValueError(
                        "primitive without POSITION attribute")
                pos = _g._read_accessor(
                    gltf, blob, attrs["POSITION"]).astype(np.float64)
                if "indices" in prim:
                    idx = _g._read_accessor(
                        gltf, blob, prim["indices"]).reshape(-1)
                    idx = idx.astype(np.int64)
                else:
                    idx = np.arange(pos.shape[0], dtype=np.int64)
                if idx.size % 3 != 0:
                    raise ValueError("index count not divisible by 3")
                v = pos[idx].reshape(-1, 3, 3).astype(np.float32)
                if "NORMAL" in attrs:
                    nrm = _g._read_accessor(
                        gltf, blob, attrs["NORMAL"]).astype(np.float64)
                    n = nrm[idx].reshape(-1, 3, 3).astype(np.float32)
                else:
                    gn = _g._geometric_normals(v)
                    n = np.repeat(gn[:, None, :], 3, axis=1)
                if "TEXCOORD_0" in attrs:
                    uv = _g._read_accessor(
                        gltf, blob,
                        attrs["TEXCOORD_0"]).astype(np.float32)
                    uv = uv[idx].reshape(-1, 3, 2)
                else:
                    uv = np.zeros((v.shape[0], 3, 2), np.float32)
                mat_index = prim.get("material", -1)
                if mat_index < 0:
                    mat_index = default_mat_index
                prim_key_to_id[key] = len(prims)
                prims.append(UniquePrim(
                    tri_v=v, tri_n=n, tri_uv=uv,
                    tri_mat=np.full(v.shape[0], mat_index, np.int32)))
            inst_prim.append(prim_key_to_id[key])
            inst_mat.append(mat4)

    inst_prim_a = np.asarray(inst_prim, np.int32)
    inst_mat_a = (np.stack(inst_mat) if inst_mat
                  else np.zeros((0, 4, 4), np.float64))

    # camera extraction needs world tris only for the no-camera
    # fallback framing; hand it the instance root boxes instead of a
    # full bake
    if camera_node is not None:
        ref_tris = np.zeros((0, 3, 3), np.float32)
    else:
        pts = []
        for p, m4 in zip(inst_prim_a, inst_mat_a):
            v = prims[p].tri_v.reshape(-1, 3).astype(np.float64)
            lo = v.min(0) if v.size else np.zeros(3)
            hi = v.max(0) if v.size else np.zeros(3)
            corners = np.array([[x, y, z] for x in (lo[0], hi[0])
                                for y in (lo[1], hi[1])
                                for z in (lo[2], hi[2])])
            w = corners @ m4[:3, :3].T + m4[:3, 3]
            pts.append(w.astype(np.float32))
        allp = (np.concatenate(pts) if pts
                else np.zeros((0, 3), np.float32))
        # 8 corner points per instance stand in for tri rows
        ref_tris = np.repeat(allp[:, None, :], 3, axis=1)
    cam_pos, cam_dir, focal = _g._extract_camera(
        gltf, world, camera_node, ref_tris)

    return InstancedHostScene(
        prims=prims, inst_prim=inst_prim_a, inst_mat=inst_mat_a,
        materials=materials, textures=textures,
        sky_color=sky.astype(np.float32),
        camera_position=cam_pos.astype(np.float32),
        camera_direction=cam_dir.astype(np.float32),
        camera_focal_length=float(focal))
