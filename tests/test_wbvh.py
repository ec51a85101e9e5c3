"""WBVH8 (ops/wbvh.py): the numpy and jitted builds agree, and the XLA
walk traverse8 -- the plain twin of the CUDA kernel and the walk every
CPU render uses -- finds the same closest hits as brute force on the
procedural and fixture scenes, for camera rays, bounce rays and rays
behind an active mask."""

import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sycl_ray_tracer_tpu.ops import wbvh
from sycl_ray_tracer_tpu.ops.intersect import intersect_brute_np
from sycl_ray_tracer_tpu.ops.vec import V3
from sycl_ray_tracer_tpu.utils import fixtures, procgen
from sycl_ray_tracer_tpu.utils.gltf import load_glb


def test_build_np_matches_jit_build(rs):
    n, k = 700, 8
    c = rs.uniform(-5, 5, (n, 3)).astype(np.float32)
    tri = c[:, None, :] + rs.uniform(-0.3, 0.3, (n, 3, 3)).astype(np.float32)
    b_np, sv_np, _ = wbvh.build_np(tri, k)
    b_j, sv_j, _ = jax.jit(lambda t: wbvh.build(t, k))(jnp.asarray(tri))
    assert b_np.num_internal == b_j.num_internal
    assert b_np.depth == b_j.depth
    assert (b_np.order == np.asarray(b_j.order)).all()
    assert np.allclose(b_np.nodes, np.asarray(b_j.nodes))
    assert np.allclose(sv_np, np.asarray(sv_j))


SCENES = {
    "triangle": fixtures.triangle_scene_glb,
    "cube": fixtures.cube_scene_glb,
    "dielectric": lambda: fixtures.dielectric_scene_glb(subdiv=1),
    "sponza_proc": lambda: procgen.sponza_like_glb(scale=1),
    "minecraft_proc": lambda: procgen.minecraft_like_glb(n=20),
}


@functools.lru_cache(maxsize=None)
def _scene(name):
    host = load_glb(SCENES[name]())
    bvh, _, _ = wbvh.build_np(host.tri_v, 8)
    return host, bvh


def _rays(host, kind, rs, r=384):
    """[R, 3] origins/directions: "camera" rays fan out of the scene's
    camera; "bounce" rays leave random points of random triangles in
    random directions; "masked" are bounce rays with ~40% inactive."""
    tri = host.tri_v.astype(np.float64)
    if kind == "camera":
        o = np.tile(host.camera_position, (r, 1))
        fwd = host.camera_direction / np.linalg.norm(host.camera_direction)
        d = fwd + rs.uniform(-0.6, 0.6, (r, 3))
    else:
        pick = rs.randint(0, tri.shape[0], r)
        u, v = rs.uniform(0, 0.5, (2, r))
        o = (tri[pick, 0] + u[:, None] * (tri[pick, 1] - tri[pick, 0])
             + v[:, None] * (tri[pick, 2] - tri[pick, 0]))
        d = rs.normal(0, 1, (r, 3))
    active = (rs.rand(r) < 0.6) if kind == "masked" else np.ones(r, bool)
    return o.astype(np.float32), d.astype(np.float32), active


@pytest.mark.parametrize("kind", ["camera", "bounce", "masked"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_traverse8_matches_brute(name, kind):
    host, bvh = _scene(name)
    rs = np.random.RandomState(zlib.crc32(f"{name}/{kind}".encode()))
    o, d, active = _rays(host, kind, rs)
    hit = jax.jit(lambda o, d, a: wbvh.traverse8(
        jnp.asarray(bvh.nodes), bvh.num_internal, bvh.depth, 8,
        V3(*o), V3(*d), active_in=a))(
            tuple(jnp.asarray(o[:, i]) for i in range(3)),
            tuple(jnp.asarray(d[:, i]) for i in range(3)),
            jnp.asarray(active))
    t, slot = np.asarray(hit.t), np.asarray(hit.tri)
    got = np.where(slot >= 0, bvh.order[np.maximum(slot, 0)], -1)
    brute = [intersect_brute_np(o[i:i + 64], d[i:i + 64], host.tri_v)
             for i in range(0, len(o), 64)]
    t_b = np.concatenate([b[0] for b in brute])
    id_b = np.concatenate([b[1] for b in brute])
    id_b = np.where(active, id_b, -1)
    assert (got[~active] == -1).all()
    assert ((got >= 0) == (id_b >= 0)).all()
    both = (got >= 0) & (id_b >= 0)
    assert np.allclose(t[both], t_b[both], rtol=1e-5)
    # ids may differ only at equal-distance ties: shared edges, and the
    # coplanar faces of stacked voxel boxes
    diff = both & (got != id_b)
    assert np.allclose(t[diff], t_b[diff], rtol=1e-6)
    if kind == "camera" or host.num_triangles > 2:
        assert both.sum() > 0  # the rays actually hit something
