"""Baked-instancing memory story.

The reference instances one Embree BLAS per primitive with per-node
transforms (scene.cpp:435-439, 487-493); our ingest bakes every
instance to world space. These tests pin the fixture, the R x
triangle-count arithmetic, the instance-preserving loader's bake, and
the pre-OOM guard that replaces a mid-render out-of-memory error with
a clear one (models/scene.py)."""

import jax
import numpy as np
import pytest

from sycl_ray_tracer_tpu.models.scene import build_device_scene
from sycl_ray_tracer_tpu.utils.fixtures import instanced_scene_glb
from sycl_ray_tracer_tpu.utils.gltf import load_glb


def test_instanced_fixture_bakes_r_copies():
    r = 200
    host = load_glb(instanced_scene_glb(r))
    # 12 tris per cube instance + floor quad + light quad (2 tris each)
    assert host.num_triangles == 12 * r + 4
    # every instance landed at its own transform: the baked world-space
    # vertex sets must all differ
    v = host.tri_v.reshape(-1, 9)
    cubes = v[2:2 + 12 * r].reshape(r, 12 * 9)
    assert np.unique(cubes.round(4), axis=0).shape[0] == r


def test_instancing_oom_guard(monkeypatch, capsys):
    host = load_glb(instanced_scene_glb(100))
    # the CPU backend warns instead of failing (host RAM backs it)
    monkeypatch.setenv("SRT_MAX_SCENE_BYTES", "100000")
    scene = build_device_scene(host, leaf_size=8)
    assert scene.num_triangles == host.num_triangles
    assert "WARNING" in capsys.readouterr().out
    # an accelerator whose memory is too small for the baked tables
    # hard-fails before anything is uploaded
    monkeypatch.delenv("SRT_MAX_SCENE_BYTES")

    class SmallCard:
        platform = "gpu"

        def memory_stats(self):
            return {"bytes_limit": 100000}

    monkeypatch.setattr(jax, "devices", lambda *a: [SmallCard()])
    with pytest.raises(ValueError, match="Instancing is baked"):
        build_device_scene(host, leaf_size=8)


def test_instanced_loader_bakes_like_the_default_loader():
    from sycl_ray_tracer_tpu.utils.instanced import load_glb_instanced

    ih = load_glb_instanced(instanced_scene_glb(50))
    assert ih.num_instances > 50  # 50 cubes + floor/lamp nodes
    assert ih.num_unique_triangles < ih.num_world_triangles / 5
    hb = load_glb(instanced_scene_glb(50))
    b = ih.bake()
    assert ih.num_world_triangles == hb.num_triangles
    np.testing.assert_array_equal(b.tri_v, hb.tri_v)
    np.testing.assert_array_equal(b.tri_n, hb.tri_n)
    np.testing.assert_array_equal(b.tri_mat, hb.tri_mat)


def test_instanced_scene_renders():
    from sycl_ray_tracer_tpu.models.camera import make_camera
    from sycl_ray_tracer_tpu.models.wavefront import render_wavefront

    host = load_glb(instanced_scene_glb(50))
    scene = build_device_scene(host, leaf_size=8)
    cam = make_camera(64, 48, host.camera_position,
                      host.camera_direction, host.camera_focal_length)
    img, rays = render_wavefront(scene, cam, width=64, height=48,
                                 spp=2, max_depth=4, seed=0)
    a = np.asarray(img)
    assert a.shape == (48, 64, 3)
    assert np.isfinite(a).all() and a.max() > 0.05
