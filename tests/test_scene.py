"""DeviceScene (models/scene.py): a registered dataclass pytree whose
static fields key the jit cache, the exact size of its per-triangle
tables, the pre-OOM guard, and an import that needs neither flax nor
Pillow and leaves the backend alone."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sycl_ray_tracer_tpu.models.scene import (DeviceScene, build_device_scene,
                                              check_scene_fits, scene_bytes)
from sycl_ray_tracer_tpu.utils.fixtures import cube_scene_glb
from sycl_ray_tracer_tpu.utils.gltf import load_glb

STATIC = ("intersector", "has_textures", "tex_res", "leaf_size",
          "bvh_depth", "bvh_ni", "num_triangles")


@pytest.fixture(scope="module")
def cube():
    return build_device_scene(load_glb(cube_scene_glb()))


def test_pytree_round_trip(cube):
    leaves, treedef = jax.tree_util.tree_flatten(cube)
    n_data = len(dataclasses.fields(DeviceScene)) - len(STATIC)
    assert len(leaves) == n_data
    assert all(isinstance(x, jax.Array) for x in leaves)
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    for f in dataclasses.fields(DeviceScene):
        a, b = getattr(cube, f.name), getattr(back, f.name)
        if f.name in STATIC:
            assert a == b
        else:
            assert a is b


def test_static_fields_key_the_jit_cache(cube):
    traces = []

    @jax.jit
    def f(scene):
        traces.append(scene.intersector)
        return scene.bvh_nodes.sum()

    f(cube)
    f(dataclasses.replace(cube, bvh_nodes=cube.bvh_nodes + 1.0))
    assert traces == ["auto"]  # new data, same static fields: no retrace
    f(dataclasses.replace(cube, intersector="xla"))
    assert traces == ["auto", "xla"]


def test_unknown_intersector_is_rejected():
    with pytest.raises(ValueError, match="unknown intersector"):
        build_device_scene(load_glb(cube_scene_glb()), intersector="tiles")


@pytest.mark.parametrize("leaf_size", [4, 8])
def test_scene_bytes_is_exact(leaf_size):
    host = load_glb(cube_scene_glb())
    s = build_device_scene(host, leaf_size=leaf_size)
    assert scene_bytes(host.num_triangles, leaf_size) == (
        s.bvh_nodes.nbytes + s.shade_tbl.nbytes)


class _Card:
    platform = "gpu"

    def __init__(self, limit):
        self.limit = limit

    def memory_stats(self):
        return {"bytes_limit": self.limit}


@pytest.mark.parametrize("limit,raises", [(10**12, False), (10**4, True)])
def test_guard_on_an_accelerator(limit, raises):
    need = scene_bytes(10_000)
    assert need > 10**4 // 2
    if raises:
        with pytest.raises(ValueError, match="Instancing is baked"):
            check_scene_fits(10_000, device=_Card(limit))
    else:
        check_scene_fits(10_000, device=_Card(limit))


def test_guard_warns_on_cpu(monkeypatch, capsys):
    monkeypatch.setenv("SRT_MAX_SCENE_BYTES", "1000")
    check_scene_fits(10_000, device=jax.devices("cpu")[0])
    assert "WARNING" in capsys.readouterr().out
    monkeypatch.delenv("SRT_MAX_SCENE_BYTES")
    check_scene_fits(10_000, device=jax.devices("cpu")[0])  # no bound
    assert capsys.readouterr().out == ""


def test_import_and_render_need_no_flax_or_pillow():
    """A sponza_proc render imports neither flax nor PIL, and importing
    the package initialises no JAX backend."""
    code = """
import sys
import jax._src.xla_bridge as xb
import sycl_ray_tracer_tpu
assert not xb._backends, "import initialised a backend"
from sycl_ray_tracer_tpu.models.camera import make_camera
from sycl_ray_tracer_tpu.models.scene import build_device_scene
from sycl_ray_tracer_tpu.models.wavefront import render_wavefront
from sycl_ray_tracer_tpu.utils.gltf import load_glb
from sycl_ray_tracer_tpu.utils.procgen import sponza_like_glb
host = load_glb(sponza_like_glb(scale=1))
scene = build_device_scene(host)
cam = make_camera(8, 8, host.camera_position, host.camera_direction,
                  host.camera_focal_length)
render_wavefront(scene, cam, width=8, height=8, spp=1, max_depth=2)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("flax", "PIL"))
assert not bad, bad
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
