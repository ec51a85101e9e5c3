"""Multi-chip sharding on the 8-device virtual CPU mesh: the sharded
estimator must equal the single-device render exactly (same sample
indices, same keys, just partitioned)."""

import jax
import numpy as np
import pytest

from sycl_ray_tracer_tpu.models.megakernel import render_megakernel
from sycl_ray_tracer_tpu.models.oracle import rmse
from sycl_ray_tracer_tpu.models.wavefront import render_wavefront
from sycl_ray_tracer_tpu.parallel.mesh import make_mesh, render_sharded

from sycl_ray_tracer_tpu.utils import fixtures as scenes

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")


def test_sample_sharding_matches_single_device():
    scene, host, cam = scenes.load_pair(scenes.cube_scene_glb(), 32, 32)
    single, rays1 = render_wavefront(scene, cam, width=32, height=32,
                                     spp=8, max_depth=6, seed=0)
    mesh = make_mesh(dp=8, sp=1)
    sharded, rays8 = render_sharded(scene, cam, width=32, height=32,
                                    spp=8, max_depth=6, seed=0, mesh=mesh)
    assert rmse(np.asarray(single), np.asarray(sharded)) < 1e-6
    assert np.asarray(rays1).sum() == np.asarray(rays8).sum()


def test_2d_mesh_samples_x_pixels():
    scene, host, cam = scenes.load_pair(scenes.cube_scene_glb(), 32, 32)
    single, rays1 = render_wavefront(scene, cam, width=32, height=32,
                                     spp=4, max_depth=6, seed=0)
    mesh = make_mesh(dp=4, sp=2)
    sharded, rays = render_sharded(scene, cam, width=32, height=32,
                                   spp=4, max_depth=6, seed=0, mesh=mesh)
    assert rmse(np.asarray(single), np.asarray(sharded)) < 1e-6
    assert np.asarray(rays1).sum() == np.asarray(rays).sum()


def test_pixel_only_sharding_megakernel():
    scene, host, cam = scenes.load_pair(scenes.triangle_scene_glb(), 32, 32)
    single, _ = render_megakernel(scene, cam, width=32, height=32,
                                  spp=2, max_depth=4, seed=0)
    mesh = make_mesh(dp=1, sp=8)
    sharded, _ = render_sharded(scene, cam, width=32, height=32,
                                spp=2, max_depth=4, seed=0, mesh=mesh,
                                renderer="megakernel")
    assert rmse(np.asarray(single), np.asarray(sharded)) < 1e-6


def test_sharded_multiwave_threads(monkeypatch):
    """The sharded host loop splits local samples into waves and (like
    the single-chip loops) may interleave them across host threads
    (SRT_WAVE_THREADS). Force 4 waves x 2 threads and check both the
    serial/threaded bit-identity and the sharded-vs-single estimator
    equality still hold."""
    scene, host, cam = scenes.load_pair(scenes.cube_scene_glb(), 32, 32)
    single, rays1 = render_wavefront(scene, cam, width=32, height=32,
                                     spp=16, max_depth=6, seed=0)
    mesh = make_mesh(dp=2, sp=2)
    # n_local = 512 pixels; 2 local samples per wave -> 4 waves of the
    # 8 local samples each dp shard owns
    monkeypatch.setenv("SRT_WAVE_RAYS", str(2 * 512))
    monkeypatch.setenv("SRT_WAVE_THREADS", "1")
    ser, rays_s = render_sharded(scene, cam, width=32, height=32,
                                 spp=16, max_depth=6, seed=0, mesh=mesh)
    monkeypatch.setenv("SRT_WAVE_THREADS", "2")
    thr, rays_t = render_sharded(scene, cam, width=32, height=32,
                                 spp=16, max_depth=6, seed=0, mesh=mesh)
    assert (np.asarray(ser) == np.asarray(thr)).all()
    assert (np.asarray(rays_s) == np.asarray(rays_t)).all()
    assert rmse(np.asarray(single), np.asarray(thr)) < 1e-6
    assert np.asarray(rays1).sum() == np.asarray(rays_t).sum()


def test_sharded_chunked_megakernel_matches_single(monkeypatch):
    """The sharded megakernel must drive the FAST
    engine (bounce-chunked + re-sort, megakernel._chunked_wave) per
    shard, not the unchunked traced core. Force the chunked cadence on
    CPU and check the 2x4 sharded estimator equals single-chip, with
    identical ray tallies."""
    monkeypatch.setenv("SRT_MK_CHUNK", "2")
    monkeypatch.setenv("SRT_MK_SORT", "1")
    scene, host, cam = scenes.load_pair(scenes.cube_scene_glb(), 32, 32)
    single, rays1 = render_megakernel(scene, cam, width=32, height=32,
                                      spp=4, max_depth=6, seed=0)
    mesh = make_mesh(dp=2, sp=4)
    sharded, rays = render_sharded(scene, cam, width=32, height=32,
                                   spp=4, max_depth=6, seed=0,
                                   mesh=mesh, renderer="megakernel")
    assert rmse(np.asarray(single), np.asarray(sharded)) < 1e-6
    assert (np.asarray(rays1) == np.asarray(rays)).all()


def test_sharded_chunked_megakernel_multiwave(monkeypatch):
    """Multi-wave + thread-interleave bit-identity for the sharded
    chunked megakernel (the same gate the wavefront loop has)."""
    monkeypatch.setenv("SRT_MK_CHUNK", "2")
    monkeypatch.setenv("SRT_MK_SORT", "1")
    scene, host, cam = scenes.load_pair(scenes.cube_scene_glb(), 32, 32)
    mesh = make_mesh(dp=2, sp=2)
    # n_local = 512 pixels; 1 local sample per wave -> 2 waves
    monkeypatch.setenv("SRT_WAVE_RAYS", str(512))
    monkeypatch.setenv("SRT_WAVE_THREADS", "1")
    ser, rays_s = render_sharded(scene, cam, width=32, height=32,
                                 spp=4, max_depth=6, seed=0, mesh=mesh,
                                 renderer="megakernel")
    monkeypatch.setenv("SRT_WAVE_THREADS", "2")
    thr, rays_t = render_sharded(scene, cam, width=32, height=32,
                                 spp=4, max_depth=6, seed=0, mesh=mesh,
                                 renderer="megakernel")
    assert (np.asarray(ser) == np.asarray(thr)).all()
    assert (np.asarray(rays_s) == np.asarray(rays_t)).all()
    single, _ = render_megakernel(scene, cam, width=32, height=32,
                                  spp=4, max_depth=6, seed=0)
    assert rmse(np.asarray(single), np.asarray(thr)) < 1e-6


@pytest.mark.parametrize("renderer,chunk", [
    ("wavefront", "2"), ("megakernel", "2"), ("megakernel", "0")])
def test_repeat_render_compiles_nothing(monkeypatch, renderer, chunk):
    """A second sharded render of one configuration, with another seed,
    reuses every compiled program (the chunked and the traced
    megakernel, and the wavefront host loop)."""
    monkeypatch.setenv("SRT_MK_CHUNK", chunk)
    scene, host, cam = scenes.load_pair(scenes.triangle_scene_glb(), 16, 16)
    kw = dict(width=16, height=16, spp=2, max_depth=3,
              mesh=make_mesh(dp=2, sp=2), renderer=renderer)
    jax.block_until_ready(render_sharded(scene, cam, seed=0, **kw))
    compiles = []

    def listen(event, duration, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            compiles.append(duration)

    jax.monitoring.register_event_duration_secs_listener(listen)
    try:
        jax.block_until_ready(render_sharded(scene, cam, seed=1, **kw))
    finally:
        jax.monitoring.unregister_event_duration_listener(listen)
    assert compiles == []
