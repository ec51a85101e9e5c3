"""The CUDA traversal kernel (ops/traverse_cuda.py, native/srt_traverse.cu).

The kernel itself runs only on an NVIDIA GPU: those tests carry the
`gpu` marker and skip elsewhere. What surrounds it is plain Python and
JAX and is tested here on the CPU: the op's shapes and dtypes, its
lowering to the FFI custom call for the CUDA platform, the tree limits,
the library build rule, and the choice of walk per platform -- where
a GPU without the library is an error, never a silent XLA fallback.
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sycl_ray_tracer_tpu.models import trace
from sycl_ray_tracer_tpu.ops import traverse_cuda as tc
from sycl_ray_tracer_tpu.ops import wbvh
from sycl_ray_tracer_tpu.ops.vec import V3


def _soup(rs, n=400):
    c = rs.uniform(-5, 5, (n, 1, 3)).astype(np.float32)
    return (c + rs.normal(0, 0.5, (n, 3, 3))).astype(np.float32)


def _rays(rs, r):
    o = rs.uniform(-8, 8, (r, 3)).astype(np.float32)
    d = rs.normal(0, 1, (r, 3)).astype(np.float32)
    return (V3(*(jnp.asarray(o[:, i]) for i in range(3))),
            V3(*(jnp.asarray(d[:, i]) for i in range(3))))


@pytest.mark.parametrize("r", [1, 1000, 4097])
def test_op_shapes_and_dtypes(rs, r):
    bvh, _, _ = wbvh.build_np(_soup(rs), 8)
    o, d = _rays(rs, r)
    out = jax.eval_shape(
        lambda n, o, d: tc.traverse8_cuda(n, bvh.num_internal, bvh.depth,
                                          8, o, d),
        jnp.asarray(bvh.nodes), o, d)
    assert [a.shape for a in out] == [(r,)] * 4
    assert [a.dtype for a in out] == [jnp.float32, jnp.int32,
                                      jnp.float32, jnp.float32]


@pytest.mark.parametrize("mask", [None, "bool", "int"])
def test_lowers_to_ffi_call_for_cuda(rs, mask):
    """The op lowers, for the CUDA platform, to one custom call with the
    tree's static shape as attributes and the active mask as i1."""
    bvh, _, _ = wbvh.build_np(_soup(rs), 4)
    o, d = _rays(rs, 300)
    act = {None: None, "bool": jnp.arange(300) % 3 > 0,
           "int": (jnp.arange(300) % 3).astype(jnp.int32)}[mask]
    f = jax.jit(lambda n, o, d, a: tc.traverse8_cuda(
        n, bvh.num_internal, bvh.depth, 4, o, d, active_in=a))
    text = f.trace(jnp.asarray(bvh.nodes), o, d, act).lower(
        lowering_platforms=("cuda",)).as_text()
    call = [ln for ln in text.splitlines() if "custom_call" in ln]
    assert len(call) == 1 and "@srt_traverse8" in call[0]
    assert f"num_internal = {bvh.num_internal} : i64" in call[0]
    assert f"depth = {bvh.depth} : i64" in call[0]
    assert "leaf_size = 4 : i64" in call[0]
    assert "tensor<300xi1>" in call[0]


@pytest.mark.parametrize("depth,leaf_size,ok", [
    (tc.MAX_DEPTH, 8, True), (tc.MAX_DEPTH + 1, 8, False),
    (3, 0, False), (3, tc.MAX_LEAF_SIZE + 1, False)])
def test_tree_limits(depth, leaf_size, ok):
    if ok:
        tc.check_tree(depth, leaf_size)
    else:
        with pytest.raises(ValueError):
            tc.check_tree(depth, leaf_size)


@pytest.mark.parametrize("name,platform,want", [
    ("auto", "cpu", "xla"), ("auto", "gpu", "cuda"), ("xla", "gpu", "xla"),
    ("cuda", "gpu", "cuda"), ("lbvh", "gpu", "lbvh"),
    ("cuda", "cpu", ValueError), ("tiles", "gpu", ValueError)])
def test_resolve_intersector(name, platform, want):
    if want is ValueError:
        with pytest.raises(ValueError):
            trace.resolve_intersector(name, platform)
    else:
        assert trace.resolve_intersector(name, platform) == want


def test_stale_rule(tmp_path):
    src = tmp_path / "srt_traverse.cu"
    mk = tmp_path / "Makefile"
    lib = tmp_path / "lib.so"
    src.write_text("x")
    mk.write_text("x")
    assert tc._stale(str(lib), str(tmp_path))  # missing library
    lib.write_text("x")
    later = time.time() + 10
    os.utime(lib, (later, later))
    assert not tc._stale(str(lib), str(tmp_path))
    os.utime(src, (later + 10, later + 10))
    assert tc._stale(str(lib), str(tmp_path))  # source newer


def test_gpu_without_library_is_an_error(tmp_path, monkeypatch):
    """On a GPU, "auto" means the kernel: a library that cannot be
    built raises instead of falling back to the XLA walk."""
    monkeypatch.setattr(tc, "_NATIVE", str(tmp_path))  # no Makefile
    monkeypatch.setattr(tc, "LIB_PATH", str(tmp_path / "missing.so"))
    monkeypatch.setattr(tc, "_registered", False)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    from sycl_ray_tracer_tpu.models.scene import build_device_scene
    from sycl_ray_tracer_tpu.utils.fixtures import triangle_scene_glb
    from sycl_ray_tracer_tpu.utils.gltf import load_glb

    scene = build_device_scene(load_glb(triangle_scene_glb()))
    o, d = _rays(np.random.RandomState(0), 8)
    with pytest.raises(RuntimeError, match="make -C native cuda"):
        trace.intersect_scene(scene, o, d)


# ---------------------------------------------------------------- card

@pytest.mark.gpu
@pytest.mark.parametrize("leaf_size", [1, 4, 8])
def test_kernel_matches_traverse8(gpu_device, rs, leaf_size):
    tri = _soup(rs, 3000)
    bvh, _, _ = wbvh.build_np(tri, leaf_size)
    o, d = _rays(rs, 20000)
    act = jnp.asarray(rs.rand(20000) < 0.8)
    nodes = jnp.asarray(bvh.nodes)
    args = (bvh.num_internal, bvh.depth, leaf_size)
    tc.ensure_registered()
    hx = jax.jit(lambda n, o, d, a: wbvh.traverse8(
        n, *args, o, d, active_in=a))(nodes, o, d, act)
    hc = jax.jit(lambda n, o, d, a: tc.traverse8_cuda(
        n, *args, o, d, active_in=a))(nodes, o, d, act)
    tx, ix = np.asarray(hx.t), np.asarray(hx.tri)
    tk, ik = np.asarray(hc.t), np.asarray(hc.tri)
    assert ((ix >= 0) == (ik >= 0)).all()
    assert (ik[~np.asarray(act)] == -1).all()
    both = ix >= 0
    assert both.sum() > 1000
    assert np.allclose(tx[both], tk[both], rtol=1e-5)
    assert (ix[both] == ik[both]).mean() >= 0.9999
    assert np.allclose(np.asarray(hx.u)[both], np.asarray(hc.u)[both],
                       atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["wavefront", "megakernel"])
def test_kernel_renders_like_traverse8(gpu_device, engine):
    import dataclasses

    from sycl_ray_tracer_tpu.models.oracle import rmse
    from sycl_ray_tracer_tpu.models.renderer import get_renderer
    from sycl_ray_tracer_tpu.utils.fixtures import cube_scene_glb, load_pair

    scene, _, cam = load_pair(cube_scene_glb(), 96, 96, leaf_size=8)
    render = get_renderer(engine)
    kw = dict(width=96, height=96, spp=4, max_depth=8, seed=1)
    a, ra = render(scene, cam, **kw)  # "auto": the kernel on a GPU
    b, rb = render(dataclasses.replace(scene, intersector="xla"), cam, **kw)
    assert rmse(np.asarray(a), np.asarray(b)) < 2e-3
    assert abs(int(np.asarray(ra).sum()) - int(np.asarray(rb).sum())) \
        <= int(np.asarray(rb).sum()) // 1000
