"""Native (C++) vs pure-Python GLB ingest equivalence."""

import numpy as np
import pytest

from sycl_ray_tracer_tpu.utils import native_loader
from sycl_ray_tracer_tpu.utils.gltf import load_glb

from sycl_ray_tracer_tpu.utils import fixtures as scenes

pytestmark = pytest.mark.skipif(
    not native_loader.available(),
    reason="native library not built (no compiler?)")


def _compare(glb_bytes, **kw):
    py = load_glb(glb_bytes, use_native=False, **kw)
    nat = load_glb(glb_bytes, use_native=True, **kw)
    assert nat.num_triangles == py.num_triangles
    assert np.allclose(nat.tri_v, py.tri_v, atol=1e-5)
    assert np.allclose(nat.tri_n, py.tri_n, atol=1e-5)
    assert np.allclose(nat.tri_uv, py.tri_uv, atol=1e-6)
    assert (nat.tri_mat == py.tri_mat).all()
    assert (nat.materials.mtype == py.materials.mtype).all()
    assert np.allclose(nat.materials.albedo, py.materials.albedo)
    assert (nat.materials.tex_id == py.materials.tex_id).all()
    assert np.allclose(nat.materials.roughness, py.materials.roughness)
    assert np.allclose(nat.materials.ior, py.materials.ior)
    assert np.allclose(nat.materials.emissive, py.materials.emissive)
    assert np.allclose(nat.sky_color, py.sky_color)
    assert np.allclose(nat.camera_position, py.camera_position, atol=1e-5)
    assert np.allclose(nat.camera_direction, py.camera_direction, atol=1e-6)
    assert np.isclose(nat.camera_focal_length, py.camera_focal_length)
    assert nat.textures.shape == py.textures.shape
    assert (nat.textures == py.textures).all()


def test_triangle_scene():
    _compare(scenes.triangle_scene_glb())


def test_cube_scene():
    _compare(scenes.cube_scene_glb())


def test_dielectric_scene():
    _compare(scenes.dielectric_scene_glb(subdiv=1))


def test_textured_scene():
    _compare(scenes.textured_scene_glb())


def test_global_scale():
    _compare(scenes.cube_scene_glb(), global_scale=(2.0, 0.5, 1.0))


def test_procedural_sponza():
    from sycl_ray_tracer_tpu.utils.procgen import sponza_like_glb

    _compare(sponza_like_glb(scale=1))


def test_truncated_glb_is_rejected_not_oob():
    # regression: a truncated BIN chunk used to pass
    # the start-offset-only check and read out of bounds. The native
    # loader must now reject it (accessor range validated against the
    # BIN length) instead of segfaulting.
    full = scenes.cube_scene_glb()
    # chop the tail of the BIN chunk but keep the JSON chunk intact:
    # the JSON chunk comes first, so removing trailing bytes truncates
    # vertex/index data while the accessors still promise full counts
    truncated = full[: len(full) - 256]
    with pytest.raises(ValueError, match="accessor|parse|BIN|JSON"):
        native_loader.load_glb_native(truncated)


def test_reference_assets():
    import os

    for name in ("triangle", "cube"):
        p = f"/root/reference/assets/{name}.glb"
        if os.path.exists(p):
            with open(p, "rb") as f:
                _compare(f.read())


# ---- malformed-input robustness (round-3 review findings) ----
# Every case must fail (or degrade) CLEANLY through BOTH ingest paths:
# the native side errors through srt_error (-> ValueError -> fallback),
# never a segfault/abort across the C ABI.

import json as _json
import struct as _struct


def _mk_glb(gltf: dict, bin_: bytes = b"") -> bytes:
    j = _json.dumps(gltf).encode()
    j += b" " * ((4 - len(j) % 4) % 4)
    chunks = _struct.pack("<II", len(j), 0x4E4F534A) + j
    if bin_:
        bin_ = bin_ + b"\x00" * ((4 - len(bin_) % 4) % 4)
        chunks += _struct.pack("<II", len(bin_), 0x004E4942) + bin_
    return (b"glTF" + _struct.pack("<II", 2, 12 + len(chunks)) + chunks)


def _tri_gltf(**patch):
    """Minimal one-triangle GLB parts; patch overrides top-level keys."""
    import numpy as np
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    bin_ = v.tobytes()
    g = {
        "asset": {"version": "2.0"},
        "buffers": [{"byteLength": len(bin_)}],
        "bufferViews": [{"buffer": 0, "byteOffset": 0,
                         "byteLength": len(bin_)}],
        "accessors": [{"bufferView": 0, "componentType": 5126,
                       "count": 3, "type": "VEC3"}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0}}]}],
        "nodes": [{"mesh": 0}],
        "scenes": [{"nodes": [0]}],
        "scene": 0,
    }
    g.update(patch)
    return g, bin_


def test_overflow_stride_rejected():
    # stride*(count-1) wraps size_t: the division-form bounds check
    # must reject it instead of letting get() read at data + 2^52
    g, bin_ = _tri_gltf()
    g["bufferViews"][0]["byteStride"] = 1 << 52
    g["accessors"][0]["count"] = 4097
    with pytest.raises(Exception):
        native_loader.load_glb_native(_mk_glb(g, bin_))
    with pytest.raises(Exception):
        load_glb(_mk_glb(g, bin_), use_native=False)


def test_huge_count_without_bufferview_rejected():
    # an indices accessor with no bufferView keeps its count (spec:
    # zero-filled); an absurd count must not drive a multi-GB resize
    # whose length_error would abort the process across the C ABI
    g, bin_ = _tri_gltf()
    g["accessors"].append({"componentType": 5125, "count": int(1e15),
                           "type": "SCALAR"})
    g["meshes"][0]["primitives"][0]["indices"] = 1
    with pytest.raises(Exception):
        native_loader.load_glb_native(_mk_glb(g, bin_))


def test_truncated_number_stops_at_chunk_end():
    # a JSON chunk ending mid-number: strtod must not run past the
    # chunk into the BIN bytes (which here continue with digits)
    g, bin_ = _tri_gltf()
    j = _json.dumps(g).encode()
    cut = j[: j.rindex(b"0") + 1]  # ends with a digit, invalid JSON
    chunks = _struct.pack("<II", len(cut), 0x4E4F534A) + cut
    chunks += _struct.pack("<II", 8, 0x004E4942) + b"12345678"
    data = b"glTF" + _struct.pack("<II", 2, 12 + len(chunks)) + chunks
    with pytest.raises(Exception):
        native_loader.load_glb_native(data)


def test_cyclic_node_graph_rejected():
    g, bin_ = _tri_gltf()
    g["nodes"] = [{"children": [1]}, {"children": [0], "mesh": 0}]
    with pytest.raises(ValueError, match="deep|cyclic"):
        native_loader.load_glb_native(_mk_glb(g, bin_))


def test_byte_stride_zero_parity():
    # byteStride 0 is malformed (spec min 4); both loaders must coerce
    # it to the tight stride and agree
    g, bin_ = _tri_gltf()
    g["bufferViews"][0]["byteStride"] = 0
    _compare(_mk_glb(g, bin_))
    py = load_glb(_mk_glb(g, bin_), use_native=False)
    assert py.num_triangles == 1
    assert not np.allclose(py.tri_v[0, 0], py.tri_v[0, 1])


def test_sky_color_len2_defaults_both_loaders():
    from sycl_ray_tracer_tpu.utils.gltf import DEFAULT_SKY
    g, bin_ = _tri_gltf()
    g["scenes"][0]["extras"] = {"sky_color": [9.0, 9.0]}
    py = load_glb(_mk_glb(g, bin_), use_native=False)
    nat = load_glb(_mk_glb(g, bin_), use_native=True)
    assert py.sky_color.shape == (3,)
    assert np.allclose(py.sky_color, DEFAULT_SKY)
    assert np.allclose(nat.sky_color, py.sky_color)


def test_zero_scale_node_parity():
    # a singular node transform (zero scale) must load in BOTH paths
    # with the same zero-filled normal matrix (adjugate det==0 rule),
    # not crash the python loader with LinAlgError
    import numpy as np
    n = np.array([[0, 0, 1]] * 3, np.float32)
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    bin_ = v.tobytes() + n.tobytes()
    g, _ = _tri_gltf()
    g["buffers"] = [{"byteLength": len(bin_)}]
    g["bufferViews"] = [
        {"buffer": 0, "byteOffset": 0, "byteLength": 36},
        {"buffer": 0, "byteOffset": 36, "byteLength": 36}]
    g["accessors"] = [
        {"bufferView": 0, "componentType": 5126, "count": 3,
         "type": "VEC3"},
        {"bufferView": 1, "componentType": 5126, "count": 3,
         "type": "VEC3"}]
    g["meshes"][0]["primitives"][0]["attributes"]["NORMAL"] = 1
    g["nodes"] = [{"mesh": 0, "scale": [1.0, 0.0, 1.0]}]
    py = load_glb(_mk_glb(g, bin_), use_native=False)
    nat = load_glb(_mk_glb(g, bin_), use_native=True)
    assert (py.tri_n == 0).all()          # zero-filled normal matrix
    assert (nat.tri_n == py.tri_n).all()
    assert np.allclose(nat.tri_v, py.tri_v)
