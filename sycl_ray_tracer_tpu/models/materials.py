"""Vectorized material evaluation: diffuse / metallic / dielectric.

Parity target: material.hpp. The reference's tagged-union dispatch
(material.hpp:211-228) becomes branch-free masked evaluation: all three
scatter models are computed for every lane and the per-lane material
type selects the result. On a vector machine this is cheaper than any
divergence scheme as long as the models are a few dozen VPU ops each
(they are).

Deviation (documented, SURVEY.md section 7): the diffuse near-zero guard
tests the *scattered* direction, fixing the reference's bug of testing
the incident direction (material.hpp:81-83).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from sycl_ray_tracer_tpu.ops import rng as _rng
from sycl_ray_tracer_tpu.ops.sampling import random_unit_vector
from sycl_ray_tracer_tpu.ops.vec import (V3, dot, near_zero, normalize,
                                         reflect, refract, where)
from sycl_ray_tracer_tpu.utils.gltf import (MAT_DIELECTRIC, MAT_DIFFUSE,
                                            MAT_METALLIC)


class MatLanes(NamedTuple):
    """Per-lane material properties, gathered from the scene tables."""
    mtype: jnp.ndarray
    albedo: V3
    tex: jnp.ndarray
    rough: jnp.ndarray
    ior: jnp.ndarray
    emissive: V3


def gather_materials(scene, tri_idx: jnp.ndarray) -> MatLanes:
    mid = jnp.take(scene.tri_mat, jnp.maximum(tri_idx, 0), axis=0)
    alb = jnp.take(scene.mat_albedo, mid, axis=0)
    emi = jnp.take(scene.mat_emissive, mid, axis=0)
    return MatLanes(
        mtype=jnp.take(scene.mat_type, mid, axis=0),
        albedo=V3(alb[..., 0], alb[..., 1], alb[..., 2]),
        tex=jnp.take(scene.mat_tex, mid, axis=0),
        rough=jnp.take(scene.mat_rough, mid, axis=0),
        ior=jnp.take(scene.mat_ior, mid, axis=0),
        emissive=V3(emi[..., 0], emi[..., 1], emi[..., 2]),
    )


def sample_texture(scene, tex: jnp.ndarray,
                   u: jnp.ndarray, v: jnp.ndarray) -> V3:
    """Nearest-filter, repeat-wrap atlas lookup.

    Mirrors the reference sampler config (normalized coords, repeat,
    nearest — render_wavefront.cpp:193-197) and its unorm_int8 read
    (bytes / 255, no sRGB decode). Lanes with tex < 0 get garbage here
    and are masked by the caller. The gather pulls ONE packed uint32
    per lane (scene.tex_packed) — bit-identical to the [R, 4] uint8
    row gather but a quarter of the moved bytes.
    """
    res = scene.tex_res
    x = jnp.floor(u * res).astype(jnp.int32) % res
    y = jnp.floor(v * res).astype(jnp.int32) % res
    t = jnp.maximum(tex, 0)
    idx = (t * res + y) * res + x
    w = jnp.take(scene.tex_packed, idx, axis=0)
    s = jnp.float32(1.0 / 255.0)
    return V3((w & jnp.uint32(0xFF)).astype(jnp.float32) * s,
              ((w >> jnp.uint32(8)) & jnp.uint32(0xFF)
               ).astype(jnp.float32) * s,
              ((w >> jnp.uint32(16)) & jnp.uint32(0xFF)
               ).astype(jnp.float32) * s)


def albedo_lanes(scene, mat: MatLanes, u, v) -> V3:
    solid = mat.albedo
    # Static specialization: textureless scenes skip the [R] random-
    # access atlas gather entirely. has_textures is a build-time
    # static field (the loaders always emit a >=1-entry dummy atlas,
    # so a size check alone would never fire).
    if not getattr(scene, "has_textures", True):
        return solid
    tex = sample_texture(scene, mat.tex, u, v)
    return where(mat.tex >= 0, tex, solid)


def _schlick(cosine: jnp.ndarray, ref_idx: jnp.ndarray) -> jnp.ndarray:
    """material.hpp:120-125."""
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    m = 1.0 - cosine
    m2 = m * m
    return r0 + (1.0 - r0) * (m2 * m2 * m)


def scatter(scene, mat: MatLanes, d_unit: V3, normal: V3,
            uv_u: jnp.ndarray, uv_v: jnp.ndarray,
            key: jnp.ndarray, counter) -> tuple:
    """All-lanes scatter. Returns (continue_mask, new_dir, attenuation).

    d_unit must be unit length (trace_ray.hpp:61-62 normalizes before
    shading). new_dir is intentionally NOT normalized — the reference
    traces the raw scattered direction (trace_ray.hpp:72-74).
    """
    ruv = random_unit_vector(key, counter)
    u1 = _rng.uniform(key, jnp.asarray(counter, jnp.uint32)
                      + jnp.uint32(0x55555555))

    albedo = albedo_lanes(scene, mat, uv_u, uv_v)

    # --- diffuse (material.hpp:72-86) --------------------------------
    dir_diff = normal + ruv
    dir_diff = where(near_zero(dir_diff), normal, dir_diff)

    # --- metallic (material.hpp:98-110) ------------------------------
    refl = reflect(d_unit, normal)
    dir_met = refl + ruv * mat.rough
    ok_met = dot(dir_met, normal) > 0.0

    # --- dielectric (material.hpp:127-156) ---------------------------
    front = dot(d_unit, normal) < 0.0
    n_face = where(front, normal, -normal)
    ratio = jnp.where(front, 1.0 / mat.ior, mat.ior)
    cos_t = jnp.minimum(dot(-d_unit, n_face), 1.0)
    sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
    cannot = ratio * sin_t > 1.0
    do_reflect = cannot | (_schlick(cos_t, ratio) > u1)
    dir_diel = where(do_reflect, reflect(d_unit, n_face),
                     refract(d_unit, n_face, ratio))

    # --- select by type ----------------------------------------------
    is_diff = mat.mtype == MAT_DIFFUSE
    is_met = mat.mtype == MAT_METALLIC
    is_diel = mat.mtype == MAT_DIELECTRIC

    new_dir = where(is_diff, dir_diff, where(is_met, dir_met, dir_diel))
    one = jnp.ones_like(albedo.x)
    atten = where(is_diel, V3(one, one, one), albedo)
    cont = jnp.where(is_met, ok_met, is_diff | is_diel)
    return cont, new_dir, atten
