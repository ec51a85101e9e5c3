"""One path-vertex step shared by both renderers.

Parity target: trace_ray.hpp:11-82, including its exact termination
algebra (these quirks are load-bearing for RMSE parity with the oracle):

- miss       -> contribute attenuation * (sky_color + radiance)
- hit        -> radiance += emitted(); scatter
- absorbed   -> contribute attenuation * radiance
- scattered  -> origin += t * dir (unnormalized dir!), dir = scatter dir,
                attenuation *= scatter attenuation, path continues

Returns masked updates; callers (megakernel fori/while loop, wavefront
scan) own the loop structure.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from sycl_ray_tracer_tpu.models import materials as mats
from sycl_ray_tracer_tpu.models.scene import INTERSECTORS
from sycl_ray_tracer_tpu.ops.intersect import Hit
from sycl_ray_tracer_tpu.ops.wbvh import traverse8
from sycl_ray_tracer_tpu.ops.vec import V3, normalize, where


class PathState(NamedTuple):
    o: V3            # ray origin
    d: V3            # ray direction (unnormalized, reference convention)
    att: V3          # accumulated attenuation
    rad: V3          # accumulated radiance
    result: V3       # final color once done
    done: jnp.ndarray  # bool


def resolve_intersector(name: str, platform: str) -> str:
    """The walk a scene's static `intersector` field selects on a
    platform: "auto" is the CUDA kernel on a GPU and the XLA walk
    (traverse8) elsewhere; "xla", "cuda" and "lbvh" name one walk."""
    if name not in INTERSECTORS:
        raise ValueError(f"unknown intersector {name!r}; "
                         f"choices: {INTERSECTORS}")
    if name == "auto":
        return "cuda" if platform == "gpu" else "xla"
    if name == "cuda" and platform != "gpu":
        raise ValueError("intersector 'cuda' needs an NVIDIA GPU; "
                         f"the default backend is {platform!r}")
    return name


def intersect_scene(scene, o: V3, d: V3,
                    active: jnp.ndarray | None = None) -> Hit:
    """Closest hit of every ray (the reference's rtcIntersect1,
    trace_ray.hpp:22) through the walk `scene.intersector` selects."""
    kind = resolve_intersector(scene.intersector, jax.default_backend())
    if kind == "lbvh":
        # independently selectable binary-LBVH path (scene.py); the
        # Sponza-scale convergence gate renders through this and the
        # default path with shared RNG/estimator (tests/test_render.py)
        from sycl_ray_tracer_tpu.ops.traverse import traverse
        return traverse(scene.lbvh_lo, scene.lbvh_hi, scene.lbvh_v0,
                        scene.lbvh_e1, scene.lbvh_e2, o, d,
                        scene.leaf_size, active_in=active)
    if kind == "cuda":
        from sycl_ray_tracer_tpu.ops import traverse_cuda
        traverse_cuda.ensure_registered()
        return traverse_cuda.traverse8_cuda(
            scene.bvh_nodes, scene.bvh_ni, scene.bvh_depth,
            scene.leaf_size, o, d, active_in=active)
    return traverse8(scene.bvh_nodes, scene.bvh_ni,
                     scene.bvh_depth, scene.leaf_size,
                     o, d, active_in=active)


# Russian roulette starts at this bounce (rr=True paths only) and
# clamps survival probability to at least this floor.
RR_START = 3
RR_FLOOR = 0.05


def rr_survive(att, key, counter):
    """Russian-roulette survival: (survive_mask, scaled_att).

    Survival probability = max throughput component (clamped); the
    survivor's throughput is scaled by 1/p, keeping the estimator
    unbiased. Extension over the reference (which never terminates
    early); required by BASELINE config 3.
    """
    from sycl_ray_tracer_tpu.ops import rng as _rng

    p = jnp.clip(jnp.maximum(att.x, jnp.maximum(att.y, att.z)),
                 RR_FLOOR, 1.0)
    u = _rng.uniform(key, jnp.asarray(counter, jnp.uint32)
                     + jnp.uint32(0x33333333))
    survive = u < p
    inv_p = 1.0 / p
    return survive, V3(att.x * inv_p, att.y * inv_p, att.z * inv_p)


def shade_lanes(scene, hit: Hit):
    """Interpolated shading inputs for hit lanes (garbage on miss
    lanes; callers mask).

    Parity: barycentric normal/UV interpolation + normalize of
    trace_ray.hpp:32-59. ONE row take from the triangle-major packed
    geometry table (scene.shade_tbl [LK, 16]: normals, uv, mat id)
    plus small [M]-table takes keyed by the gathered mat id for the
    material constants."""
    safe_tri = jnp.maximum(hit.tri, 0)
    g = jnp.take(scene.shade_tbl, safe_tri, axis=0)      # [R, 16]
    c = [g[:, i] for i in range(16)]
    w = 1.0 - hit.u - hit.v
    nx = w * c[0] + hit.u * c[3] + hit.v * c[6]
    ny = w * c[1] + hit.u * c[4] + hit.v * c[7]
    nz = w * c[2] + hit.u * c[5] + hit.v * c[8]
    normal = normalize(V3(nx, ny, nz), eps=1e-20)
    uv_u = w * c[9] + hit.u * c[11] + hit.v * c[13]
    uv_v = w * c[10] + hit.u * c[12] + hit.v * c[14]
    mid = c[15].astype(jnp.int32)
    mat = mats.MatLanes(
        mtype=jnp.take(scene.mat_type, mid),
        albedo=V3(jnp.take(scene.mat_albedo[:, 0], mid),
                  jnp.take(scene.mat_albedo[:, 1], mid),
                  jnp.take(scene.mat_albedo[:, 2], mid)),
        tex=jnp.take(scene.mat_tex, mid),
        rough=jnp.take(scene.mat_rough, mid),
        ior=jnp.take(scene.mat_ior, mid),
        emissive=V3(jnp.take(scene.mat_emissive[:, 0], mid),
                    jnp.take(scene.mat_emissive[:, 1], mid),
                    jnp.take(scene.mat_emissive[:, 2], mid)),
    )
    return normal, uv_u, uv_v, mat


def trace_step(scene, state: PathState, key: jnp.ndarray,
               bounce_counter, rr: bool = False,
               bounce_idx=None) -> PathState:
    """Advance every non-done lane by one path vertex."""
    o, d, att, rad = state.o, state.d, state.att, state.rad
    live = ~state.done

    hit = intersect_scene(scene, o, d, active=live)
    miss = hit.tri < 0

    sky = scene.sky_color
    sky_v = V3(sky[0], sky[1], sky[2])
    res_miss = att * (sky_v + rad)  # trace_ray.hpp:25-27

    # ---- shading data for hit lanes (garbage on miss lanes, masked) --
    normal, uv_u, uv_v, mat = shade_lanes(scene, hit)
    rad_hit = rad + mat.emissive  # trace_ray.hpp:64

    d_unit = normalize(d, eps=1e-20)
    cont, new_dir, s_att = mats.scatter(scene, mat, d_unit, normal,
                                        uv_u, uv_v, key, bounce_counter)

    res_absorb = att * rad_hit  # trace_ray.hpp:77-79

    hit_m = live & ~miss
    scat_m = hit_m & cont
    term_miss = live & miss
    term_abs = hit_m & ~cont

    new_att_s = att * s_att
    if rr:
        bi = bounce_counter - 2 if bounce_idx is None else bounce_idx
        survive, att_rr = rr_survive(new_att_s, key, bounce_counter)
        apply_rr = scat_m & (jnp.asarray(bi, jnp.int32) >= RR_START)
        term_rr = apply_rr & ~survive
        scat_m = scat_m & ~term_rr
        new_att_s = where(apply_rr & survive, att_rr, new_att_s)
    else:
        term_rr = jnp.zeros_like(term_abs)

    new_o = where(scat_m, o + d * hit.t, o)
    new_d = where(scat_m, new_dir, d)
    new_att = where(scat_m, new_att_s, att)
    new_rad = where(scat_m, rad_hit, rad)

    # an RR kill contributes like an absorb: att * radiance-so-far
    result = where(term_miss, res_miss,
                   where(term_abs | term_rr, res_absorb, state.result))
    done = state.done | term_miss | term_abs | term_rr

    return PathState(o=new_o, d=new_d, att=new_att, rad=new_rad,
                     result=result, done=done)
