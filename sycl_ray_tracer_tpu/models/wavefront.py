"""Wavefront renderer: bounce-synchronous compacted ray queues.

Parity target: render_wavefront.cpp (stages: generate_camera_rays :79,
shoot_rays :139, merge_samples :319, convert_image_to_srgb :360).

Redesign of each mechanism for JAX:

- Double-buffered SoA queues + parity swap (render_wavefront.hpp:47-70)
  -> a single functional queue threaded through lax.while_loop; XLA's
  buffer donation provides the double-buffering.
- Work-group local-memory compaction with one global atomic per group
  (render_wavefront.cpp:162-311, the reference's signature trick)
  -> exclusive-cumsum stream compaction + scatter-with-drop (or a
  coherence-sorting argsort, see _compact).
- Terminated rays writing pixels in-kernel (:275-281)
  -> masked scatter-add into the sample accumulator keyed by ray id
  (ids survive compaction, exactly like the reference's RayData.id).
- The per-bounce host readback of the queue length (:144, a device->
  host sync every bounce!) -> the count stays device-resident in the
  while_loop carry; the host is never consulted mid-frame.
- Rays still alive after max_depth contribute black, like the
  reference (their queue entries are simply dropped).

`accumulate_wavefront` is the unjitted linear-space core shared with
the multi-chip path (parallel/mesh.py). Queue entries carry the LOCAL
lane id (accumulator index); RNG keys are precomputed per local lane
from the GLOBAL ray id, so a sharded render stays decorrelated across
devices while scatter stays shard-local.
"""

from __future__ import annotations

import functools
import os
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sycl_ray_tracer_tpu.models import materials as mats
from sycl_ray_tracer_tpu.models import trace as _trace
from sycl_ray_tracer_tpu.models.camera import Camera, generate_rays
from sycl_ray_tracer_tpu.ops import rng as _rng
from sycl_ray_tracer_tpu.ops.vec import V3, linear_to_gamma, normalize, where


def _pack_f16_pair(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Two f32 lanes -> one f32 lane holding 2 f16 (round-to-nearest)."""
    ah = jax.lax.bitcast_convert_type(
        a.astype(jnp.float16), jnp.uint16).astype(jnp.uint32)
    bh = jax.lax.bitcast_convert_type(
        b.astype(jnp.float16), jnp.uint16).astype(jnp.uint32)
    return jax.lax.bitcast_convert_type(ah | (bh << 16), jnp.float32)


def _unpack_f16_pair(p: jnp.ndarray):
    w = jax.lax.bitcast_convert_type(p, jnp.uint32)
    a = jax.lax.bitcast_convert_type(
        (w & 0xFFFF).astype(jnp.uint16), jnp.float16)
    b = jax.lax.bitcast_convert_type(
        (w >> 16).astype(jnp.uint16), jnp.float16)
    return a.astype(jnp.float32), b.astype(jnp.float32)


def interleave_waves(run_wave, specs, *, serial: bool = False):
    """Run (s, w) wave specs through run_wave, interleaved across
    SRT_WAVE_THREADS host threads (default 2); returns results in SPEC
    order. Shared by both engines and the sharded host loop so the
    interleave policy cannot drift between them.

    Why: each wave's host loop blocks on one live-count readback per
    bounce. Driving two waves from two threads can fill one wave's
    readback gap with the other wave's queued programs. Whether that
    still pays on a GPU, whose dispatch is asynchronous, is not
    measured yet.

    Output must stay BIT-identical to the serial loop: callers sum the
    returned per-wave accumulators in this list's (spec) order, and
    each wave's device programs are unchanged — threading is pure
    host-side scheduling.

    Memory: each in-flight wave holds its full queue state on device
    (~52 bytes per ray of packed columns plus sort temporaries), so
    threads=2 roughly doubles peak device memory for queues; when
    raising SRT_WAVE_RAYS toward single-wave capacity, drop
    SRT_WAVE_THREADS to 1.

    serial=True forces one thread regardless of the env (used when
    SRT_PROFILE=1: per-bounce wall clocks would otherwise include the
    concurrent wave's device occupancy and read as noise)."""
    n_threads = 1 if serial else int(os.environ.get("SRT_WAVE_THREADS",
                                                    "2"))
    if n_threads > 1 and len(specs) > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=n_threads) as pool:
            return list(pool.map(lambda sw: run_wave(*sw), specs))
    return [run_wave(*sw) for sw in specs]


@functools.partial(jax.jit, static_argnames=("b",))
def shrink_queue(cols, *, b: int):
    """Slice every queue column to the next bucket size in ONE device
    program: the eager form would compile thirteen single-slice
    programs per (in, out) shape transition. (No donation: the smaller
    outputs can't alias the inputs, and the host drops its source refs
    right after the call anyway.)"""
    return tuple(a[:b] for a in cols)


def bucket_of(c: int, cap: int, floor_bits: int = 16) -> int:
    """Program-shape bucket for a live count of c (host-side int math).

    Survivors are a compacted prefix, so later bounces can run
    programs sized to the live count. Bucket sizes are 2^k AND
    3*2^(k-1) (…, 2M, 3M, 4M, 6M, 8M, …): the half-step cuts the
    dead-row tail from <=100% to <=50% overhead rows — early
    bounces sit just above a power of two (e.g. 12.4M live in a
    16.7M bucket) and pay the whole gap in sort/shade row tolls.
    The 2^floor_bits floor bounds the compiled-shape count (64K
    single-chip; the sharded host loop uses 16K because its per-shard
    queues are 1/(dp*sp) the size). Shared with parallel/mesh.py so
    the single-chip and sharded bucketing can't drift."""
    b = 1 << max(int(c - 1).bit_length(), floor_bits)
    if c <= (b >> 2) * 3:
        b = (b >> 2) * 3
    return min(b, cap)


def _compact(alive: jnp.ndarray, arrays, capacity: int,
             sort_key: jnp.ndarray | None = None,
             f16_fields: tuple = ()):
    """Stream compaction: returns (new_arrays, count).

    Without a key: exclusive-cumsum + scatter-with-drop (order
    preserving). With a key: one ascending argsort where dead lanes get
    the max key — this both compacts AND coherence-sorts the survivors,
    which keeps neighbouring rays coherent on diffuse bounces (an
    analog of the reference's sort-by-material idea it never
    implemented, PLAN.md).

    The payload moves as ONE PACKED [N, W] array (one row gather
    instead of W column gathers); int32 lanes ride along bitcast to
    f32.

    f16_fields: indices whose values ride as HALF-precision pairs (two
    per f32 lane) — the analog of the reference's fp16 RayData
    (camera.hpp:12-63, dir/attenuation/radiance in sycl::half), behind
    the SRT_F16_QUEUE flag. Values round-trip f32->f16->f32 through
    every bounce exactly like the reference's do.
    """
    f16 = list(f16_fields)
    pairs = [(f16[i], f16[i + 1]) for i in range(0, len(f16) - 1, 2)]
    tail = f16[-1] if len(f16) % 2 else None
    f16set = set(f16)

    cols = []
    for i, a in enumerate(arrays):
        if i in f16set:
            continue
        cols.append(a if a.dtype == jnp.float32 else
                    jax.lax.bitcast_convert_type(a, jnp.float32))
    for i, j in pairs:
        cols.append(_pack_f16_pair(arrays[i], arrays[j]))
    if tail is not None:
        cols.append(_pack_f16_pair(arrays[tail],
                                   jnp.zeros_like(arrays[tail])))
    packed = jnp.stack(cols, axis=1)
    if sort_key is None:
        pos = jnp.cumsum(alive.astype(jnp.int32)) - 1
        dst = jnp.where(alive, pos, capacity)
        packed = jnp.zeros_like(packed).at[dst].set(packed, mode="drop")
    else:
        # Kept lanes are clamped one below the dead sentinel: a raw
        # coherence key CAN reach 0xFFFFFFFF (cell_oct_morton at the
        # scene_hi corner cell with an all-negative direction), and a
        # kept lane tying with dead pad could sort past the bucket the
        # host shrinks to next — silently dropping a live path. The
        # clamp only reorders lanes within one key value (coherence
        # noise), never membership. (The 3-way deferred key is safe by
        # construction — survivors top-bit-clear, terminated
        # 0x80000000|pix — so this is for the raw-key paths: the
        # megakernel re-sort and the sharded bounce.)
        key = jnp.where(alive, jnp.minimum(sort_key, jnp.uint32(0xFFFFFFFE)),
                        jnp.uint32(0xFFFFFFFF))
        perm = jnp.argsort(key)
        packed = jnp.take(packed, perm, axis=0)

    out = [None] * len(arrays)
    c = 0
    for i, a in enumerate(arrays):
        if i in f16set:
            continue
        out[i] = (packed[:, c] if a.dtype == jnp.float32 else
                  jax.lax.bitcast_convert_type(packed[:, c], a.dtype))
        c += 1
    for i, j in pairs:
        out[i], out[j] = _unpack_f16_pair(packed[:, c])
        c += 1
    if tail is not None:
        out[tail], _ = _unpack_f16_pair(packed[:, c])
    return out, jnp.sum(alive.astype(jnp.int32))


# Bounce-queue sort key (read once at import; passed into traced code
# as a static choice: os.environ read inside a traced function is a
# silent no-op after the first compile):
#   oct_morton  (octant << 27) | morton27(origin)   — round-1 default
#   dir6_morton (6-bit direction bin << 24) | morton24 — finer binning
#   leaf_oct    (hit leaf id << 3) | octant — rays from the same BVH
#               leaf start traversal in the same neighborhood. The
#               "leaf id" is the canonical Morton slot group
#               (tri // 8), NOT the traversed tree's leaf when an
#               SAH remap is active — i.e. a spatial-locality proxy
#   none        compaction without sorting
#   cell_oct_morton  coarse cell | octant | fine morton — groups by
#               place first, direction second
SORT_MODE = os.environ.get("SRT_SORT_KEY",
                           "none" if os.environ.get("SRT_NO_SORT")
                           else "dir6_morton")


def _coherence_key(scene, o: V3, d: V3, hit_tri=None,
                   mode: str = None) -> jnp.ndarray | None:
    """Coherence sort key for surviving bounce rays (see SORT_MODE)."""
    from sycl_ray_tracer_tpu.ops.lbvh import morton30

    mode = mode or SORT_MODE
    if mode == "none":
        return None
    oct_ = ((d.x < 0).astype(jnp.uint32) << 2
            | (d.y < 0).astype(jnp.uint32) << 1
            | (d.z < 0).astype(jnp.uint32))
    if mode == "leaf_oct" and hit_tri is not None:
        leaf = (jnp.maximum(hit_tri, 0) // 8).astype(jnp.uint32)
        return (leaf << jnp.uint32(3)) | oct_
    p = jnp.stack([o.x, o.y, o.z], axis=-1)
    m = morton30(p, scene.scene_lo, scene.scene_hi)
    if mode == "cell_oct_morton":
        # coarse spatial cell FIRST (top 9 morton bits = 512 cells),
        # then direction octant, then fine position: packets form
        # within one cell+octant instead of one global direction bin
        return (((m >> jnp.uint32(21)) << jnp.uint32(23))
                | (oct_ << jnp.uint32(20))
                | ((m >> jnp.uint32(1)) & jnp.uint32(0xFFFFF)))
    if mode == "dir6_morton":
        # 2 extra direction bits per axis: dominant-component halves
        ax = jnp.abs(d.x)
        ay = jnp.abs(d.y)
        az = jnp.abs(d.z)
        dom = jnp.where(ax > ay, jnp.where(ax > az, 0, 2),
                        jnp.where(ay > az, 1, 2)).astype(jnp.uint32)
        return ((oct_ << jnp.uint32(29)) | (dom << jnp.uint32(27))
                | (m >> jnp.uint32(5)))
    return (oct_ << jnp.uint32(27)) | (m >> jnp.uint32(3))


def _bounce(scene, key_lane, carry, bounce_idx, capacity,
            rr: bool = False,
            f16_queue: bool = False, deferred_acc: bool = False,
            key_seed=None):
    """One wavefront iteration over the live queue prefix.

    deferred_acc (host-driven path only): instead of scatter-adding
    every lane's contribution into the pixel accumulator each bounce
    (pays the ~32 ns/row scatter toll on the WHOLE bucket), terminated
    rays ride the compaction argsort into a contiguous tail segment
    [new_count, count) sorted by pixel, carrying their contribution in
    3 extra packed lanes; the host then runs one small scatter over
    just that segment (_scatter_terminated). Total scatter rows per
    wave drop from bucket x depth to ~cap."""
    (q_ox, q_oy, q_oz, q_dx, q_dy, q_dz,
     q_ar, q_ag, q_ab, q_rr, q_rg, q_rb, q_id, count, acc, rays) = carry

    lane_idx = jnp.arange(capacity, dtype=jnp.int32)
    in_q = lane_idx < count
    o = V3(q_ox, q_oy, q_oz)
    d = V3(q_dx, q_dy, q_dz)
    att = V3(q_ar, q_ag, q_ab)
    rad = V3(q_rr, q_rg, q_rb)
    if key_seed is not None:
        # Host-driven path: queue ids ARE the shard-local ray ids of
        # the queue generator (lane // n = wave sample, lane % n =
        # local pixel), so the per-lane RNG key is pure integer math
        # of q_id — ~20 integer ops instead of an [N] random-row
        # gather.
        # pix_base shifts local pixel -> GLOBAL pixel so a sharded
        # render draws the same (pixel, sample) streams as single-chip.
        seed, sofs, pix_base = key_seed
        n_pix = jnp.uint32(acc.shape[0])
        qid_u = q_id.astype(jnp.uint32)
        sample_seed = _rng.make_key(
            jnp.asarray(seed, jnp.uint32),
            jnp.asarray(sofs, jnp.uint32) + qid_u // n_pix)
        key = _rng.make_key(
            sample_seed,
            jnp.asarray(pix_base, jnp.uint32) + qid_u % n_pix)
    else:
        key = jnp.take(key_lane, q_id, axis=0)

    hit = _trace.intersect_scene(scene, o, d, active=in_q)
    miss = hit.tri < 0

    sky = scene.sky_color
    res_miss = att * (V3(sky[0], sky[1], sky[2]) + rad)

    normal, uv_u, uv_v, mat = _trace.shade_lanes(scene, hit)
    rad_hit = rad + mat.emissive
    d_unit = normalize(d, eps=1e-20)
    cont, new_dir, s_att = mats.scatter(scene, mat, d_unit, normal,
                                        uv_u, uv_v, key, bounce_idx + 2)
    res_absorb = att * rad_hit

    new_att_full = att * s_att
    if rr:
        from sycl_ray_tracer_tpu.models.trace import RR_START, rr_survive
        survive, att_rr = rr_survive(new_att_full, key, bounce_idx + 2)
        apply_rr = (jnp.asarray(bounce_idx, jnp.int32) >= RR_START)
        term_rr = in_q & ~miss & cont & apply_rr & ~survive
        new_att_full = where(apply_rr & survive, att_rr, new_att_full)
    else:
        term_rr = jnp.zeros_like(miss)

    terminated = in_q & (miss | ~cont | term_rr)
    contrib = where(in_q & miss, res_miss, res_absorb)

    alive = in_q & ~miss & cont & ~term_rr
    new_o = o + d * hit.t
    new_att = new_att_full
    sort_key = _coherence_key(scene, new_o, new_dir, hit_tri=hit.tri)

    term_cols = ()
    if deferred_acc and sort_key is not None:
        # 3-way key: survivors (coherence-sorted, top bit clear) <
        # terminated (sorted by pixel) < dead pad. Survivor keys lose
        # one morton LSB to free the top bit.
        pix = (q_id % acc.shape[0]).astype(jnp.uint32)
        sort_key = jnp.where(
            terminated, jnp.uint32(0x80000000) | pix, sort_key >> 1)
        term_cols = (contrib.x, contrib.y, contrib.z)
    else:
        # Pixel = ray id mod accumulator length (ids above it are
        # extra sample waves of the same frame); drop slot = acc
        # length, NOT queue capacity — the queue may be a smaller
        # bucket, and capacity would collide with a real pixel id.
        pix = jnp.where(terminated, q_id % acc.shape[0], acc.shape[0])
        # 3 separate 1-D scatter-adds (one per color channel)
        acc = jnp.stack([
            acc[:, 0].at[pix].add(contrib.x, mode="drop"),
            acc[:, 1].at[pix].add(contrib.y, mode="drop"),
            acc[:, 2].at[pix].add(contrib.z, mode="drop")], axis=1)

    use_deferred = bool(term_cols)
    keep = (alive | terminated) if use_deferred else alive
    q2, new_count = _compact(keep, [
        new_o.x, new_o.y, new_o.z,
        new_dir.x, new_dir.y, new_dir.z,
        new_att.x, new_att.y, new_att.z,
        rad_hit.x, rad_hit.y, rad_hit.z,
        q_id, *term_cols,
    ], capacity, sort_key=sort_key,
        f16_fields=tuple(range(3, 12)) if f16_queue else ())
    term_out = None
    if use_deferred:
        # count only survivors; terminated rows sit in
        # [new_count, count) awaiting the host's segment scatter
        new_count = jnp.sum(alive.astype(jnp.int32))
        term_out = (q2[12], q2[13], q2[14], q2[15])  # q_id, contrib
        q2 = q2[:13]
    # Clamp the tally slot: the host-driven path passes a length-1
    # tally (it counts rays host-side); the traced path passes
    # [max_depth].
    slot = jnp.minimum(jnp.asarray(bounce_idx, jnp.int32),
                       rays.shape[0] - 1)
    rays = rays.at[slot].add(count)
    state = tuple(q2) + (new_count, acc, rays)
    if deferred_acc:
        return state, term_out
    return state


# Queue capacity per chunk (chunks processed sequentially via lax.map
# when a frame exceeds it). Large chunks win: per-traversal-iteration
# cost is dominated by fixed kernel-scheduling overhead, so lanes are
# nearly free until multi-million sizes.
CHUNK = 1 << 20


def accumulate_wavefront(scene, cam: Camera, px, py, lane, *,
                         spp: int, max_depth: int, seed,
                         sample_offset=0, rr: bool = False):
    """Linear-space accumulation (sum over samples) for explicit pixel
    lanes. `lane` is the GLOBAL ray id (uint32) used for RNG keying;
    queue ids index the local accumulator. Returns (accum [R, 3],
    per-bounce ray counts [max_depth] int32)."""
    n = px.shape[0]
    c = min(CHUNK, n)
    # per-bounce tallies are traced int32 (x64 is off); the host-driven
    # render_wavefront sums np.int64 instead and has no such bound
    if c * spp >= (1 << 31):
        raise ValueError(
            f"chunk({c}) * spp({spp}) overflows the int32 per-bounce "
            f"ray tallies; split spp across calls (sample_offset) or "
            f"use render_wavefront's host-driven loop")
    pad = (-n) % c
    n_chunks = (n + pad) // c

    def padded(a, fill=0):
        if pad == 0:
            return a.reshape(n_chunks, c)
        return jnp.concatenate(
            [a, jnp.full((pad,), fill, a.dtype)]).reshape(n_chunks, c)

    px_c = padded(px)
    py_c = padded(py)
    lane_c = padded(lane)
    valid_c = padded(jnp.ones((n,), bool), False)
    local_id = jnp.arange(c, dtype=jnp.int32)

    def render_sample(s, carry):
        combined, rays0 = carry
        sample_seed = _rng.make_key(
            jnp.asarray(seed, jnp.uint32),
            jnp.asarray(s + sample_offset, jnp.uint32))

        def chunk_fn(args):
            cpx, cpy, clane, cvalid = args
            key_lane = _rng.make_key(sample_seed, clane)
            o, d = generate_rays(cam, cpx, cpy, key_lane)
            ones = jnp.ones((c,), jnp.float32)
            zeros = jnp.zeros((c,), jnp.float32)
            acc = jnp.zeros((c, 3), jnp.float32)
            count0 = jnp.sum(cvalid.astype(jnp.int32))
            # dead-pad lanes live at the queue tail; compaction ordering
            # keeps valid rays in the prefix because padding is a suffix
            state = (o.x, o.y, o.z, d.x, d.y, d.z,
                     ones, ones, ones, zeros, zeros, zeros,
                     local_id, count0, acc,
                     jnp.zeros((max_depth,), jnp.int32))

            def cond(cr):
                bounce, st = cr
                return (bounce < max_depth) & (st[13] > 0)

            def body(cr):
                bounce, st = cr
                st = _bounce(scene, key_lane, st, bounce, c, rr=rr)
                return bounce + 1, st

            _, state = jax.lax.while_loop(cond, body, (jnp.int32(0), state))
            return state[14], state[15]

        accs, rayss = jax.lax.map(
            chunk_fn, (px_c, py_c, lane_c, valid_c))
        acc_flat = accs.reshape(n_chunks * c, 3)[:n]
        return combined + acc_flat, rays0 + rayss.sum(axis=0)

    return jax.lax.fori_loop(
        0, spp, render_sample,
        (jnp.zeros((n, 3), jnp.float32), jnp.zeros((max_depth,), jnp.int32)))


@functools.partial(jax.jit, static_argnames=("width", "height", "waves",
                                             "return_keys"))
def _gen_queue(scene, cam: Camera, seed, sample_offset, *, width: int,
               height: int, waves: int = 1, return_keys: bool = True):
    """generate_camera_rays stage (render_wavefront.cpp:79-127).

    `waves` camera samples are batched into ONE queue of waves*W*H
    rays (lane // n = sample index within the batch, lane % n = pixel).
    Batching amortizes the fixed per-bounce cost and gives the
    coherence sort a larger pool.

    return_keys=False drops the [waves*n] uint32 key output (the
    production host loop recomputes keys from q_id, so materializing
    it would hold a dead ~67 MB buffer per 16M-ray wave)."""
    n = width * height
    total = waves * n
    lane = jnp.arange(total, dtype=jnp.uint32)
    pix = lane % jnp.uint32(n)
    px = (pix % jnp.uint32(width)).astype(jnp.int32)
    py = (pix // jnp.uint32(width)).astype(jnp.int32)
    sample_seed = _rng.make_key(
        jnp.asarray(seed, jnp.uint32),
        jnp.asarray(sample_offset, jnp.uint32) + lane // jnp.uint32(n))
    key_lane = _rng.make_key(sample_seed, pix)
    o, d = generate_rays(cam, px, py, key_lane)
    ones = jnp.ones((total,), jnp.float32)
    zeros = jnp.zeros((total,), jnp.float32)
    acc = jnp.zeros((n, 3), jnp.float32)
    state = (o.x, o.y, o.z, d.x, d.y, d.z,
             ones, ones, ones, zeros, zeros, zeros,
             jnp.arange(total, dtype=jnp.int32), jnp.int32(total), acc,
             jnp.zeros((1,), jnp.int32))
    return (key_lane if return_keys else None), state


@functools.partial(jax.jit,
                   static_argnames=("capacity", "rr", "f16_queue"),
                   donate_argnums=(1,))
def _bounce_step(scene, state, key_seed, bounce_idx, *, capacity: int,
                 rr: bool = False,
                 f16_queue: bool = False):
    """shoot_rays stage (render_wavefront.cpp:139-314) as ONE device
    program per bounce. The queue length returns to the host between
    bounces — the same bounce-synchronous structure as the reference's
    shared-USM readback (render_wavefront.cpp:144), except the whole
    queue state stays on device.
    key_seed = (seed, sample_offset) uint32 scalars; per-lane RNG keys
    are recomputed from q_id (see _bounce), not gathered."""
    st = state[:15] + (jnp.zeros((1,), jnp.int32),)
    out, term = _bounce(scene, None, st, bounce_idx, capacity,
                        rr=rr, f16_queue=f16_queue,
                        deferred_acc=True, key_seed=key_seed)
    return out, term


@functools.partial(jax.jit, static_argnames=("seg",),
                   donate_argnums=(0,))
def _scatter_terminated(acc, q_id, cx, cy, cz, start, lo, hi, *,
                        seg: int):
    """Deferred accumulation: scatter-add the [lo, hi) terminated
    segment (rows produced by _bounce's 3-way sort) into the pixel
    accumulator. `seg` is a pow2 bucket >= hi - lo; start is the
    host-clamped slice origin (start + seg <= len)."""
    n = acc.shape[0]
    rows = jnp.arange(seg, dtype=jnp.int32) + start
    ok = (rows >= lo) & (rows < hi)
    qs = jax.lax.dynamic_slice(q_id, (start,), (seg,))
    pix = jnp.where(ok, qs % n, n)
    out = []
    for i, c in enumerate((cx, cy, cz)):
        cs = jax.lax.dynamic_slice(c, (start,), (seg,))
        out.append(acc[:, i].at[pix].add(cs, mode="drop"))
    return jnp.stack(out, axis=1)


def render_wavefront(scene, cam: Camera, *, width: int, height: int,
                     spp: int, max_depth: int, seed: int = 0,
                     rr: bool = False) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Returns (image [H, W, 3] float32 gamma-encoded,
    per-bounce ray counts [max_depth] int32).

    Sample AND bounce loops are host-driven: one compiled device
    program per bounce (bounce-synchronous like the reference), with
    the queue resident on device. Host sees one scalar (the live-ray
    count) per bounce, mirroring render_wavefront.cpp:144.
    """
    import os
    import time as _time

    # SRT_PROFILE=1 re-enables the per-phase wall clock the reference
    # keeps dormant (print_elapsed, render_wavefront.cpp:129-137).
    profile = os.environ.get("SRT_PROFILE") == "1"

    n = width * height

    # Batch samples into waves: ONE wave when the frame fits 68M rays
    # (~4.3 GB of queue at f32), else 64M-ray waves run one at a time.
    # Bigger sorted pools give the coherence sort more rays to group.
    # SRT_WAVE_RAYS overrides; the sizes are to be re-swept on the GPU.
    wave_rays = int(os.environ.get(
        "SRT_WAVE_RAYS",
        str(spp * n if spp * n <= (68 << 20) else 64 << 20)))
    waves = max(1, min(spp, wave_rays // n))
    big_wave_serial = (wave_rays >= (56 << 20)
                       and "SRT_WAVE_THREADS" not in os.environ)
    # Half-precision queue payload (dir/att/radiance), the reference's
    # fp16 RayData quirk (camera.hpp:12-63). Off by default.
    f16_queue = os.environ.get("SRT_F16_QUEUE") == "1"

    def run_wave(s: int, w: int):
        """One wave (w camera samples batched into a w*n-ray queue):
        returns (accumulator [n,3], per-bounce ray tallies int64)."""
        rays_w = np.zeros((max_depth,), np.int64)
        cap = w * n
        _, state = _gen_queue(scene, cam, seed, s, width=width,
                              height=height, waves=w, return_keys=False)
        key_seed = (jnp.asarray(seed, jnp.uint32),
                    jnp.asarray(s, jnp.uint32), jnp.uint32(0))
        count = cap
        for bounce in range(max_depth):
            if count == 0:
                break
            rays_w[bounce] += count
            t0 = _time.perf_counter() if profile else 0.0
            b = bucket_of(count, cap)
            if state[0].shape[0] != b:
                state = shrink_queue(state[:13], b=b) + state[13:]
            state, term = _bounce_step(scene, state, key_seed, bounce,
                                       capacity=b, rr=rr,
                                       f16_queue=f16_queue)
            new_count = int(state[13])
            if term is not None:
                n_term = count - new_count
                if n_term > 0:
                    seg = 1 << max(int(n_term - 1).bit_length(), 14)
                    seg = min(seg, b)
                    start = min(new_count, b - seg)
                    acc2 = _scatter_terminated(
                        state[14], term[0], term[1], term[2], term[3],
                        start, new_count, count, seg=seg)
                    state = state[:14] + (acc2,) + state[15:]
            count = new_count
            if profile:
                print(f"[profile] wave@{s}x{w} bounce {bounce}: "
                      f"{(_time.perf_counter() - t0) * 1e3:.1f} ms, "
                      f"bucket {b}, queue -> {count}")
        return state[14], rays_w

    specs = []
    s = 0
    while s < spp:
        w = min(waves, spp - s)
        specs.append((s, w))
        s += w

    # See interleave_waves: profile mode runs serial so per-bounce
    # wall clocks aren't polluted by the concurrent wave; so do
    # >=56M-ray fallback waves (two in flight double the queue memory).
    results = interleave_waves(run_wave, specs,
                               serial=profile or big_wave_serial)

    combined = None
    rays = np.zeros((max_depth,), np.int64)
    for acc, rays_w in results:
        combined = acc if combined is None else combined + acc
        rays += rays_w
    img = linear_to_gamma(combined * (1.0 / spp))
    return (img.reshape(height, width, 3),
            jnp.asarray(np.minimum(rays, 2**31 - 1).astype(np.int32)))
