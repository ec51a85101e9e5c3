"""Multi-device rendering over a 2-D device mesh.

The reference is strictly single-device (SURVEY.md section 2.2: no
NCCL/MPI, one SYCL queue). This module is the scaling story:

- axis "dp" shards the SAMPLE axis: each device integrates an spp/dp
  slice of the Monte-Carlo estimator with decorrelated RNG streams
  (sample_offset feeds the counter-based keys), and the linear
  accumulators are summed once per frame. merge_samples
  (render_wavefront.cpp:319-358) becomes literally one collective.
- axis "sp" shards the PIXEL axis: each device owns a contiguous slice
  of the flat pixel space (its own queue, its own accumulator block);
  the image is reassembled by the output sharding, no gather needed.

The scene pytree (BVH + shading tables + textures) is replicated into
every device's memory (`replicate`) -- paths are embarrassingly
parallel after that, so no per-bounce communication exists at all.
The mesh is a plain reshape of the device list: on a host whose cards
are joined all to all (NVLink) every device pair is equally close.
"""

from __future__ import annotations

import functools
import os
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sycl_ray_tracer_tpu.models.camera import Camera, generate_rays
from sycl_ray_tracer_tpu.models.megakernel import accumulate_megakernel
from sycl_ray_tracer_tpu.models.wavefront import SORT_MODE, _bounce
from sycl_ray_tracer_tpu.ops.vec import linear_to_gamma


def make_mesh(dp: Optional[int] = None, sp: int = 1,
              devices=None) -> Mesh:
    """Mesh over available devices; defaults to all of them on "dp"."""
    devices = devices if devices is not None else jax.devices()
    if dp is None:
        dp = len(devices) // sp
    dev = np.asarray(devices[: dp * sp]).reshape(dp, sp)
    return Mesh(dev, axis_names=("dp", "sp"))


def replicate(scene, mesh: Mesh):
    """The scene pytree placed whole on every device of the mesh (a
    no-op for a scene that is already there)."""
    return jax.device_put(scene, NamedSharding(mesh, P()))


@functools.lru_cache(maxsize=16)
def _wavefront_programs(mesh: Mesh, width: int, height: int, spp: int,
                        rr: bool, f16_queue: bool):
    """The sharded wavefront's jitted programs for one configuration,
    built once per process: jit keeps compiled code per function
    object, so programs defined anew inside every render would compile
    again on every render. Returns (gen, step, scatter_term, finish)."""
    dp = mesh.shape["dp"]
    sp = mesh.shape["sp"]
    n = width * height
    n_local = n // sp
    spp_local = spp // dp
    spec_q = P("dp", "sp", None)
    spec_c = P("dp", "sp")
    spec_a = P("dp", "sp", None, None)

    @functools.partial(jax.jit, static_argnames=("w",))
    def gen(scene, cam, seed_u, s_local, *, w: int):
        cap = w * n_local

        def fn(scene, cam, seed_u):
            dpi = jax.lax.axis_index("dp")
            spi = jax.lax.axis_index("sp")
            from sycl_ray_tracer_tpu.ops import rng as _rng

            lane = jnp.arange(cap, dtype=jnp.uint32)
            pix_g = (jnp.uint32(spi) * jnp.uint32(n_local)
                     + lane % jnp.uint32(n_local))
            px = (pix_g % jnp.uint32(width)).astype(jnp.int32)
            py = (pix_g // jnp.uint32(width)).astype(jnp.int32)
            sofs = (jnp.asarray(s_local, jnp.uint32)
                    + jnp.uint32(dpi) * jnp.uint32(spp_local))
            sample_seed = _rng.make_key(
                seed_u, sofs + lane // jnp.uint32(n_local))
            key = _rng.make_key(sample_seed, pix_g)
            o, d = generate_rays(cam, px, py, key)
            ones = jnp.ones((cap,), jnp.float32)
            zeros = jnp.zeros((cap,), jnp.float32)
            cols = (o.x, o.y, o.z, d.x, d.y, d.z,
                    ones, ones, ones, zeros, zeros, zeros,
                    jnp.arange(cap, dtype=jnp.int32))
            acc = jnp.zeros((n_local, 3), jnp.float32)
            cnt = jnp.full((1, 1), cap, jnp.int32)
            return (tuple(c.reshape(1, 1, cap) for c in cols)
                    + (cnt, acc.reshape(1, 1, n_local, 3)))

        return jax.shard_map(
            fn, mesh=mesh, in_specs=(P(), P(), P()),
            out_specs=tuple([spec_q] * 13) + (spec_c, spec_a),
            check_vma=False)(scene, cam, seed_u)

    @functools.partial(jax.jit,
                       static_argnames=("capacity",),
                       donate_argnums=(1,))
    def step(scene, state, seed_u, s_local, bounce_idx, *,
             capacity: int):
        """One bounce for every shard, deferred accumulation included
        (the same _bounce(deferred_acc=True) branch the single-chip
        host loop runs, so the sharded path and the fast path stay
        converged). Terminated rows ride each shard's
        compaction argsort into [new_count, count); the host slices
        them with scatter_term below."""
        def fn(scene, seed_u, *st):
            dpi = jax.lax.axis_index("dp")
            spi = jax.lax.axis_index("sp")
            cols = [c.reshape(capacity) for c in st[:13]]
            cnt = st[13].reshape(())
            acc = st[14].reshape(n_local, 3)
            key_seed = (seed_u,
                        jnp.asarray(s_local, jnp.uint32)
                        + jnp.uint32(dpi) * jnp.uint32(spp_local),
                        jnp.uint32(spi) * jnp.uint32(n_local))
            carry = tuple(cols) + (cnt, acc,
                                   jnp.zeros((1,), jnp.int32))
            out, term = _bounce(scene, None, carry, bounce_idx,
                                capacity, rr=rr,
                                f16_queue=f16_queue, deferred_acc=True,
                                key_seed=key_seed)
            new_cols = out[:13]
            new_cnt = out[13]
            new_acc = out[14]
            term = term if term is not None else ()
            return (tuple(c.reshape(1, 1, capacity) for c in new_cols)
                    + (new_cnt.reshape(1, 1).astype(jnp.int32),
                       new_acc.reshape(1, 1, n_local, 3))
                    + tuple(c.reshape(1, 1, capacity) for c in term))

        n_out = 15 + (4 if SORT_MODE != "none" else 0)
        out = jax.shard_map(
            fn, mesh=mesh,
            in_specs=(P(), P()) + tuple([spec_q] * 13) + (spec_c, spec_a),
            out_specs=(tuple([spec_q] * 13) + (spec_c, spec_a)
                       + tuple([spec_q] * (n_out - 15))),
            check_vma=False)(scene, seed_u, *state)
        return out[:15], (out[15:] if n_out > 15 else None)

    @functools.partial(jax.jit, static_argnames=("seg",),
                       donate_argnums=(0,))
    def scatter_term(acc, q_id, cx, cy, cz, start, lo, hi, *, seg: int):
        """Per-shard analog of wavefront._scatter_terminated: scatter-
        add each shard's [lo, hi) terminated segment into its LOCAL
        accumulator (scatter never crosses devices). start/lo/hi arrive as
        (dp, sp) host-computed arrays — per-shard dynamic bounds with
        one shared static seg so every shard compiles one shape."""
        def fn(acc, q_id, cx, cy, cz, start, lo, hi):
            a = acc.reshape(n_local, 3)
            qs = q_id.reshape(q_id.shape[-1])
            st = start.reshape(())
            rows = jnp.arange(seg, dtype=jnp.int32) + st
            ok = (rows >= lo.reshape(())) & (rows < hi.reshape(()))
            qseg = jax.lax.dynamic_slice(qs, (st,), (seg,))
            pix = jnp.where(ok, qseg % n_local, n_local)
            out = []
            for i, c in enumerate((cx, cy, cz)):
                cs = jax.lax.dynamic_slice(
                    c.reshape(c.shape[-1]), (st,), (seg,))
                out.append(a[:, i].at[pix].add(cs, mode="drop"))
            return jnp.stack(out, axis=1).reshape(1, 1, n_local, 3)

        return jax.shard_map(
            fn, mesh=mesh,
            in_specs=(spec_a,) + tuple([spec_q] * 4) + (spec_c,) * 3,
            out_specs=spec_a,
            check_vma=False)(acc, q_id, cx, cy, cz, start, lo, hi)

    @jax.jit
    def finish(acc):
        # sum over the dp (sample) axis — the merge_samples collective
        # (render_wavefront.cpp:319-358); sp-major concatenation IS
        # global pixel order (pix_g = spi * n_local + local)
        a = acc.sum(axis=0).reshape(n, 3)
        img = linear_to_gamma(a * (1.0 / spp))
        return img.reshape(height, width, 3)

    return gen, step, scatter_term, finish


def _render_sharded_wavefront_hostloop(
        scene, cam: Camera, *, width: int, height: int, spp: int,
        max_depth: int, seed: int, mesh: Mesh,
        rr: bool) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Host-driven sharded wavefront: the FAST single-chip pipeline
    (bounce-synchronous host loop, live-count buckets, donated
    buffers, key-from-id RNG)
    run per shard under shard_map.

    Structure per bounce: ONE jitted shard_map program advances every
    shard's queue; the host reads back only the per-shard live counts
    (the same one-scalar-per-bounce sync as single-chip,
    render_wavefront.cpp:144) and picks the next GLOBAL bucket from
    their max, so every shard compiles the same shapes. Terminated
    lanes scatter-add inside the shard (shard-local accumulator —
    scatter never crosses devices); the only collective is the final
    psum-style sum over "dp" when the linear accumulators merge.

    Estimator parity: each (global pixel, absolute sample) draws the
    same key stream as single-chip (key = f(seed, abs sample, global
    pixel)); dp shards sample slices, sp shards pixel slices.
    """
    dp = mesh.shape["dp"]
    sp = mesh.shape["sp"]
    n = width * height
    n_local = n // sp
    spp_local = spp // dp
    # Adaptive wave sizing like the single-chip loop (one wave when the
    # shard-local frame fits ~68M rays, else 48M waves), applied to
    # the per-shard ray count.
    total_local = spp_local * n_local
    wave_rays = int(os.environ.get(
        "SRT_WAVE_RAYS",
        str(total_local if total_local <= (68 << 20) else 48 << 20)))
    waves = max(1, min(spp_local, wave_rays // n_local))
    f16_queue = os.environ.get("SRT_F16_QUEUE") == "1"
    seed_u = jnp.uint32(seed)
    gen, step, scatter_term, finish = _wavefront_programs(
        mesh, width, height, spp, rr, f16_queue)
    def bucket_of(c, cap):
        from sycl_ray_tracer_tpu.models.wavefront import (
            bucket_of as _bucket_of)
        return _bucket_of(c, cap, floor_bits=14)

    def run_wave(s: int, w: int):
        """One wave of w local samples across every shard: returns
        (accumulator [dp, sp, n_local, 3], per-bounce tallies)."""
        rays_w = np.zeros((max_depth,), np.int64)
        cap = w * n_local
        state = gen(scene, cam, seed_u, jnp.uint32(s), w=w)
        count_max = cap
        counts_sum = cap * dp * sp
        counts = np.full((dp, sp), cap, np.int64)
        for bounce in range(max_depth):
            if count_max == 0:
                break
            rays_w[bounce] += counts_sum
            b = bucket_of(count_max, cap)
            if state[0].shape[-1] != b:
                state = tuple(a[:, :, :b] for a in state[:13]) \
                    + state[13:]
            state, term = step(scene, state, seed_u, jnp.uint32(s),
                               jnp.int32(bounce), capacity=b)
            new_counts = np.asarray(state[13]).astype(np.int64)
            if term is not None:
                # each shard's terminated rows sit in
                # [new_count, prev_count) of its sorted queue; one
                # static pow2 segment covers the largest shard's
                n_term = np.minimum(counts, b) - new_counts
                if n_term.max() > 0:
                    seg = 1 << max(int(n_term.max() - 1).bit_length(),
                                   12)
                    seg = min(seg, b)
                    start = np.minimum(new_counts, b - seg) \
                        .astype(np.int32)
                    acc2 = scatter_term(
                        state[14], term[0], term[1], term[2], term[3],
                        jnp.asarray(start),
                        jnp.asarray(new_counts.astype(np.int32)),
                        jnp.asarray(np.minimum(counts, b)
                                    .astype(np.int32)),
                        seg=seg)
                    state = state[:14] + (acc2,)
            counts = new_counts
            count_max = int(counts.max())
            counts_sum = int(counts.sum())
        return state[14], rays_w

    specs = []
    s = 0
    while s < spp_local:
        w = min(waves, spp_local - s)
        specs.append((s, w))
        s += w

    # Same wave interleave as the single-chip loops (see
    # wavefront.interleave_waves for the rationale and the
    # bit-identity argument); sharing the helper keeps the sharded
    # host loop structurally converged with the fast path.
    from sycl_ray_tracer_tpu.models.wavefront import interleave_waves
    results = interleave_waves(run_wave, specs)

    rays = np.zeros((max_depth,), np.int64)
    combined = None
    for acc, rays_w in results:
        combined = acc if combined is None else combined + acc
        rays += rays_w

    img = finish(combined)
    return img, jnp.asarray(np.minimum(rays, 2**31 - 1).astype(np.int32))


@functools.lru_cache(maxsize=16)
def _megakernel_programs(mesh: Mesh, width: int, height: int, spp: int,
                         max_depth: int, rr: bool, sort_every: int):
    """The sharded chunked megakernel's jitted programs for one
    configuration, built once per process (see _wavefront_programs).
    Returns (mk_first, mk_next, shrink, finish)."""
    from sycl_ray_tracer_tpu.models.megakernel import (
        _chunk_first_body, _chunk_next_body)

    dp = mesh.shape["dp"]
    sp = mesh.shape["sp"]
    n = width * height
    n_local = n // sp
    spp_local = spp // dp
    spec_q = P("dp", "sp", None)
    spec_c = P("dp", "sp")
    # queue layout (megakernel._q_of): 15 f32 + orig int32 + done bool

    @functools.partial(jax.jit, static_argnames=("w", "final"))
    def mk_first(scene, cam, seed_u, s_local, i_hi, *, w: int,
                 final: bool):
        cap = w * n_local

        def fn(scene, cam, seed_u):
            dpi = jax.lax.axis_index("dp")
            spi = jax.lax.axis_index("sp")
            s_abs = (jnp.asarray(s_local, jnp.uint32)
                     + jnp.uint32(dpi) * jnp.uint32(spp_local))
            pix0 = jnp.uint32(spi) * jnp.uint32(n_local)
            q, res, rays, key0, live = _chunk_first_body(
                scene, cam, seed_u, s_abs, pix0, i_hi,
                n_local=n_local, width=width, max_depth=max_depth,
                waves=w, rr=rr, sort_every=sort_every, final=final)
            cols = tuple(q) + tuple(res) + (key0,)
            return (tuple(c.reshape(1, 1, cap) for c in cols)
                    + (rays.reshape(1, 1, max_depth),
                       live.reshape(1, 1)))

        return jax.shard_map(
            fn, mesh=mesh, in_specs=(P(), P(), P()),
            out_specs=tuple([spec_q] * 21) + (spec_q, spec_c),
            check_vma=False)(scene, cam, seed_u)

    @functools.partial(jax.jit,
                       static_argnames=("capacity", "final"),
                       donate_argnums=(1,))
    def mk_next(scene, state, i_lo, i_hi, *, capacity: int,
                final: bool):
        """One k-bounce chunk for every shard. `state` is the 23-tuple
        (17 queue cols, 3 result slots, key0, rays, live); queue/
        result widths arrive pre-sliced to `capacity`, result slots
        and key0 stay at full wave width."""
        def fn(scene, *st):
            q = [c.reshape(capacity) for c in st[:17]]
            full = st[17].shape[-1]
            res = tuple(c.reshape(full) for c in st[17:20])
            key0 = st[20].reshape(full)
            rays = st[21].reshape(max_depth)
            q, res, rays, live = _chunk_next_body(
                scene, q, res, rays, key0, i_lo, i_hi, rr=rr,
                sort_every=sort_every, final=final)
            return (tuple(c.reshape(1, 1, capacity) for c in q)
                    + tuple(c.reshape(1, 1, full) for c in res)
                    + (key0.reshape(1, 1, full),
                       rays.reshape(1, 1, max_depth),
                       live.reshape(1, 1)))

        return jax.shard_map(
            fn, mesh=mesh,
            in_specs=(P(),) + tuple([spec_q] * 22) + (spec_c,),
            out_specs=tuple([spec_q] * 22) + (spec_c,),
            check_vma=False)(scene, *state)

    @functools.partial(jax.jit, static_argnames=("b",))
    def shrink(q17, *, b: int):
        # one fused slice program per shape transition (the sharded
        # analog of wavefront.shrink_queue)
        return tuple(a[:, :, :b] for a in q17)

    @jax.jit
    def finish(acc):
        a = acc.sum(axis=0).reshape(n, 3)
        img = linear_to_gamma(a * (1.0 / spp))
        return img.reshape(height, width, 3)

    return mk_first, mk_next, shrink, finish


def _render_sharded_megakernel_hostloop(
        scene, cam: Camera, *, width: int, height: int, spp: int,
        max_depth: int, seed: int, mesh: Mesh, rr: bool,
        chunk: int, sort_every: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Host-driven sharded megakernel: the FAST single-chip engine
    (bounce-chunked + in-program coherence re-sort, _chunked_wave) run
    per shard under shard_map, so the sharded and single-device
    engines cannot diverge.

    Structure per chunk: ONE jitted shard_map program runs k fused
    bounce iterations on every shard's queue; the host reads back only
    per-shard live counts and picks the next GLOBAL bucket from their
    max, so every shard compiles the same shapes (the same protocol as
    the sharded wavefront loop above). dp shards samples, sp shards
    pixels; per-lane keys depend only on (seed, absolute sample,
    global pixel), so the sharded estimator equals single-chip.
    """
    from sycl_ray_tracer_tpu.models.wavefront import (
        bucket_of as _bucket_of, interleave_waves)

    dp = mesh.shape["dp"]
    sp = mesh.shape["sp"]
    n = width * height
    n_local = n // sp
    spp_local = spp // dp
    wave_rays = int(os.environ.get("SRT_WAVE_RAYS", str(8 << 20)))
    waves = max(1, min(spp_local, wave_rays // n_local))
    seed_u = jnp.uint32(seed)
    mk_first, mk_next, shrink, finish = _megakernel_programs(
        mesh, width, height, spp, max_depth, rr, sort_every)

    def run_wave(s: int, w: int):
        cap = w * n_local
        i_hi0 = min(chunk, max_depth)
        state = mk_first(scene, cam, seed_u, jnp.uint32(s),
                         jnp.int32(i_hi0), w=w, final=(i_hi0 >= max_depth))
        count_max = int(np.asarray(state[22]).max())
        i0 = chunk
        while i0 < max_depth and count_max > 0:
            b = _bucket_of(count_max, cap, floor_bits=14)
            if state[0].shape[-1] != b:
                state = shrink(state[:17], b=b) + state[17:]
            i_hi = min(i0 + chunk, max_depth)
            state = mk_next(scene, state, jnp.int32(i0),
                            jnp.int32(i_hi), capacity=b,
                            final=(i_hi >= max_depth))
            count_max = int(np.asarray(state[22]).max())
            i0 = i_hi
        # per-shard linear accumulator [dp, sp, n_local, 3] (the
        # result slots sum over the wave's local samples) + tallies
        acc = jnp.stack(state[17:20], axis=-1) \
            .reshape(dp, sp, w, n_local, 3).sum(axis=2)
        return acc, state[21]

    specs = []
    s = 0
    while s < spp_local:
        w = min(waves, spp_local - s)
        specs.append((s, w))
        s += w
    results = interleave_waves(run_wave, specs)

    combined = None
    rays = None
    for acc, rays_w in results:
        combined = acc if combined is None else combined + acc
        # host-side int64 tally accumulation + clamp, matching
        # _render_sharded_wavefront_hostloop (round-4 advisor: int32
        # sums across waves/shards can wrap on very large renders)
        r = np.asarray(rays_w).astype(np.int64)
        rays = r if rays is None else rays + r

    tallies = np.minimum(rays.sum(axis=(0, 1)),
                         2**31 - 1).astype(np.int32)
    return finish(combined), jnp.asarray(tallies)


@functools.lru_cache(maxsize=16)
def _megakernel_traced_program(mesh: Mesh, width: int, height: int,
                               spp: int, max_depth: int, rr: bool):
    """The traced (unchunked) sharded megakernel for one configuration,
    built once per process (see _wavefront_programs)."""
    spp_local = spp // mesh.shape["dp"]

    def shard_fn(scene, cam, lane, seed):
        dpi = jax.lax.axis_index("dp")
        px = (lane % jnp.uint32(width)).astype(jnp.int32)
        py = (lane // jnp.uint32(width)).astype(jnp.int32)
        accum, rays = accumulate_megakernel(
            scene, cam, px, py, lane,
            spp=spp_local, max_depth=max_depth, seed=seed,
            sample_offset=dpi * spp_local, rr=rr)
        accum = jax.lax.psum(accum, "dp")
        rays = jax.lax.psum(rays, ("dp", "sp"))
        return accum, rays

    # check_vma=False: the queue/accumulator carries are materialized
    # inside the shard, so their varying-axis types can't be inferred.
    mapped = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), P("sp"), P()),
        out_specs=(P("sp"), P()),
        check_vma=False,
    )

    @jax.jit
    def run(scene, cam, lane, seed):
        accum, rays = mapped(scene, cam, lane, seed)
        img = linear_to_gamma(accum * (1.0 / spp))
        return img.reshape(height, width, 3), rays

    return run


def render_sharded(scene, cam: Camera, *, width: int, height: int,
                   spp: int, max_depth: int, seed: int = 0,
                   mesh: Optional[Mesh] = None,
                   renderer: str = "wavefront",
                   rr: bool = False) -> Tuple[jnp.ndarray,
                                              jnp.ndarray]:
    """Sharded render. Returns (image [H, W, 3] gamma-encoded,
    per-bounce ray counts [max_depth] int32, summed over all shards).

    Wavefront renders through the host-driven fast path
    (_render_sharded_wavefront_hostloop); megakernel through the
    host-driven chunked fast path whenever the single-chip driver
    would chunk (mk_cadence), else the traced shard_map core
    (accumulate_megakernel)."""
    if mesh is None:
        mesh = make_mesh()
    scene = replicate(scene, mesh)
    dp = mesh.shape["dp"]
    sp = mesh.shape["sp"]
    n = width * height
    if spp % dp:
        raise ValueError(f"spp={spp} must divide by dp={dp}")
    if n % sp:
        raise ValueError(f"pixels={n} must divide by sp={sp}")
    if renderer == "wavefront":
        return _render_sharded_wavefront_hostloop(
            scene, cam, width=width, height=height, spp=spp,
            max_depth=max_depth, seed=seed, mesh=mesh, rr=rr)
    if renderer != "megakernel":
        raise ValueError(f"unknown renderer {renderer!r}")
    from sycl_ray_tracer_tpu.models.megakernel import mk_cadence
    chunk, sort_every = mk_cadence()
    if chunk > 0 and max_depth >= 1:
        return _render_sharded_megakernel_hostloop(
            scene, cam, width=width, height=height, spp=spp,
            max_depth=max_depth, seed=seed, mesh=mesh, rr=rr,
            chunk=chunk, sort_every=sort_every)
    run = _megakernel_traced_program(mesh, width, height, spp, max_depth,
                                     rr)
    return run(scene, cam, jnp.arange(n, dtype=jnp.uint32),
               jnp.uint32(seed))
