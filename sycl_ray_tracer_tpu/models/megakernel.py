"""Megakernel renderer: one fused jitted program for the whole frame.

Parity target: render_megakernel.cpp:20-63, 75-187. The reference runs
an 8x8-workgroup SYCL kernel with per-thread sample and bounce loops;
here it is one traced program over all pixels at once —
XLA fuses camera gen, traversal step, and shading into large vector
ops, and the sample loop is a lax.fori_loop carrying the accumulator.

Paths that exhaust max_depth contribute black, exactly like the
reference (render_pixel returns float3(0) at loop end).

Ray counting matches the reference (render_megakernel.cpp:31-33): the
counter increments at the top of every bounce iteration a path is still
alive for; totals are per-bounce int32 tallies summed on the host.

`accumulate_megakernel` is the unjitted linear-space core shared with
the multi-chip path (parallel/mesh.py): it takes explicit pixel/lane
arrays so a device mesh can shard pixels and samples independently and
psum the linear accumulator before gamma encoding.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from sycl_ray_tracer_tpu.models import trace as _trace
from sycl_ray_tracer_tpu.models.camera import Camera, generate_rays
from sycl_ray_tracer_tpu.models.trace import PathState
from sycl_ray_tracer_tpu.ops import rng as _rng
from sycl_ray_tracer_tpu.ops.vec import V3, linear_to_gamma, splat


def _resort(scene, st: PathState, key0, orig, force: bool = False):
    """Coherence re-sort of a megakernel path state: live lanes sorted
    by the wavefront's coherence key, dead lanes to the tail. A pure
    permutation — every lane keeps its RNG stream (key re-gathered from
    the never-permuted key0 by the riding `orig` id) and its arithmetic,
    so images are bit-identical to the unsorted engine.

    `force=True` guarantees a live-first permutation even when the
    coherence key is disabled (SRT_SORT_KEY=none): the bounce-chunked
    driver needs dead lanes at the tail before it can shrink the queue,
    so it falls back to a stable argsort on the done flag. The payload
    must NOT go through _compact's sort_key=None path there — that one
    zero-fills dead rows, and a zeroed (orig, result) pair would later
    scatter 0 into pixel-slot 0.
    """
    from sycl_ray_tracer_tpu.models.wavefront import (_compact,
                                                      _coherence_key)
    sk = _coherence_key(scene, st.o, st.d)
    if sk is None:
        if not force:
            return st, jnp.take(key0, orig, axis=0), orig
        sk = jnp.zeros_like(orig, dtype=jnp.uint32)
    cols, _ = _compact(~st.done, [
        st.o.x, st.o.y, st.o.z, st.d.x, st.d.y, st.d.z,
        st.att.x, st.att.y, st.att.z,
        st.rad.x, st.rad.y, st.rad.z,
        st.result.x, st.result.y, st.result.z,
        orig, st.done.astype(jnp.int32)], orig.shape[0], sort_key=sk)
    st = PathState(
        o=V3(cols[0], cols[1], cols[2]),
        d=V3(cols[3], cols[4], cols[5]),
        att=V3(cols[6], cols[7], cols[8]),
        rad=V3(cols[9], cols[10], cols[11]),
        result=V3(cols[12], cols[13], cols[14]),
        done=cols[16] != 0)
    return st, jnp.take(key0, cols[15], axis=0), cols[15]


def _sample_one(scene, cam: Camera, px, py, lane, sample_idx, seed,
                max_depth: int, rays, active=None, rr: bool = False,
                sort_every: int = 0):
    """Render one sample for every listed pixel; returns (color V3,
    updated per-bounce ray tallies).

    Bounce 0 runs before the while_loop. With sort_every=k > 0, live
    lanes are coherence-re-sorted (and dead lanes pushed to the tail)
    every k bounces: the megakernel analog of wavefront compaction. A
    permutation never changes any lane's RNG stream or arithmetic
    (key/orig ride along; results scatter back by orig), so images are
    bit-identical to the unsorted megakernel.
    """
    key = _rng.make_key(
        _rng.make_key(jnp.asarray(seed, jnp.uint32),
                      jnp.asarray(sample_idx, jnp.uint32)), lane)
    o, d = generate_rays(cam, px, py, key)
    r = px.shape[0]
    done0 = jnp.zeros((r,), bool) if active is None else ~active
    state = PathState(
        o=o, d=d,
        att=splat((1.0, 1.0, 1.0), (r,)),
        rad=splat((0.0, 0.0, 0.0), (r,)),
        result=splat((0.0, 0.0, 0.0), (r,)),
        done=done0,
    )
    orig = jnp.arange(r, dtype=jnp.int32)

    # ---- bounce 0 ----
    if max_depth >= 1:
        rays = rays.at[0].add(jnp.sum((~state.done).astype(jnp.int32)))
        state = _trace.trace_step(scene, state, key, 2,  # ctr 0,1=jitter
                                  rr=rr, bounce_idx=0)

    # Never-permuted key array: resort re-gathers each lane's key from
    # it by orig as a plain uint32 take. The key does not ride
    # _compact's packed take, which bitcasts int columns to f32: a
    # uniform uint32 key can be a NaN pattern, which a float copy may
    # canonicalize. Small ints (orig, done) are denormal or low normal
    # patterns, which data movement preserves.
    key0 = key

    def resort(st, key, orig):
        return _resort(scene, st, key0, orig)

    def cond(carry):
        i, st, _, _, _ = carry
        return (i < max_depth) & jnp.any(~st.done)

    def body(carry):
        i, st, rays, key, orig = carry
        if sort_every:
            st, key, orig = jax.lax.cond(
                (i - 1) % sort_every == 0,
                resort, lambda s, k, g: (s, k, g), st, key, orig)
        rays = rays.at[i].add(jnp.sum((~st.done).astype(jnp.int32)))
        st = _trace.trace_step(scene, st, key, i + 2,
                               rr=rr, bounce_idx=i)
        return (i + 1, st, rays, key, orig)

    # max_depth=0: the loop body can't even TRACE (rays.at[i] on a
    # size-0 tally array), and nothing would run — return the initial
    # black state, matching the reference's never-entered bounce loop.
    if max_depth < 1:
        return state.result, rays
    _, state, rays, key, orig = jax.lax.while_loop(
        cond, body, (jnp.int32(1), state, rays, key, orig))
    if sort_every:
        # undo the coherence permutation: results return to pixel order
        res = V3(*(jnp.zeros((r,), jnp.float32).at[orig].set(c)
                   for c in (state.result.x, state.result.y,
                             state.result.z)))
        return res, rays
    return state.result, rays


# Pixel-chunk size (chunks run sequentially via lax.map past this).
CHUNK = 1 << 20


def accumulate_megakernel(scene, cam: Camera, px, py, lane, *,
                          spp: int, max_depth: int, seed,
                          sample_offset=0, rr: bool = False,
                          sort_every: int = 0):
    """Linear-space accumulation over `spp` samples for the given pixel
    lanes. Returns (accum [R, 3] float32 — the SUM over samples, not the
    mean — and per-bounce ray counts [max_depth] int32)."""
    n = px.shape[0]
    c = min(CHUNK, n)
    pad = (-n) % c
    n_chunks = (n + pad) // c

    def padded(a, fill=0):
        if pad == 0:
            return a.reshape(n_chunks, c)
        return jnp.concatenate(
            [a, jnp.full((pad,), fill, a.dtype)]).reshape(n_chunks, c)

    px_c, py_c, lane_c = padded(px), padded(py), padded(lane)
    valid_c = padded(jnp.ones((n,), bool), False)

    def chunk_fn(args):
        cpx, cpy, clane, cvalid = args

        def sample_body(s, carry):
            (ax, ay, az), rays = carry
            color, rays = _sample_one(
                scene, cam, cpx, cpy, clane, s + sample_offset, seed,
                max_depth, rays, active=cvalid, rr=rr,
                sort_every=sort_every)
            return (ax + color.x, ay + color.y, az + color.z), rays

        zero = jnp.zeros((c,), jnp.float32)
        (ax, ay, az), rays = jax.lax.fori_loop(
            0, spp, sample_body,
            ((zero, zero, zero), jnp.zeros((max_depth,), jnp.int32)))
        return jnp.stack([ax, ay, az], axis=-1), rays

    accs, rayss = jax.lax.map(chunk_fn, (px_c, py_c, lane_c, valid_c))
    return accs.reshape(n_chunks * c, 3)[:n], rayss.sum(axis=0)


@functools.partial(jax.jit, static_argnames=("width", "height",
                                             "max_depth", "waves", "rr",
                                             "sort_every"))
def _wave_frame(scene, cam: Camera, seed, sample_offset, *, width: int,
                height: int, max_depth: int, waves: int = 1,
                rr: bool = False, sort_every: int = 0):
    """`waves` camera samples of the full frame in ONE device program
    (lane // n = sample within the batch, lane % n = pixel — the same
    global ray-id scheme as wavefront._gen_queue). Per-lane RNG keys
    depend only on (seed, absolute sample index, pixel), so any wave
    partition of spp produces bit-identical samples; the wave's results
    reduce over the sample axis before returning. Batching amortizes
    the fixed per-bounce program overhead."""
    n = width * height
    lane = jnp.arange(waves * n, dtype=jnp.uint32)
    pix = lane % jnp.uint32(n)  # linear ray id, camera.hpp:120-122
    px = (pix % jnp.uint32(width)).astype(jnp.int32)
    py = (pix // jnp.uint32(width)).astype(jnp.int32)
    sample_idx = (jnp.asarray(sample_offset, jnp.uint32)
                  + lane // jnp.uint32(n))
    rays0 = jnp.zeros((max_depth,), jnp.int32)
    color, rays = _sample_one(scene, cam, px, py, pix, sample_idx,
                              seed, max_depth, rays0, rr=rr,
                              sort_every=sort_every)
    acc = jnp.stack([color.x, color.y, color.z], axis=-1)
    return acc.reshape(waves, n, 3).sum(axis=0), rays


def _q_of(st: PathState, orig):
    return (st.o.x, st.o.y, st.o.z, st.d.x, st.d.y, st.d.z,
            st.att.x, st.att.y, st.att.z, st.rad.x, st.rad.y, st.rad.z,
            st.result.x, st.result.y, st.result.z, orig, st.done)


def _st_of(q):
    return PathState(
        o=V3(q[0], q[1], q[2]), d=V3(q[3], q[4], q[5]),
        att=V3(q[6], q[7], q[8]), rad=V3(q[9], q[10], q[11]),
        result=V3(q[12], q[13], q[14]), done=q[16]), q[15]


def _chunk_loop(scene, st, orig, key, key0, rays, i_lo, i_hi, *,
                rr: bool, sort_every: int, final: bool = False):
    """Bounce iterations [i_lo, i_hi) of the megakernel body, with the
    re-sort AFTER each trace_step instead of before the next one — the
    identical operation stream (…step_i, resort_i, tally_{i+1},
    step_{i+1}…), just bracketed so every chunk ENDS live-first-sorted
    and the host can shrink the queue to the live bucket. The final
    iteration always sorts (force-compacted even under SRT_SORT_KEY=
    none / SRT_MK_SORT=0) because the shrink depends on it — except in
    the render's FINAL chunk (final=True, static), where no shrink or
    consumer follows and the forced sort would be a wasted argsort +
    packed take over the whole bucket."""
    def cond(c):
        i, st, _, _, _ = c
        return (i < i_hi) & jnp.any(~st.done)

    def body(c):
        i, st, orig, key, rays = c
        rays = rays.at[i].add(jnp.sum((~st.done).astype(jnp.int32)))
        st = _trace.trace_step(scene, st, key, i + 2, rr=rr,
                               bounce_idx=i)
        last = jnp.bool_(False) if final else (i + 1 >= i_hi)
        do = last if not sort_every else ((i % sort_every == 0) | last)
        st, key, orig = jax.lax.cond(
            do,
            lambda s, k, g: _resort(scene, s, key0, g, force=True),
            lambda s, k, g: (s, k, g), st, key, orig)
        return (i + 1, st, orig, key, rays)

    _, st, orig, key, rays = jax.lax.while_loop(
        cond, body, (i_lo, st, orig, key, rays))
    return st, orig, rays


def _scatter_results(res, st: PathState, orig):
    """Persist per-lane results into the full-wave-width slots by the
    riding global lane id. A SET, not an add: each lane owns one slot,
    live lanes write the zeros already there, dead lanes idempotently
    rewrite the value they carried — so the frame reduction
    reshape(waves, n).sum(axis=0) is bit-identical to the unchunked
    engine's, whose per-lane result array never moves."""
    rx, ry, rz = res
    return (rx.at[orig].set(st.result.x),
            ry.at[orig].set(st.result.y),
            rz.at[orig].set(st.result.z))


def _chunk_first_body(scene, cam: Camera, seed, sample_idx0, pix0,
                      i_hi, *, n_local: int, width: int,
                      max_depth: int, waves: int, rr: bool,
                      sort_every: int, final: bool = False):
    """Unjitted wave bring-up + bounces [0, i_hi): camera rays,
    per-lane keys, bounce 0, then the chunk loop. Parameterized on a
    GLOBAL pixel offset (pix0) and absolute sample offset
    (sample_idx0) so the sharded host loop
    (parallel/mesh.py) can run this same core per shard with
    shard-local pixel/sample slices while every (global pixel,
    absolute sample) draws the single-chip key stream. Returns
    (queue cols, result slots, tallies, key0, live count)."""
    r = waves * n_local
    lane = jnp.arange(r, dtype=jnp.uint32)
    pix = jnp.asarray(pix0, jnp.uint32) + lane % jnp.uint32(n_local)
    px = (pix % jnp.uint32(width)).astype(jnp.int32)
    py = (pix // jnp.uint32(width)).astype(jnp.int32)
    sample_idx = (jnp.asarray(sample_idx0, jnp.uint32)
                  + lane // jnp.uint32(n_local))
    key0 = _rng.make_key(
        _rng.make_key(jnp.asarray(seed, jnp.uint32), sample_idx), pix)
    o, d = generate_rays(cam, px, py, key0)
    st = PathState(
        o=o, d=d,
        att=splat((1.0, 1.0, 1.0), (r,)),
        rad=splat((0.0, 0.0, 0.0), (r,)),
        result=splat((0.0, 0.0, 0.0), (r,)),
        done=jnp.zeros((r,), bool))
    orig = jnp.arange(r, dtype=jnp.int32)
    rays = jnp.zeros((max_depth,), jnp.int32)

    # bounce 0
    rays = rays.at[0].add(r)
    st = _trace.trace_step(scene, st, key0, 2, rr=rr, bounce_idx=0)
    key = key0
    if sort_every or not final:
        # the i=1 cadence sort (any sort_every >= 1 sorts pre-step 1);
        # under sort_every=0 it is only the shrink-enabling force, so
        # a final (single-chunk) render skips it
        st, key, orig = _resort(scene, st, key0, orig, force=True)

    st, orig, rays = _chunk_loop(scene, st, orig, key, key0, rays,
                                 jnp.int32(1), i_hi, rr=rr,
                                 sort_every=sort_every, final=final)
    zero = jnp.zeros((r,), jnp.float32)
    res = _scatter_results((zero, zero, zero), st, orig)
    live = jnp.sum((~st.done).astype(jnp.int32))
    return _q_of(st, orig), res, rays, key0, live


@functools.partial(jax.jit, static_argnames=(
    "width", "height", "max_depth", "waves", "rr", "sort_every",
    "final"),
    donate_argnums=())
def _chunk_first(scene, cam: Camera, seed, sample_offset, i_hi, *,
                 width: int, height: int, max_depth: int, waves: int,
                 rr: bool, sort_every: int, final: bool = False):
    """Single-chip jit wrapper over _chunk_first_body (whole frame,
    pixel offset 0)."""
    return _chunk_first_body(
        scene, cam, seed, sample_offset, jnp.uint32(0), i_hi,
        n_local=width * height, width=width, max_depth=max_depth,
        waves=waves, rr=rr, sort_every=sort_every, final=final)


def _chunk_next_body(scene, q, res, rays, key0, i_lo, i_hi, *,
                     rr: bool, sort_every: int, final: bool = False):
    """Unjitted bounces [i_lo, i_hi) on a shrunk queue (every input
    row is a real lane: the inter-chunk slice keeps a live-first-sorted
    prefix plus at most bucket-padding DEAD rows, whose done flag rides
    in the queue). Shared with the sharded host loop."""
    st, orig = _st_of(q)
    key = jnp.take(key0, orig, axis=0)
    st, orig, rays = _chunk_loop(scene, st, orig, key, key0, rays,
                                 i_lo, i_hi, rr=rr,
                                 sort_every=sort_every, final=final)
    res = _scatter_results(res, st, orig)
    live = jnp.sum((~st.done).astype(jnp.int32))
    return _q_of(st, orig), res, rays, live


@functools.partial(jax.jit, static_argnames=("rr", "sort_every",
                                             "final"),
                   donate_argnums=(1, 2, 3))
def _chunk_next(scene, q, res, rays, key0, i_lo, i_hi, *, rr: bool,
                sort_every: int, final: bool = False):
    """Single-chip jit wrapper over _chunk_next_body. Queue, result
    slots, and tallies are donated."""
    return _chunk_next_body(scene, q, res, rays, key0, i_lo, i_hi,
                            rr=rr, sort_every=sort_every, final=final)


def _chunked_wave(scene, cam: Camera, seed, s, w, *, width: int,
                  height: int, max_depth: int, rr: bool, chunk: int,
                  sort_every: int):
    """One wave of the bounce-chunked megakernel (SRT_MK_CHUNK=k).

    A traced while_loop has static shapes: shade/sort rows stay at
    full wave width while the live count decays. Chunking runs k fused
    bounce iterations per device program and shrinks the queue to the
    live-count bucket between programs -- the analog of the reference
    SIMT megakernel's dead threads retiring inside one kernel launch
    (render_megakernel.cpp:75-187). Estimator-exact: images are
    bit-identical to the unchunked engine (permutations + per-lane
    result slots; see _chunk_loop/_scatter_results), and the host sees
    one scalar per chunk instead of wavefront's one per bounce.

    Returns (linear accumulator [n, 3] summed over the wave's samples,
    per-bounce ray tallies)."""
    from sycl_ray_tracer_tpu.models.wavefront import (bucket_of,
                                                      shrink_queue)

    n = width * height
    r = w * n
    i_hi0 = min(chunk, max_depth)
    q, res, rays, key0, live = _chunk_first(
        scene, cam, seed, s, jnp.int32(i_hi0),
        width=width, height=height, max_depth=max_depth, waves=w,
        rr=rr, sort_every=sort_every, final=(i_hi0 >= max_depth))
    count = int(live)
    i0 = chunk
    while i0 < max_depth and count > 0:
        b = bucket_of(count, r)
        if q[0].shape[0] != b:
            q = shrink_queue(q, b=b)
        i_hi = min(i0 + chunk, max_depth)
        q, res, rays, live = _chunk_next(
            scene, q, res, rays, key0, jnp.int32(i0),
            jnp.int32(i_hi), rr=rr, sort_every=sort_every,
            final=(i_hi >= max_depth))
        count = int(live)
        i0 = i_hi
    return jnp.stack(res, axis=-1).reshape(w, n, 3).sum(axis=0), rays


# Cadence defaults for every backend (see mk_cadence): chunk=2,
# sort_every=2 won the A/B at sponza_proc 1024^2 spp8 d10 on an H100
# against chunk/sort off and chunk=3/sort=1 (CHANGES.md).
MK_CHUNK = 2
MK_SORT = 2


def mk_cadence() -> Tuple[int, int]:
    """(chunk, sort_every) cadence policy -- shared by the one-device
    render loop and the sharded host loop (parallel/mesh.py) so the two
    cannot drift.

    sort_every=k > 0 coherence-re-sorts live lanes every k bounces (see
    _sample_one); chunk=k > 0 runs the bounce-chunked engine, k fused
    bounces per program with the queue shrunk to the live bucket
    between programs (see _chunked_wave). Both are estimator-exact.
    SRT_MK_SORT / SRT_MK_CHUNK override the defaults (MK_SORT,
    MK_CHUNK) for every depth."""
    import os

    sort_every = int(os.environ.get("SRT_MK_SORT", str(MK_SORT)))
    chunk = int(os.environ.get("SRT_MK_CHUNK", str(MK_CHUNK)))
    return chunk, sort_every


def render_megakernel(scene, cam: Camera, *, width: int, height: int,
                      spp: int, max_depth: int, seed: int = 0,
                      rr: bool = False) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Returns (image [H, W, 3] float32 gamma-encoded,
    per-bounce ray counts [max_depth] int32 — sum on host for total).

    Host-driven wave loop (see render_wavefront's docstring) — one
    compiled device program per wave of up to SRT_WAVE_RAYS rays
    (default 8M; megakernel waves are smaller than wavefront's because
    there is no compaction to shed dead lanes), accumulator on device.
    """
    import os

    wave_rays = int(os.environ.get("SRT_WAVE_RAYS", str(8 << 20)))
    chunk, sort_every = mk_cadence()
    n = width * height
    # max_depth=0 renders black with zero rays (the reference's loop
    # never runs) — only the plain engine expresses that, so the
    # chunked path requires at least one bounce.
    if chunk > 0 and max_depth >= 1:
        def per_wave(s, w):
            return _chunked_wave(scene, cam, seed, s, w, width=width,
                                 height=height, max_depth=max_depth,
                                 rr=rr, chunk=chunk,
                                 sort_every=sort_every)
    else:
        def per_wave(s, w):
            return _wave_frame(scene, cam, seed, s, width=width,
                               height=height, max_depth=max_depth,
                               waves=w, rr=rr, sort_every=sort_every)
    waves = max(1, min(spp, wave_rays // n))
    specs = []
    s = 0
    while s < spp:
        w = min(waves, spp - s)
        specs.append((s, w))
        s += w
    # The chunked megakernel blocks on one `int(live)` scalar per
    # chunk program; interleaving a second wave's programs may fill
    # that gap (see wavefront.interleave_waves).
    from sycl_ray_tracer_tpu.models.wavefront import interleave_waves
    results = interleave_waves(per_wave, specs)
    accum = None
    rays = None
    for a, r in results:
        accum = a if accum is None else accum + a
        rays = r if rays is None else rays + r
    img = linear_to_gamma(accum * (1.0 / spp))
    return img.reshape(height, width, 3), rays
