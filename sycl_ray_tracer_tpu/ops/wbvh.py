"""WBVH8: 8-wide implicit BVH.

Replaces Embree's BVH (the reference's rtcIntersect1 hot path,
trace_ray.hpp:22). Layout:

1. Each traversal step reads exactly ONE row of a UNIFIED node table
   that stores, per row, either an internal node's 8 children AABBs or
   a leaf's K triangles -- whatever the ray's current node needs.
2. Rows are stored COMPONENT-MAJOR ([lox*8 | loy*8 | ... ] /
   [v0x*K | v0y*K | ...]): in the batched XLA walk (traverse8) one
   free reshape [R, C, 8] and a middle-axis slice yields contiguous
   [R*8] flat vectors; the CUDA kernel (native/srt_traverse.cu) reads
   a row as consecutive 16-byte loads.

Topology is an implicit complete 8-ary heap over Morton-sorted
triangle leaves (level-order ids; internal ids [0, NI), leaves
[NI, NI+L)). Children of node i are 8i+1..8i+8 — computed, never
loaded. Because the heap collapses 3 binary Morton splits per level,
child index bits ARE octant bits; traversal visits children in
(child_index XOR ray_octant) order — the classic octree front-to-back
ordering. Per-ray traversal state is a few scalars plus a [depth]
byte trail (pending-sibling bitmasks); no stack arrays.

Empty padding subtrees get the point-at-infinity box (BIG, BIG): an
inverted (+inf, -inf) box does NOT fail a branchless slab test (its
slabs cancel into "no constraint"), a far point-box always does.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from sycl_ray_tracer_tpu.ops import lbvh
from sycl_ray_tracer_tpu.ops.intersect import BIG, TNEAR, Hit, _DET_EPS
from sycl_ray_tracer_tpu.ops.vec import V3

_INF = np.float32(3.0e38)


class Wbvh8(NamedTuple):
    """nodes: [NI + L, W] unified rows (W = max(48, 9K)) -- internal
    row i (i < NI) packs the 8 children AABBs component-major, leaf row
    NI+j packs K triangles component-major.
    order: [L*K] int32 — sorted slot -> original triangle id (-1 pad).
    """

    nodes: jnp.ndarray
    order: jnp.ndarray
    num_internal: int
    depth: int
    leaf_size: int

    @property
    def num_leaves(self) -> int:
        return self.nodes.shape[0] - self.num_internal


def _ceil_log8(n: int) -> int:
    d = 0
    c = 1
    while c < n:
        c *= 8
        d += 1
    return d


def plan(num_tris: int, leaf_size: int):
    """Static tree dimensions for `num_tris` triangles:
    (depth, num_internal, num_leaves, row_width)."""
    depth = max(_ceil_log8(max(-(-num_tris // leaf_size), 1)), 1)
    l_leaves = 8 ** depth
    ni = (8 ** depth - 1) // 7
    width = max(48, 9 * leaf_size)
    return depth, ni, l_leaves, width


def build(tri_v: jnp.ndarray, leaf_size: int = 8):
    """Returns (Wbvh8, sorted_tri_v [L*K,3,3], valid [L*K]).

    Jittable; runs on-device (an on-device analog of Embree's
    rtcCommitScene, scene.cpp:107).
    """
    n = tri_v.shape[0]
    k = leaf_size
    depth, ni, l_leaves, width = plan(n, k)

    # Morton order.
    centroids = tri_v.mean(axis=1) if n else jnp.zeros((0, 3))
    lo = centroids.min(axis=0) if n else jnp.zeros(3)
    hi = centroids.max(axis=0) if n else jnp.ones(3)
    codes = lbvh.morton30(centroids, lo, hi) if n else jnp.zeros(
        (0,), jnp.uint32)
    perm = jnp.argsort(codes).astype(jnp.int32)
    pad = l_leaves * k - n
    order = jnp.concatenate([perm, jnp.full((pad,), -1, jnp.int32)])
    valid = order >= 0
    safe = jnp.maximum(order, 0)
    if n:
        sorted_v = jnp.take(tri_v, safe, axis=0)
        sorted_v = jnp.where(valid[:, None, None], sorted_v, 0.0)
    else:
        sorted_v = jnp.zeros((l_leaves * k, 3, 3), tri_v.dtype)

    # Per-leaf AABBs (inverted sentinel while fitting).
    lo_tri = jnp.where(valid[:, None], sorted_v.min(axis=1), _INF)
    hi_tri = jnp.where(valid[:, None], sorted_v.max(axis=1), -_INF)
    leaf_lo = lo_tri.reshape(l_leaves, k, 3).min(axis=1)
    leaf_hi = hi_tri.reshape(l_leaves, k, 3).max(axis=1)

    # Binary levels bottom-up.
    lvl_lo = [leaf_lo]
    lvl_hi = [leaf_hi]
    while lvl_lo[0].shape[0] > 1:
        lvl_lo.insert(0, jnp.minimum(lvl_lo[0][0::2], lvl_lo[0][1::2]))
        lvl_hi.insert(0, jnp.maximum(lvl_hi[0][0::2], lvl_hi[0][1::2]))

    # Internal rows: component-major children boxes.
    blocks = []
    for d in range(depth):
        bl = lvl_lo[3 * (d + 1)]
        bh = lvl_hi[3 * (d + 1)]
        empty = bh[:, :1] < bl[:, :1]
        bl = jnp.where(empty, _INF, bl)
        bh = jnp.where(empty, _INF, bh)
        # [8^(d+1), 3] -> [8^d, 8, 3] -> [8^d, 3, 8] -> [8^d, 24]
        bl8 = bl.reshape(8 ** d, 8, 3).transpose(0, 2, 1).reshape(-1, 24)
        bh8 = bh.reshape(8 ** d, 8, 3).transpose(0, 2, 1).reshape(-1, 24)
        blocks.append(jnp.concatenate([bl8, bh8], axis=1))  # [8^d, 48]
    internal = jnp.concatenate(blocks, axis=0)
    if width > 48:
        internal = jnp.pad(internal, ((0, 0), (0, width - 48)))

    # Leaf rows: component-major triangles.
    v0 = sorted_v[:, 0, :]
    e1 = sorted_v[:, 1, :] - sorted_v[:, 0, :]
    e2 = sorted_v[:, 2, :] - sorted_v[:, 0, :]
    comps = jnp.concatenate([v0, e1, e2], axis=1)  # [L*K, 9]
    # [L, K, 9] -> [L, 9, K] -> [L, 9K]
    leaf_rows = comps.reshape(l_leaves, k, 9).transpose(0, 2, 1).reshape(
        l_leaves, 9 * k)
    if width > 9 * k:
        leaf_rows = jnp.pad(leaf_rows, ((0, 0), (0, width - 9 * k)))

    nodes = jnp.concatenate([internal, leaf_rows], axis=0)
    return Wbvh8(nodes=nodes, order=order, num_internal=ni,
                 depth=depth, leaf_size=k), sorted_v, valid


def morton30_np(p: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """numpy twin of lbvh.morton30 (bit-identical given f32 inputs)."""
    def expand(x):
        x = x.astype(np.uint32) & np.uint32(0x3FF)
        x = (x | (x << 16)) & np.uint32(0x030000FF)
        x = (x | (x << 8)) & np.uint32(0x0300F00F)
        x = (x | (x << 4)) & np.uint32(0x030C30C3)
        x = (x | (x << 2)) & np.uint32(0x09249249)
        return x
    extent = np.maximum((hi - lo).astype(np.float32), np.float32(1e-20))
    q = np.clip((p - lo).astype(np.float32) / extent,
                np.float32(0.0), np.float32(1.0 - 1e-7))
    cell = (q * np.float32(1024.0)).astype(np.uint32)
    return ((expand(cell[:, 0]) << 2) | (expand(cell[:, 1]) << 1)
            | expand(cell[:, 2]))


def build_np(tri_v: np.ndarray, leaf_size: int = 8):
    """Host (numpy) twin of `build`: same Wbvh8 layout, milliseconds
    instead of an XLA compile. This is the default scene-build path —
    the jitted `build` stays as the on-device option and cross-check
    (the jitted build's time is nearly all compile time; Embree
    commits Sponza in well under a second).
    """
    tri_v = np.asarray(tri_v, np.float32)
    n = tri_v.shape[0]
    k = leaf_size
    depth, ni, l_leaves, width = plan(n, k)

    if n:
        centroids = tri_v.mean(axis=1, dtype=np.float32)
        lo = centroids.min(axis=0)
        hi = centroids.max(axis=0)
        codes = morton30_np(centroids, lo, hi)
        # jnp.argsort is stable; match it so both builds produce
        # identical trees on tied codes
        perm = np.argsort(codes, kind="stable").astype(np.int32)
    else:
        perm = np.zeros((0,), np.int32)
    pad = l_leaves * k - n
    order = np.concatenate([perm, np.full((pad,), -1, np.int32)])
    valid = order >= 0
    safe = np.maximum(order, 0)
    if n:
        sorted_v = tri_v[safe]
        sorted_v[~valid] = 0.0
    else:
        sorted_v = np.zeros((l_leaves * k, 3, 3), np.float32)

    lo_tri = np.where(valid[:, None], sorted_v.min(axis=1), _INF)
    hi_tri = np.where(valid[:, None], sorted_v.max(axis=1), -_INF)
    leaf_lo = lo_tri.reshape(l_leaves, k, 3).min(axis=1)
    leaf_hi = hi_tri.reshape(l_leaves, k, 3).max(axis=1)

    lvl_lo = [leaf_lo]
    lvl_hi = [leaf_hi]
    while lvl_lo[0].shape[0] > 1:
        lvl_lo.insert(0, np.minimum(lvl_lo[0][0::2], lvl_lo[0][1::2]))
        lvl_hi.insert(0, np.maximum(lvl_hi[0][0::2], lvl_hi[0][1::2]))

    blocks = []
    for d in range(depth):
        bl = lvl_lo[3 * (d + 1)].copy()
        bh = lvl_hi[3 * (d + 1)].copy()
        empty = (bh[:, 0] < bl[:, 0])
        bl[empty] = _INF
        bh[empty] = _INF
        bl8 = bl.reshape(8 ** d, 8, 3).transpose(0, 2, 1).reshape(-1, 24)
        bh8 = bh.reshape(8 ** d, 8, 3).transpose(0, 2, 1).reshape(-1, 24)
        blocks.append(np.concatenate([bl8, bh8], axis=1))
    internal = np.concatenate(blocks, axis=0)
    if width > 48:
        internal = np.pad(internal, ((0, 0), (0, width - 48)))

    v0 = sorted_v[:, 0, :]
    e1 = sorted_v[:, 1, :] - sorted_v[:, 0, :]
    e2 = sorted_v[:, 2, :] - sorted_v[:, 0, :]
    comps = np.concatenate([v0, e1, e2], axis=1)
    leaf_rows = comps.reshape(l_leaves, k, 9).transpose(0, 2, 1).reshape(
        l_leaves, 9 * k)
    if width > 9 * k:
        leaf_rows = np.pad(leaf_rows, ((0, 0), (0, width - 9 * k)))

    nodes = np.concatenate([internal, leaf_rows], axis=0)
    return Wbvh8(nodes=nodes, order=order, num_internal=ni,
                 depth=depth, leaf_size=k), sorted_v, valid


def _lowest_bit_index(m: jnp.ndarray) -> jnp.ndarray:
    """Index of the lowest set bit of m (int32, m != 0). Exact for
    8-bit masks: log2 of a power of two is exact in f32."""
    lsb = m & -m
    return jnp.log2(lsb.astype(jnp.float32)).astype(jnp.int32)


def _rep(x: jnp.ndarray, k: int) -> jnp.ndarray:
    """[R] -> [R*k], element-interleaved (matches [R, k] row-major)."""
    return jnp.repeat(x, k, total_repeat_length=x.shape[0] * k)


def traverse8(nodes: jnp.ndarray, num_internal: int,
              depth: int, leaf_size: int,
              o: V3, d: V3,
              active_in: jnp.ndarray | None = None) -> Hit:
    """Closest-hit traversal. o/d: V3 of [R]. Returns Hit with tri ids
    in sorted-slot order (-1 = miss)."""
    ni = num_internal
    k = leaf_size
    r = o.x.shape[0]
    n_rows = nodes.shape[0]

    inv = V3(
        jnp.where(jnp.abs(d.x) > 1e-20, 1.0 / d.x, jnp.float32(1e20)),
        jnp.where(jnp.abs(d.y) > 1e-20, 1.0 / d.y, jnp.float32(1e20)),
        jnp.where(jnp.abs(d.z) > 1e-20, 1.0 / d.z, jnp.float32(1e20)),
    )
    oct_ = ((d.x < 0).astype(jnp.int32) << 2
            | (d.y < 0).astype(jnp.int32) << 1
            | (d.z < 0).astype(jnp.int32))

    # Loop-invariant flat broadcasts.
    o8 = V3(_rep(o.x, 8), _rep(o.y, 8), _rep(o.z, 8))
    inv8 = V3(_rep(inv.x, 8), _rep(inv.y, 8), _rep(inv.z, 8))
    if k == 8:
        oK = o8
        dK = V3(_rep(d.x, 8), _rep(d.y, 8), _rep(d.z, 8))
    else:
        oK = V3(_rep(o.x, k), _rep(o.y, k), _rep(o.z, k))
        dK = V3(_rep(d.x, k), _rep(d.y, k), _rep(d.z, k))
    j8 = jnp.arange(8, dtype=jnp.int32)

    active0 = jnp.ones((r,), bool) if active_in is None else active_in

    state = dict(
        cur=jnp.zeros((r,), jnp.int32),
        level=jnp.zeros((r,), jnp.int32),
        trail=tuple(jnp.zeros((r,), jnp.int32) for _ in range(depth)),
        t=jnp.full((r,), BIG, jnp.float32),
        tri=jnp.full((r,), -1, jnp.int32),
        u=jnp.zeros((r,), jnp.float32),
        v=jnp.zeros((r,), jnp.float32),
        alive=active0,
    )

    def cond(s):
        return jnp.any(s["alive"])

    def step(s):
        cur, level, trail, alive = s["cur"], s["level"], s["trail"], s["alive"]
        is_leaf = cur >= ni

        # ---------------- ONE unified gather -------------------------
        row = jnp.take(nodes, jnp.clip(cur, 0, n_rows - 1), axis=0)

        # ---------------- internal: slab 8 children ------------------
        # row[:, :48] as [R, 6, 8]; component c slice -> flat [8R].
        boxes = row[:, :48].reshape(r, 6, 8)
        cflat = lambda c: boxes[:, c, :].reshape(r * 8)
        t1x = (cflat(0) - o8.x) * inv8.x
        t1y = (cflat(1) - o8.y) * inv8.y
        t1z = (cflat(2) - o8.z) * inv8.z
        t2x = (cflat(3) - o8.x) * inv8.x
        t2y = (cflat(4) - o8.y) * inv8.y
        t2z = (cflat(5) - o8.z) * inv8.z
        tmin = jnp.maximum(jnp.maximum(jnp.minimum(t1x, t2x),
                                       jnp.minimum(t1y, t2y)),
                           jnp.minimum(t1z, t2z)).reshape(r, 8)
        tmax = jnp.minimum(jnp.minimum(jnp.maximum(t1x, t2x),
                                       jnp.maximum(t1y, t2y)),
                           jnp.maximum(t1z, t2z)).reshape(r, 8)
        chit = ((tmax >= jnp.maximum(tmin, TNEAR))
                & (tmin < s["t"][:, None])
                & ((~is_leaf) & alive)[:, None])
        # Pre-permuted pending mask: bit (j XOR oct) <-> child j.
        pm = jnp.sum(chit.astype(jnp.int32)
                     << (j8[None, :] ^ oct_[:, None]), axis=1)

        # ---------------- leaf: Moller-Trumbore K tris ----------------
        tris = row[:, :9 * k].reshape(r, 9, k)
        tflat = lambda c: tris[:, c, :].reshape(r * k)
        v0 = V3(tflat(0), tflat(1), tflat(2))
        e1 = V3(tflat(3), tflat(4), tflat(5))
        e2 = V3(tflat(6), tflat(7), tflat(8))
        # MT in flat [K*R] domain (full VPU lanes)
        px_ = dK.y * e2.z - dK.z * e2.y
        py_ = dK.z * e2.x - dK.x * e2.z
        pz_ = dK.x * e2.y - dK.y * e2.x
        det = e1.x * px_ + e1.y * py_ + e1.z * pz_
        inv_det = jnp.where(jnp.abs(det) > _DET_EPS, 1.0 / det, 0.0)
        tx = oK.x - v0.x
        ty = oK.y - v0.y
        tz = oK.z - v0.z
        uu = (tx * px_ + ty * py_ + tz * pz_) * inv_det
        qx = ty * e1.z - tz * e1.y
        qy = tz * e1.x - tx * e1.z
        qz = tx * e1.y - ty * e1.x
        vv = (dK.x * qx + dK.y * qy + dK.z * qz) * inv_det
        tt = (e2.x * qx + e2.y * qy + e2.z * qz) * inv_det
        ok = ((jnp.abs(det) > _DET_EPS)
              & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
              & (tt > TNEAR))
        tt2 = jnp.where(ok, tt, BIG).reshape(r, k)
        tt2 = jnp.where((alive & is_leaf)[:, None], tt2, BIG)
        kb = jnp.argmin(tt2, axis=1)
        t_cand = jnp.min(tt2, axis=1)
        better = t_cand < s["t"]
        flat_idx = jnp.arange(r, dtype=jnp.int32) * k + kb.astype(jnp.int32)
        t_new = jnp.where(better, t_cand, s["t"])
        tri_new = jnp.where(better, (cur - ni) * k + kb.astype(jnp.int32),
                            s["tri"])
        u_new = jnp.where(better, jnp.take(uu, flat_idx), s["u"])
        v_new = jnp.where(better, jnp.take(vv, flat_idx), s["v"])

        # ---------------- advance ------------------------------------
        has = pm != 0
        descend = alive & ~is_leaf & has
        p_low = _lowest_bit_index(jnp.where(has, pm, 1))
        child = cur * 8 + 1 + (p_low ^ oct_)
        rest = pm & (pm - 1)
        trail_desc = tuple(
            jnp.where(descend & (level == dd), rest, trail[dd])
            for dd in range(depth))

        backtrack = alive & (is_leaf | (~is_leaf & ~has))
        dstar = jnp.full((r,), -1, jnp.int32)
        for dd in range(depth):
            dstar = jnp.where(trail_desc[dd] != 0, dd, dstar)
        dead = backtrack & (dstar < 0)
        pm_b = jnp.zeros((r,), jnp.int32)
        for dd in range(depth):
            pm_b = jnp.where(dstar == dd, trail_desc[dd], pm_b)
        p_b = _lowest_bit_index(jnp.where(pm_b != 0, pm_b, 1))
        rest_b = pm_b & (pm_b - 1)
        steps = jnp.clip(level - dstar, 0, depth)
        anc = cur
        for si in range(depth):
            anc = jnp.where(si < steps, (anc - 1) // 8, anc)
        child_b = anc * 8 + 1 + (p_b ^ oct_)
        pop = backtrack & ~dead
        trail_new = tuple(
            jnp.where(pop & (dstar == dd), rest_b, trail_desc[dd])
            for dd in range(depth))

        cur_new = jnp.where(descend, child, jnp.where(pop, child_b, cur))
        level_new = jnp.where(descend, level + 1,
                              jnp.where(pop, dstar + 1, level))
        alive_new = alive & ~dead

        return dict(cur=cur_new, level=level_new, trail=trail_new,
                    t=t_new, tri=tri_new, u=u_new, v=v_new,
                    alive=alive_new)

    out = jax.lax.while_loop(cond, step, state)
    return Hit(t=out["t"], tri=out["tri"], u=out["u"], v=out["v"])
