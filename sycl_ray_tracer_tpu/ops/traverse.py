"""BVH traversal: batched, mask-predicated, stack-per-lane.

Replaces Embree's rtcIntersect1 traversal (trace_ray.hpp:22) with a
walk that runs *all* rays in lock-step array ops, each lane carrying
its own traversal state: the independent cross-check of the WBVH8
walks. Divergence costs idle lanes; the implicit-heap BVH
(ops/lbvh.py) keeps every step's memory traffic to index-free
arithmetic plus a handful of row gathers.

Per step, per lane (fully vectorized, no data-dependent control flow):
  - internal node: slab-test both children (children of i are 2i, 2i+1
    — computed, not loaded), descend the nearer hit child, push the
    farther hit child; pop on double miss.
  - leaf node: Moller-Trumbore the leaf's K triangles (contiguous rows
    — one gather of K rows per lane), keep the closest, pop.
The loop is a lax.while_loop ending when every lane's stack is empty.
t_best tightens as hits land, culling AABBs on later steps.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from sycl_ray_tracer_tpu.ops.intersect import Hit, moller_trumbore, TNEAR, BIG
from sycl_ray_tracer_tpu.ops.vec import V3


def _slab_test(o: V3, inv_d: V3, t_best, lo: V3, hi: V3):
    """Returns (hit, t_entry) for AABB vs ray. Inverted (empty) AABBs
    never hit. Robust to inf*0: uses min/max of per-axis slabs."""
    t1x = (lo.x - o.x) * inv_d.x
    t2x = (hi.x - o.x) * inv_d.x
    t1y = (lo.y - o.y) * inv_d.y
    t2y = (hi.y - o.y) * inv_d.y
    t1z = (lo.z - o.z) * inv_d.z
    t2z = (hi.z - o.z) * inv_d.z
    tmin = jnp.maximum(jnp.maximum(jnp.minimum(t1x, t2x),
                                   jnp.minimum(t1y, t2y)),
                       jnp.minimum(t1z, t2z))
    tmax = jnp.minimum(jnp.minimum(jnp.maximum(t1x, t2x),
                                   jnp.maximum(t1y, t2y)),
                       jnp.maximum(t1z, t2z))
    hit = (tmax >= jnp.maximum(tmin, TNEAR)) & (tmin < t_best)
    return hit, tmin


def _gather_v3(table: jnp.ndarray, idx: jnp.ndarray) -> V3:
    g = jnp.take(table, idx, axis=0)
    return V3(g[..., 0], g[..., 1], g[..., 2])


def traverse(node_lo: jnp.ndarray, node_hi: jnp.ndarray,
             tri_v0: jnp.ndarray, tri_e1: jnp.ndarray, tri_e2: jnp.ndarray,
             o: V3, d: V3, leaf_size: int,
             active_in: jnp.ndarray | None = None) -> Hit:
    """Closest-hit traversal.

    node_lo/node_hi: [2L, 3]; tri_*: [L*K, 3] in sorted leaf order
    (padding rows are degenerate and rejected by MT); o/d: V3 of [R].
    Returns Hit with `tri` indices in *sorted* order (-1 = miss).
    `active_in` lanes set to False skip all work (used by renderers for
    dead rays).
    """
    l_leaves = node_lo.shape[0] // 2
    depth = max(l_leaves.bit_length() + 1, 2)
    r = o.x.shape[0]
    k = leaf_size

    inv_d = V3(
        jnp.where(jnp.abs(d.x) > 1e-20, 1.0 / d.x, jnp.float32(1e20)),
        jnp.where(jnp.abs(d.y) > 1e-20, 1.0 / d.y, jnp.float32(1e20)),
        jnp.where(jnp.abs(d.z) > 1e-20, 1.0 / d.z, jnp.float32(1e20)),
    )

    active0 = jnp.ones((r,), bool) if active_in is None else active_in
    # Root pre-test lets fully-missing rays skip the loop immediately.
    root_hit, _ = _slab_test(o, inv_d, jnp.full((r,), BIG),
                             _gather_v3(node_lo, jnp.ones((r,), jnp.int32)),
                             _gather_v3(node_hi, jnp.ones((r,), jnp.int32)))

    state = dict(
        cur=jnp.ones((r,), jnp.int32),
        sp=jnp.zeros((r,), jnp.int32),
        stack=jnp.zeros((r, depth), jnp.int32),
        t=jnp.full((r,), BIG, jnp.float32),
        tri=jnp.full((r,), -1, jnp.int32),
        u=jnp.zeros((r,), jnp.float32),
        v=jnp.zeros((r,), jnp.float32),
        alive=active0 & root_hit & (l_leaves > 0),
    )

    def cond(s):
        return jnp.any(s["alive"])

    def step(s):
        cur, sp, stack = s["cur"], s["sp"], s["stack"]
        alive = s["alive"]
        is_leaf = cur >= l_leaves

        # ---- internal: test children --------------------------------
        left = cur * 2
        right = left + 1
        # Clamp for dead/leaf lanes so gathers stay in range.
        lc = jnp.clip(jnp.where(is_leaf, 1, left), 0, 2 * l_leaves - 1)
        rc = jnp.clip(jnp.where(is_leaf, 1, right), 0, 2 * l_leaves - 1)
        hit_l, t_l = _slab_test(o, inv_d, s["t"],
                                _gather_v3(node_lo, lc), _gather_v3(node_hi, lc))
        hit_r, t_r = _slab_test(o, inv_d, s["t"],
                                _gather_v3(node_lo, rc), _gather_v3(node_hi, rc))
        l_first = jnp.where(hit_l & hit_r, t_l <= t_r, hit_l)
        near = jnp.where(l_first, left, right)
        far = jnp.where(l_first, right, left)
        n_hits = hit_l.astype(jnp.int32) + hit_r.astype(jnp.int32)

        do_internal = alive & ~is_leaf
        push = do_internal & (n_hits == 2)
        stack2 = jnp.where(
            push[:, None]
            & (jnp.arange(depth)[None, :] == sp[:, None]),
            far[:, None], stack)
        sp2 = jnp.where(push, sp + 1, sp)
        descend = do_internal & (n_hits >= 1)
        cur_desc = jnp.where(n_hits == 2, near,
                             jnp.where(hit_l, left, right))

        # ---- leaf: K triangle tests ----------------------------------
        do_leaf = alive & is_leaf
        leaf_start = (cur - l_leaves) * k
        tri_idx = jnp.clip(leaf_start[:, None] + jnp.arange(k)[None, :],
                           0, tri_v0.shape[0] - 1)
        v0 = _gather_v3(tri_v0, tri_idx)
        e1 = _gather_v3(tri_e1, tri_idx)
        e2 = _gather_v3(tri_e2, tri_idx)
        ob = V3(o.x[:, None], o.y[:, None], o.z[:, None])
        db = V3(d.x[:, None], d.y[:, None], d.z[:, None])
        ok, tt, uu, vv = moller_trumbore(ob, db, v0, e1, e2, s["t"][:, None])
        ok = ok & do_leaf[:, None]
        tt = jnp.where(ok, tt, BIG)
        kbest = jnp.argmin(tt, axis=1)
        take = lambda a: jnp.take_along_axis(a, kbest[:, None], 1)[:, 0]
        t_cand = take(tt)
        better = t_cand < s["t"]
        t_new = jnp.where(better, t_cand, s["t"])
        tri_new = jnp.where(better, take(tri_idx).astype(jnp.int32), s["tri"])
        u_new = jnp.where(better, take(uu), s["u"])
        v_new = jnp.where(better, take(vv), s["v"])

        # ---- pop / advance -------------------------------------------
        need_pop = alive & (do_leaf | (do_internal & (n_hits == 0)))
        can_pop = sp2 > 0
        sp3 = jnp.where(need_pop & can_pop, sp2 - 1, sp2)
        popped = jnp.take_along_axis(
            stack2, jnp.clip(sp3, 0, depth - 1)[:, None], 1)[:, 0]
        cur_new = jnp.where(descend, cur_desc,
                            jnp.where(need_pop & can_pop, popped, cur))
        alive_new = alive & ~(need_pop & ~can_pop)

        return dict(cur=cur_new, sp=sp3, stack=stack2, t=t_new,
                    tri=tri_new, u=u_new, v=v_new, alive=alive_new)

    out = jax.lax.while_loop(cond, step, state)
    return Hit(t=out["t"], tri=out["tri"], u=out["u"], v=out["v"])
