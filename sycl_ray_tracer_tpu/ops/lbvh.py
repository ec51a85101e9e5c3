"""On-device LBVH build: Morton sort + implicit complete-tree topology.

Replaces Embree's BVH build (scene.cpp:101-107, 404-439). Design is
deliberately NOT a Karras radix tree: a Karras build wants per-node
atomics for the AABB-fit pass, which a traced array program does
not have. Instead:

1. Morton-encode triangle centroids (30-bit, 10/axis).
2. Sort triangles by code (jax.lax sort).
3. Pack K consecutive sorted triangles per leaf; pad leaf count to a
   power of two with empty (inverted-AABB) leaves.
4. Treat the leaves as the bottom level of a *complete binary heap*
   (node 1 = root, children of i are 2i and 2i+1, leaves are
   [L, 2L)). Topology is implicit — no child pointers, no parent
   finding, nothing to link.
5. AABB fit = log2(L) vectorized min/max halving passes — a pure
   data-parallel reduction, no atomics, runs on-device under jit.

A heap split at Morton-order midpoints closely tracks Karras's
bit-boundary splits in practice while making both build and traversal
branch-free and fully static-shaped, which is what XLA wants.

The whole build is jittable; it also runs fine on CPU for tests.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

DEFAULT_LEAF_SIZE = 4

# np scalar, not jnp: a module-level jnp constant would initialize the
# default JAX backend at import time, before callers can pick one.
_INF = np.float32(3.0e38)


class Bvh(NamedTuple):
    """Implicit-heap BVH. node_lo/node_hi are [2L, 3] (index 0 unused).

    Leaves are nodes [L, 2L); leaf i holds sorted triangles
    [i*K, (i+1)*K). `order` maps sorted slot -> original triangle id
    (-1 for padding slots). Triangle data is stored pre-sorted and
    pre-padded by the scene builder so traversal needs no indirection.
    """

    node_lo: jnp.ndarray  # [2L, 3] float32
    node_hi: jnp.ndarray  # [2L, 3] float32
    order: jnp.ndarray    # [L*K] int32, original tri index or -1

    @property
    def num_leaves(self) -> int:
        return self.node_lo.shape[0] // 2

    @property
    def leaf_size(self) -> int:
        return self.order.shape[0] // self.num_leaves


def _expand_bits(x: jnp.ndarray) -> jnp.ndarray:
    """Spread the low 10 bits of x so there are 2 zeros between each
    (standard Morton bit-interleave, public-domain technique)."""
    x = x.astype(jnp.uint32) & jnp.uint32(0x3FF)
    x = (x | (x << 16)) & jnp.uint32(0x030000FF)
    x = (x | (x << 8)) & jnp.uint32(0x0300F00F)
    x = (x | (x << 4)) & jnp.uint32(0x030C30C3)
    x = (x | (x << 2)) & jnp.uint32(0x09249249)
    return x


def morton30(p: jnp.ndarray, lo: jnp.ndarray, hi: jnp.ndarray) -> jnp.ndarray:
    """30-bit Morton codes for points p [N,3] inside bbox (lo, hi)."""
    extent = jnp.maximum(hi - lo, 1e-20)
    q = jnp.clip((p - lo) / extent, 0.0, 1.0 - 1e-7)
    cell = (q * 1024.0).astype(jnp.uint32)
    return (
        (_expand_bits(cell[:, 0]) << 2)
        | (_expand_bits(cell[:, 1]) << 1)
        | _expand_bits(cell[:, 2])
    )


def next_pow2(n: int) -> int:
    n = max(int(n), 1)
    return 1 << (n - 1).bit_length()


def sorted_order(tri_v: jnp.ndarray, leaf_size: int = DEFAULT_LEAF_SIZE):
    """Morton-sort triangles. Returns (order [L*K] int32 with -1 padding,
    n_leaves L). Static output shapes derive from tri_v.shape[0]."""
    n = tri_v.shape[0]
    k = leaf_size
    l_leaves = next_pow2(-(-n // k)) if n else 1
    centroids = tri_v.mean(axis=1)
    lo = centroids.min(axis=0) if n else jnp.zeros(3)
    hi = centroids.max(axis=0) if n else jnp.ones(3)
    codes = morton30(centroids, lo, hi) if n else jnp.zeros((0,), jnp.uint32)
    perm = jnp.argsort(codes).astype(jnp.int32)
    pad = l_leaves * k - n
    order = jnp.concatenate([perm, jnp.full((pad,), -1, jnp.int32)])
    return order, l_leaves


def fit_nodes(sorted_tri_v: jnp.ndarray, valid: jnp.ndarray,
              l_leaves: int, leaf_size: int):
    """AABB-fit the implicit heap.

    sorted_tri_v: [L*K, 3, 3] (padding rows arbitrary), valid: [L*K] bool.
    Returns (node_lo, node_hi) each [2L, 3]. Empty nodes keep inverted
    AABBs (+inf lo, -inf hi) and can never be hit by the slab test.
    """
    big = _INF
    v = sorted_tri_v
    lo_tri = jnp.where(valid[:, None], v.min(axis=1), big)
    hi_tri = jnp.where(valid[:, None], v.max(axis=1), -big)
    leaf_lo = lo_tri.reshape(l_leaves, leaf_size, 3).min(axis=1)
    leaf_hi = hi_tri.reshape(l_leaves, leaf_size, 3).max(axis=1)

    levels_lo = [leaf_lo]
    levels_hi = [leaf_hi]
    while levels_lo[0].shape[0] > 1:
        cur_lo, cur_hi = levels_lo[0], levels_hi[0]
        levels_lo.insert(0, jnp.minimum(cur_lo[0::2], cur_lo[1::2]))
        levels_hi.insert(0, jnp.maximum(cur_hi[0::2], cur_hi[1::2]))

    # Heap layout: level d occupies nodes [2^d, 2^(d+1)); index 0 unused.
    node_lo = jnp.concatenate([jnp.full((1, 3), big)] + levels_lo)
    node_hi = jnp.concatenate([jnp.full((1, 3), -big)] + levels_hi)
    # Canonicalize empty boxes to the point-at-infinity (BIG, BIG): an
    # inverted box does NOT fail a branchless slab test (its +/-inf
    # slabs cancel into "no constraint"), a far point-box always does.
    empty = node_hi[:, :1] < node_lo[:, :1]
    node_lo = jnp.where(empty, big, node_lo)
    node_hi = jnp.where(empty, big, node_hi)
    return node_lo, node_hi


def build(tri_v: jnp.ndarray, leaf_size: int = DEFAULT_LEAF_SIZE):
    """Full build. Returns (bvh, sorted_tri_v [L*K,3,3], valid [L*K]).

    The caller applies `bvh.order` to its other per-triangle arrays so
    everything is stored in traversal order.
    """
    order, l_leaves = sorted_order(tri_v, leaf_size)
    valid = order >= 0
    safe = jnp.maximum(order, 0)
    sorted_v = jnp.take(tri_v, safe, axis=0) if tri_v.shape[0] else (
        jnp.zeros((l_leaves * leaf_size, 3, 3), jnp.float32))
    sorted_v = jnp.where(valid[:, None, None], sorted_v, 0.0)
    node_lo, node_hi = fit_nodes(sorted_v, valid, l_leaves, leaf_size)
    return Bvh(node_lo=node_lo, node_hi=node_hi, order=order), sorted_v, valid


# ---------------------------------------------------------------------
# Validation helpers (used by tests; mirror the invariants Embree
# guarantees internally).
# ---------------------------------------------------------------------

def validate(bvh: Bvh, sorted_tri_v: np.ndarray, valid: np.ndarray) -> None:
    node_lo = np.asarray(bvh.node_lo)
    node_hi = np.asarray(bvh.node_hi)
    l_leaves = bvh.num_leaves
    k = bvh.leaf_size
    v = np.asarray(sorted_tri_v)
    val = np.asarray(valid)

    # Every valid triangle is contained in its leaf AABB.
    for leaf in range(l_leaves):
        sl = slice(leaf * k, (leaf + 1) * k)
        if not val[sl].any():
            continue
        tv = v[sl][val[sl]]
        lo = node_lo[l_leaves + leaf]
        hi = node_hi[l_leaves + leaf]
        assert (tv.reshape(-1, 3) >= lo - 1e-4).all(), f"leaf {leaf} lo"
        assert (tv.reshape(-1, 3) <= hi + 1e-4).all(), f"leaf {leaf} hi"

    # Every internal node contains its children.
    for i in range(1, l_leaves):
        for c in (2 * i, 2 * i + 1):
            if (node_lo[c] >= 3.0e37).all():
                continue  # empty child (point-at-infinity box)
            assert (node_lo[i] <= node_lo[c] + 1e-4).all()
            assert (node_hi[i] >= node_hi[c] - 1e-4).all()
