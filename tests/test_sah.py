"""Native binned-SAH BVH8 build (host code kept for a walk over the
SAH tree): structural invariants of the object-split, wide-node and
spatial-split builds."""

import numpy as np
import pytest

from sycl_ray_tracer_tpu.ops import sah

pytestmark = pytest.mark.skipif(
    not sah.available(),
    reason="native bvh library not built (no compiler?)")


def _random_tris(rs, n, spread=5.0, size=0.3):
    c = rs.uniform(-spread, spread, (n, 3)).astype(np.float32)
    return c[:, None, :] + rs.uniform(-size, size, (n, 3, 3)).astype(
        np.float32)


def test_sah_invariants(rs):
    tri = _random_tris(rs, 3000)
    b = sah.build_sah(tri, 8)
    sah.validate(b, tri)
    assert b.depth >= 2
    # ids in range
    assert (b.child_ids >= 0).all()
    assert (b.child_ids < b.num_internal + b.num_leaves).all()


def test_sah_single_leaf(rs):
    tri = _random_tris(rs, 5)
    b = sah.build_sah(tri, 8)
    sah.validate(b, tri)
    assert b.num_leaves == 1


def test_sah_width_collapse(rs):
    """Probe-only wide-node fanouts (srt_bvh_build3, W != 8) must obey
    the same containment invariants, and — since the DP collapse only
    re-partitions the binary tree — produce the SAME leaf set as W=8
    (leaves are immutable under the collapse; only internal grouping
    changes)."""
    tri = _random_tris(rs, 4000)
    k = 8

    def leaf_set(b):
        rows = b.order.reshape(-1, k)
        return {frozenset(int(t) for t in r if t >= 0) for r in rows
                if (r >= 0).any()}

    b8 = sah.build_sah(tri, k, spatial=False, width=8)
    ref = leaf_set(b8)
    for w in (12, 16):
        b = sah.build_sah(tri, k, spatial=False, width=w)
        if b is None:
            pytest.skip("library lacks srt_bvh_build3")
        sah.validate(b, tri)
        assert b.width == w
        assert b.children.shape[1] == 6 * w
        assert b.child_ids.shape[1] == w
        assert b.num_internal < b8.num_internal  # fatter nodes
        assert leaf_set(b) == ref


def test_sbvh_spatial_splits_parity(rs):
    """SBVH (spatial=True) duplicates clipped references; the split tree
    must still reach every triangle and keep its boxes nested. Scene
    mixes small tris with large straddling ones so splits fire."""
    small = _random_tris(rs, 1200)
    big = (rs.uniform(-5, 5, (80, 3, 3)) * 2.0).astype(np.float32)
    tri = np.concatenate([small, big]).astype(np.float32)
    k = 8
    b = sah.build_sah(tri, k, spatial=True)
    sah.validate(b, tri)
    assert b.num_refs > tri.shape[0], "no spatial split fired"
    # duplicated ids present but every triangle still reachable
    seen = b.order[b.order >= 0]
    assert len(np.unique(seen)) == tri.shape[0]
