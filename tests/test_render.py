"""End-to-end render tests: BASELINE.json configs, gated at RMSE 2e-3
against the CPU oracle (models/oracle.py oracle_gate, which explains the
bounded FP-flip tail), plus megakernel/wavefront cross-agreement: the
two renderers on the same backend agree to float-accumulation noise,
the non-chaotic version of the estimator-identity claim.
"""

import numpy as np
import pytest

from sycl_ray_tracer_tpu.models.megakernel import render_megakernel
from sycl_ray_tracer_tpu.models.oracle import (FLIP_FRACTION_MAX, RMSE_GATE,
                                               oracle_gate, render_oracle,
                                               rmse)
from sycl_ray_tracer_tpu.models.wavefront import render_wavefront

from sycl_ray_tracer_tpu.utils import fixtures as scenes


def check_oracle_match(img, oracle_img):
    g = oracle_gate(img, oracle_img)
    assert g["ok"], g


def _render_all(glb, width, height, spp, max_depth, seed=0, leaf_size=4):
    scene, host, cam = scenes.load_pair(glb, width, height,
                                        leaf_size=leaf_size)
    m, mrays = render_megakernel(scene, cam, width=width, height=height,
                                 spp=spp, max_depth=max_depth, seed=seed)
    w, wrays = render_wavefront(scene, cam, width=width, height=height,
                                spp=spp, max_depth=max_depth, seed=seed)
    o = render_oracle(host, cam, width=width, height=height, spp=spp,
                      max_depth=max_depth, seed=seed)
    return (np.asarray(m), np.asarray(mrays), np.asarray(w),
            np.asarray(wrays), o)


def test_triangle_1spp_fixed_seed():
    # BASELINE config 1: triangle, megakernel, 256x256, 1 spp, diffuse
    m, mrays, w, wrays, o = _render_all(
        scenes.triangle_scene_glb(), 256, 256, spp=1, max_depth=5)
    check_oracle_match(m, o)
    check_oracle_match(w, o)
    # both engines share the estimator: must agree to float noise
    assert rmse(m, w) < 1e-6
    assert mrays.sum() == wrays.sum()
    # scene actually renders something
    assert m.max() > 0.3 and m.std() > 0.01


def test_cube_multibounce_4spp():
    # BASELINE config 2: diffuse+metallic+emissive, 4 spp, sky env
    m, mrays, w, wrays, o = _render_all(
        scenes.cube_scene_glb(), 96, 96, spp=4, max_depth=8)
    check_oracle_match(m, o)
    check_oracle_match(w, o)
    assert rmse(m, w) < 1e-6
    assert mrays.sum() == wrays.sum()


def test_dielectric_16spp():
    # BASELINE config 3: glass (ior+transmission), 16 spp
    m, mrays, w, wrays, o = _render_all(
        scenes.dielectric_scene_glb(subdiv=1), 64, 64, spp=16, max_depth=12)
    check_oracle_match(m, o)
    check_oracle_match(w, o)
    assert rmse(m, w) < 1e-6


def test_dielectric_russian_roulette():
    # BASELINE config 3 calls for russian-roulette bounces: both
    # engines and the oracle share the RR stream bit-for-bit, and RR
    # must actually kill paths (fewer rays than the plain run).
    glb = scenes.dielectric_scene_glb(subdiv=1)
    scene, host, cam = scenes.load_pair(glb, 64, 64)
    kw = dict(width=64, height=64, spp=16, max_depth=12, seed=0)
    m, mrays = render_megakernel(scene, cam, rr=True, **kw)
    w, wrays = render_wavefront(scene, cam, rr=True, **kw)
    o = render_oracle(host, cam, rr=True, **kw)
    m, w = np.asarray(m), np.asarray(w)
    check_oracle_match(m, o)
    check_oracle_match(w, o)
    assert rmse(m, w) < 1e-6
    assert np.asarray(mrays).sum() == np.asarray(wrays).sum()
    _, mrays_plain = render_megakernel(scene, cam, **kw)
    assert np.asarray(mrays).sum() < np.asarray(mrays_plain).sum()
    # unbiased: same signal as the non-RR estimator within MC noise
    m_plain, _ = render_megakernel(scene, cam, **kw)
    assert abs(m.mean() - np.asarray(m_plain).mean()) < 0.02


def test_textured():
    m, _, w, _, o = _render_all(
        scenes.textured_scene_glb(), 64, 64, spp=4, max_depth=4)
    check_oracle_match(m, o)
    assert rmse(m, w) < 1e-6  # engines agree
    # checker colors visible
    assert m[..., 0].max() > 0.5 and m[..., 2].max() > 0.5


def test_seed_changes_noise_not_signal():
    scene, host, cam = scenes.load_pair(scenes.cube_scene_glb(), 64, 64)
    a, _ = render_megakernel(scene, cam, width=64, height=64, spp=8,
                             max_depth=6, seed=0)
    b, _ = render_megakernel(scene, cam, width=64, height=64, spp=8,
                             max_depth=6, seed=1)
    a, b = np.asarray(a), np.asarray(b)
    assert not np.allclose(a, b)          # different noise
    assert abs(a.mean() - b.mean()) < 0.02  # same signal


def test_determinism():
    scene, host, cam = scenes.load_pair(scenes.triangle_scene_glb(), 32, 32)
    a, _ = render_megakernel(scene, cam, width=32, height=32, spp=2,
                             max_depth=4, seed=7)
    b, _ = render_megakernel(scene, cam, width=32, height=32, spp=2,
                             max_depth=4, seed=7)
    assert (np.asarray(a) == np.asarray(b)).all()


def test_sponza_scale_convergence_gate():
    """BASELINE config 4 analog: Sponza-class scene, wavefront, 64 spp,
    UNTRIMMED RMSE <= 2e-3 against an independent intersector.

    The brute-force oracle cannot afford a 22K-triangle scene, so the
    trustworthy second path is the binary LBVH (ops/lbvh.py +
    ops/traverse.py) — a different tree (implicit binary heap vs
    8-wide SAH/WBVH8), different traversal order, different code path —
    selected via DeviceScene.intersector and sharing ONLY the estimator
    (RNG bits, camera jitter, scatter math, trace_ray.hpp termination
    algebra). Traversal-order tie-breaks decorrelate a bounded set of
    paths (FP-flip note at module top); at 64 spp those flips average
    down and the FULL-image RMSE must clear the 2e-3 budget — the
    untrimmed convergence claim. Fixed seed +
    CPU backend make the measured 1.91e-3 a deterministic pin.
    """
    from sycl_ray_tracer_tpu.utils.procgen import sponza_like_glb

    glb = sponza_like_glb(scale=1)  # same atrium geometry as the
    # 248K-tri benchmark scene (procgen.py), scaled to CPU-CI budget
    s_def, host, cam = scenes.load_pair(glb, 64, 48, leaf_size=8)
    s_lbvh, _, _ = scenes.load_pair(glb, 64, 48, leaf_size=8,
                                    intersector="lbvh")
    assert host.num_triangles > 20_000
    kw = dict(width=64, height=48, spp=64, max_depth=6, seed=0)
    a, a_rays = render_wavefront(s_def, cam, **kw)
    b, b_rays = render_wavefront(s_lbvh, cam, **kw)
    a, b = np.asarray(a), np.asarray(b)
    assert rmse(a, b) < RMSE_GATE, f"untrimmed rmse {rmse(a, b)}"
    # flips bounded: 99% of pixels agree to sub-1% even pre-averaging
    assert np.percentile(np.abs(a - b).max(axis=-1), 99) < 0.02
    # both paths traced comparable work (tie-breaks only)
    ra, rb = int(np.asarray(a_rays).sum()), int(np.asarray(b_rays).sum())
    assert abs(ra - rb) / ra < 0.01
    assert a.std() > 0.05  # actually an image, not a constant


def test_megakernel_sort_bit_identity(monkeypatch):
    """SRT_MK_SORT (the megakernel's per-bounce coherence re-sort,
    megakernel.py _sample_one/resort) is a
    pure lane permutation: key/orig ride along and results scatter back
    by orig, so images and per-bounce ray tallies must be BIT-identical
    to the unsorted megakernel."""
    glb = scenes.cube_scene_glb()
    scene, host, cam = scenes.load_pair(glb, 64, 64)
    kw = dict(width=64, height=64, spp=4, max_depth=8, seed=3)
    # pin both knobs (a sorted default would make the baseline sorted
    # and the comparison vacuous)
    monkeypatch.setenv("SRT_MK_CHUNK", "0")
    monkeypatch.setenv("SRT_MK_SORT", "0")
    base, base_rays = render_megakernel(scene, cam, **kw)
    monkeypatch.setenv("SRT_MK_SORT", "1")
    srt, srt_rays = render_megakernel(scene, cam, **kw)
    assert (np.asarray(base) == np.asarray(srt)).all()
    assert (np.asarray(base_rays) == np.asarray(srt_rays)).all()
    monkeypatch.setenv("SRT_MK_SORT", "3")  # every-3rd-bounce cadence
    srt3, srt3_rays = render_megakernel(scene, cam, **kw)
    assert (np.asarray(base) == np.asarray(srt3)).all()
    assert (np.asarray(base_rays) == np.asarray(srt3_rays)).all()


def test_megakernel_chunked_bit_identity(monkeypatch):
    """SRT_MK_CHUNK=k (bounce-chunked megakernel): k fused bounce
    iterations per device program with the queue shrunk to the live-count bucket between programs — the
    engine's answer to its static-shape depth decay (megakernel.py
    _chunked_wave). Estimator-exactness claim: chunking is
    only (a) the same permutation stream as the in-program re-sort,
    re-bracketed after each step, and (b) per-lane result slots
    scatter-SET by the riding global id — so images AND per-bounce ray
    tallies must be BIT-identical to the unchunked engine, at every
    chunk size, sorted or not. The shrink path must actually run (a
    no-shrink pass would vacuously pass the equality)."""
    from sycl_ray_tracer_tpu.models import megakernel as mk

    glb = scenes.cube_scene_glb()
    scene, host, cam = scenes.load_pair(glb, 128, 96)
    # 8 spp x 12288 px = 98304-lane wave, above the 64K bucket floor so
    # inter-chunk shrinks are reachable (bucket_of floor_bits=16)
    kw = dict(width=128, height=96, spp=8, max_depth=9, seed=5)
    # pin the baseline explicitly: delenv would resolve to the
    # defaults, which a later cadence choice may make chunked
    monkeypatch.setenv("SRT_MK_SORT", "0")
    monkeypatch.setenv("SRT_MK_CHUNK", "0")
    base, base_rays = render_megakernel(scene, cam, **kw)

    widths = []
    real_next = mk._chunk_next

    def spy(scene_, q, *a, **k):
        widths.append(q[0].shape[0])
        return real_next(scene_, q, *a, **k)

    monkeypatch.setattr(mk, "_chunk_next", spy)
    monkeypatch.setenv("SRT_MK_SORT", "1")
    for chunk, sort in ((3, "1"), (2, "0"), (20, "1")):
        monkeypatch.setenv("SRT_MK_CHUNK", str(chunk))
        monkeypatch.setenv("SRT_MK_SORT", sort)
        img, rays = render_megakernel(scene, cam, **kw)
        assert (np.asarray(base) == np.asarray(img)).all(), (chunk, sort)
        assert (np.asarray(base_rays) == np.asarray(rays)).all()
    assert widths and min(widths) < 8 * 128 * 96, \
        "inter-chunk queue shrink never exercised"


def test_megakernel_chunked_sentinel_key_and_depth0(monkeypatch):
    """Two chunked-engine edges from the round-3 review:

    (a) a live lane whose raw coherence key equals the dead-lane
    sentinel 0xFFFFFFFF (reachable under cell_oct_morton at the
    scene_hi corner) must never be dropped by the inter-chunk bucket
    shrink — _compact clamps kept keys to 0xFFFFFFFE. Forced here by
    monkeypatching the key to all-ones for every lane.

    (b) max_depth=0 must render black with zero rays through the
    chunked entry point too (the reference's bounce loop never runs);
    the driver routes d0 to the plain engine."""
    import jax.numpy as jnp

    from sycl_ray_tracer_tpu.models import wavefront as wf

    glb = scenes.cube_scene_glb()
    scene, host, cam = scenes.load_pair(glb, 128, 96)
    kw = dict(width=128, height=96, spp=8, max_depth=9, seed=5)
    monkeypatch.setenv("SRT_MK_SORT", "0")
    monkeypatch.setenv("SRT_MK_CHUNK", "0")
    base, base_rays = render_megakernel(scene, cam, **kw)

    real_key = wf._coherence_key

    def all_ones_key(scene_, o, d, hit_tri=None):
        k = real_key(scene_, o, d, hit_tri=hit_tri)
        return None if k is None else jnp.full_like(k, 0xFFFFFFFF)

    monkeypatch.setattr(wf, "_coherence_key", all_ones_key)
    monkeypatch.setenv("SRT_MK_CHUNK", "3")
    img, rays = render_megakernel(scene, cam, **kw)
    assert (np.asarray(base) == np.asarray(img)).all(), \
        "sentinel-key live lane lost through the inter-chunk shrink"
    assert (np.asarray(base_rays) == np.asarray(rays)).all()

    monkeypatch.setattr(wf, "_coherence_key", real_key)
    kw0 = dict(kw, max_depth=0)
    monkeypatch.setenv("SRT_MK_CHUNK", "6")
    img0, rays0 = render_megakernel(scene, cam, **kw0)
    assert (np.asarray(img0) == 0).all()
    assert np.asarray(rays0).size == 0 or (np.asarray(rays0) == 0).all()


def test_f16_queue_payload(monkeypatch):
    """SRT_F16_QUEUE carries dir/att/radiance as packed halves through
    the wavefront queue — the reference's fp16 RayData quirk
    (camera.hpp:12-63). The per-bounce f32->f16->f32 round-trip
    perturbs the estimator; the full-image error must stay inside the
    2e-3 RMSE budget (same budget the oracle gate uses)."""
    from sycl_ray_tracer_tpu.models import wavefront as wf

    # unit: pack/unpack round-trips f16-representable values exactly
    import jax.numpy as jnp
    a = jnp.asarray(np.float16([0.5, -1.25, 0.1, 65504.0]
                               ).astype(np.float32))
    b = jnp.asarray(np.float16([1.0, 0.0, -3.5, 2.0 ** -14]
                               ).astype(np.float32))
    pa, pb = wf._unpack_f16_pair(wf._pack_f16_pair(a, b))
    assert (np.asarray(pa) == np.asarray(a)).all()
    assert (np.asarray(pb) == np.asarray(b)).all()

    glb = scenes.cube_scene_glb()
    scene, host, cam = scenes.load_pair(glb, 96, 96)
    kw = dict(width=96, height=96, spp=8, max_depth=8, seed=2)
    base, base_rays = render_wavefront(scene, cam, **kw)
    monkeypatch.setenv("SRT_F16_QUEUE", "1")
    half, half_rays = render_wavefront(scene, cam, **kw)
    base, half = np.asarray(base), np.asarray(half)
    assert not (base == half).all()  # the flag actually does something
    g = oracle_gate(half, base)
    assert (g["flip_fraction"] < FLIP_FRACTION_MAX
            and g["trimmed"] < RMSE_GATE), g


def test_bvh_vs_brute_renderer_paths():
    # leaf_size=1 forces deeper trees; cross-check engines still agree
    glb = scenes.dielectric_scene_glb(subdiv=0)
    s1, host, cam = scenes.load_pair(glb, 48, 48, leaf_size=1)
    s4, _, _ = scenes.load_pair(glb, 48, 48, leaf_size=8)
    a, _ = render_megakernel(s1, cam, width=48, height=48, spp=2,
                             max_depth=6, seed=3)
    b, _ = render_megakernel(s4, cam, width=48, height=48, spp=2,
                             max_depth=6, seed=3)
    assert rmse(np.asarray(a), np.asarray(b)) < 1e-6


def test_scatter_terminated_segment():
    """wavefront._scatter_terminated: adds exactly the [lo, hi) rows,
    regardless of bucket clamping of the slice origin."""
    import jax.numpy as jnp

    from sycl_ray_tracer_tpu.models.wavefront import _scatter_terminated

    n = 16          # pixels
    cap = 64        # bucket
    rng = np.random.default_rng(5)
    q_id = jnp.asarray(rng.integers(0, 48, cap, dtype=np.int32))
    cx = jnp.asarray(rng.random(cap, dtype=np.float32))
    cy = jnp.asarray(rng.random(cap, dtype=np.float32))
    cz = jnp.asarray(rng.random(cap, dtype=np.float32))

    for lo, hi, seg in [(10, 25, 16), (0, 0, 16), (60, 64, 16),
                        (0, 64, 64)]:
        start = min(lo, cap - seg)
        acc = jnp.ones((n, 3), jnp.float32)
        out = np.asarray(_scatter_terminated(
            acc, q_id, cx, cy, cz, start, lo, hi, seg=seg))
        ref = np.ones((n, 3), np.float32)
        qs = np.asarray(q_id)
        for r in range(lo, hi):
            ref[qs[r] % n] += np.asarray(
                [cx[r], cy[r], cz[r]], np.float32)
        assert np.allclose(out, ref, atol=1e-5), (lo, hi, seg)


def test_wave_threads_bit_identity(monkeypatch):
    """SRT_WAVE_THREADS (default 2): both engines' host wave loops may
    drive independent waves from concurrent threads to overlap one
    wave's per-bounce readback with the other's programs.
    Claim: interleaving is pure scheduling — each wave's device
    programs are unchanged and per-wave accumulators are summed in
    wave order — so images and ray tallies must be BIT-identical to
    the serial loop, for both engines. Forces 4 waves (wave cap = 2
    samples) so the thread pool actually interleaves."""
    glb = scenes.cube_scene_glb()
    scene, host, cam = scenes.load_pair(glb, 64, 64)
    kw = dict(width=64, height=64, spp=8, max_depth=6, seed=3)
    monkeypatch.setenv("SRT_WAVE_RAYS", str(2 * 64 * 64))
    monkeypatch.setenv("SRT_MK_CHUNK", "2")  # exercise the chunked path
    for render in (render_wavefront, render_megakernel):
        monkeypatch.setenv("SRT_WAVE_THREADS", "1")
        base, base_rays = render(scene, cam, **kw)
        monkeypatch.setenv("SRT_WAVE_THREADS", "3")
        thr, thr_rays = render(scene, cam, **kw)
        assert (np.asarray(base) == np.asarray(thr)).all(), render
        assert (np.asarray(base_rays) == np.asarray(thr_rays)).all()
