"""Counter-based parallel RNG.

The reference keeps a *stateful* xorshift32 per pixel (xorshift.hpp:8-49)
with a persistent per-pixel state buffer in the wavefront renderer
(render_wavefront.cpp:48-77) and in-kernel hash seeding in the megakernel
(render_megakernel.cpp:144-146). Stateful RNG is a poor fit for a traced,
functional compiler: it serializes draws and forces a carried buffer.

Replacement: a *counter-based* generator. Every draw is a pure function
``u32 = mix(key, counter)``; lanes never share state, draws are
data-parallel, and the same bits are reproduced by the numpy oracle and
the jitted renderers, which makes fixed-seed golden tests exact across
backends.

The mixer is Jarzynski & Olano's ``pcg3d``-style integer hash reduced to
2 inputs (a.k.a. pcg2d), a well-studied GPU hash with good statistical
quality for Monte-Carlo rendering ("Hash Functions for GPU Rendering",
JCGT 2020 — public algorithm, reimplemented here from the description).

Both a jnp and a numpy implementation are provided; they are bit-exact
(verified in tests/test_rng.py).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

_U32 = np.uint32
# Multiplier from the PCG family (Melissa O'Neill's PCG, public domain).
_PCG_MULT = 747796405


def _pcg2d_jnp(a: jnp.ndarray, b: jnp.ndarray):
    a = a.astype(jnp.uint32)
    b = b.astype(jnp.uint32)
    mult = jnp.uint32(1664525)
    # Golden-ratio increments kill the all-zero fixed point (the analog
    # of the reference's xorshift pixel-0 quirk, render_wavefront.cpp:71).
    a = a * mult + jnp.uint32(0x9E3779B9)
    b = b * mult + jnp.uint32(0x85EBCA6B)
    a = a + b * mult
    b = b + a * mult
    a = a ^ (a >> 16)
    b = b ^ (b >> 16)
    a = a + b * mult
    b = b + a * mult
    a = a ^ (a >> 16)
    b = b ^ (b >> 16)
    return a, b


def _pcg2d_np(a: np.ndarray, b: np.ndarray):
    with np.errstate(over="ignore"):
        a = a.astype(_U32)
        b = b.astype(_U32)
        mult = _U32(1664525)
        a = a * mult + _U32(0x9E3779B9)
        b = b * mult + _U32(0x85EBCA6B)
        a = (a + b * mult).astype(_U32)
        b = (b + a * mult).astype(_U32)
        a = a ^ (a >> _U32(16))
        b = b ^ (b >> _U32(16))
        a = (a + b * mult).astype(_U32)
        b = (b + a * mult).astype(_U32)
        a = a ^ (a >> _U32(16))
        b = b ^ (b >> _U32(16))
    return a, b


def make_key(seed, lane):
    """Derive a per-lane key from (global seed, lane index).

    `lane` is typically the linear pixel/ray id; `seed` folds in the
    sample index so every (pixel, sample) pair gets an independent
    stream — the functional analog of the reference's
    hash(global_linear_id) seeding (render_megakernel.cpp:144-146).
    """
    a, b = _pcg2d_jnp(jnp.asarray(seed, jnp.uint32), jnp.asarray(lane, jnp.uint32))
    return a ^ (b * jnp.uint32(_PCG_MULT))


def make_key_np(seed, lane):
    a, b = _pcg2d_np(np.asarray(seed, _U32), np.asarray(lane, _U32))
    with np.errstate(over="ignore"):
        return a ^ (b * _U32(_PCG_MULT))


def _bits_to_unit_float_jnp(bits: jnp.ndarray) -> jnp.ndarray:
    # Top 24 bits -> [0, 1) exactly representable in f32.
    return (bits >> jnp.uint32(8)).astype(jnp.float32) * jnp.float32(2.0 ** -24)


def _bits_to_unit_float_np(bits: np.ndarray) -> np.ndarray:
    return (bits >> _U32(8)).astype(np.float32) * np.float32(2.0 ** -24)


def uniform(key, counter):
    """One uniform f32 in [0,1) per lane. counter is a small int (draw #)."""
    a, _ = _pcg2d_jnp(key, jnp.asarray(counter, jnp.uint32))
    return _bits_to_unit_float_jnp(a)


def uniform_np(key, counter):
    a, _ = _pcg2d_np(np.asarray(key, _U32), np.asarray(counter, _U32))
    return _bits_to_unit_float_np(a)


def uniform3(key, counter):
    """Three uniforms per lane from ONE counter: both pcg2d outputs at
    (key, counter) plus the first output at (key ^ golden, counter).

    NOTE: the first return value is bit-identical to
    uniform(key, counter) — do NOT mix uniform3(key, c) with
    uniform(key, c)/uniform(key, c+1) draws expecting independence;
    spread additional draws with a distinct counter offset instead
    (materials.py uses +0x55555555, trace.py +0x33333333)."""
    key = jnp.asarray(key, jnp.uint32)
    c = jnp.asarray(counter, jnp.uint32)
    a0, b0 = _pcg2d_jnp(key, c)
    a1, _ = _pcg2d_jnp(key ^ jnp.uint32(0x9E3779B9), c)
    return (
        _bits_to_unit_float_jnp(a0),
        _bits_to_unit_float_jnp(b0),
        _bits_to_unit_float_jnp(a1),
    )


def uniform3_np(key, counter):
    key = np.asarray(key, _U32)
    c = np.asarray(counter, _U32)
    a0, b0 = _pcg2d_np(key, c)
    with np.errstate(over="ignore"):
        a1, _ = _pcg2d_np(key ^ _U32(0x9E3779B9), c)
    return (
        _bits_to_unit_float_np(a0),
        _bits_to_unit_float_np(b0),
        _bits_to_unit_float_np(a1),
    )
