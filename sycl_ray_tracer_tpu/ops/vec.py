"""Structure-of-arrays 3-vector math.

Design note: vectors are carried as three separate full-width arrays
(``V3``) rather than with a trailing length-3 axis, so every
elementwise op runs over whole [R] arrays. Scene storage
uses ``[N, 3]`` float32 (contiguous rows gather well); unpack to ``V3``
right after any gather.

Behavioral parity targets (reference, /root/reference):
- reflect/refract/near_zero: src/util.hpp:103-125
- linear_to_gamma = sqrt:    src/util.hpp:82-101
"""

from __future__ import annotations

from typing import NamedTuple, Union

import jax
import jax.numpy as jnp

Scalar = Union[float, jnp.ndarray]


class V3(NamedTuple):
    """Three same-shaped arrays acting as one vector field."""

    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray

    # -- arithmetic ---------------------------------------------------
    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    def __radd__(self, o):
        return self.__add__(o)

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return V3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    def __rmul__(self, o):
        return self.__mul__(o)

    def __truediv__(self, o):
        if isinstance(o, V3):
            return V3(self.x / o.x, self.y / o.y, self.z / o.z)
        return V3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    # -- helpers ------------------------------------------------------
    def astype(self, dt):
        return V3(self.x.astype(dt), self.y.astype(dt), self.z.astype(dt))

    def stack(self, axis: int = -1) -> jnp.ndarray:
        return jnp.stack([self.x, self.y, self.z], axis=axis)


def v3(x: Scalar, y: Scalar, z: Scalar) -> V3:
    return V3(jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32),
              jnp.asarray(z, jnp.float32))


def splat(c, shape=()) -> V3:
    """Broadcast a python/np length-3 constant to a V3 of `shape` arrays."""
    return V3(
        jnp.full(shape, c[0], jnp.float32),
        jnp.full(shape, c[1], jnp.float32),
        jnp.full(shape, c[2], jnp.float32),
    )


def from_rows(a: jnp.ndarray) -> V3:
    """[..., 3] array -> V3."""
    return V3(a[..., 0], a[..., 1], a[..., 2])


def dot(a: V3, b: V3) -> jnp.ndarray:
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: V3, b: V3) -> V3:
    return V3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def length(a: V3) -> jnp.ndarray:
    return jnp.sqrt(dot(a, a))


def length_squared(a: V3) -> jnp.ndarray:
    return dot(a, a)


def normalize(a: V3, eps: float = 0.0) -> V3:
    # rsqrt keeps this a single VPU op chain; eps guards the zero vector
    # only where callers ask for it.
    inv = jax.lax.rsqrt(dot(a, a) + eps)
    return a * inv


def where(mask: jnp.ndarray, a: V3, b: V3) -> V3:
    return V3(
        jnp.where(mask, a.x, b.x),
        jnp.where(mask, a.y, b.y),
        jnp.where(mask, a.z, b.z),
    )


def select_gather(table: jnp.ndarray, idx: jnp.ndarray) -> V3:
    """Gather rows of an [N, 3] table by integer index -> V3."""
    g = jnp.take(table, idx, axis=0)
    return from_rows(g)


def reflect(v: V3, n: V3) -> V3:
    """v - 2*dot(v,n)*n  (ref: util.hpp:114-116)."""
    return v - n * (2.0 * dot(v, n))


def refract(uv: V3, n: V3, etai_over_etat: jnp.ndarray) -> V3:
    """Snell refraction (ref: util.hpp:118-125)."""
    cos_theta = jnp.minimum(dot(-uv, n), 1.0)
    r_out_perp = (uv + n * cos_theta) * etai_over_etat
    r_out_parallel = -jnp.sqrt(jnp.abs(1.0 - length_squared(r_out_perp)))
    return r_out_perp + n * r_out_parallel


def near_zero(v: V3, s: float = 1e-8) -> jnp.ndarray:
    """True where |v| < s componentwise (ref: util.hpp:103-107)."""
    return (jnp.abs(v.x) < s) & (jnp.abs(v.y) < s) & (jnp.abs(v.z) < s)


def linear_to_gamma(c: jnp.ndarray) -> jnp.ndarray:
    """sqrt gamma, clamped at 0 (ref: util.hpp:82-92)."""
    return jnp.sqrt(jnp.maximum(c, 0.0))
