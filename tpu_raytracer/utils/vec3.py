"""Component-major 3-vectors for the wavefront hot path.

A row-major ``[R, 3]`` f32 array has a minor dim of 3, which layouts tiled
for wide vector units pad many times over. The bounce-loop wavefront
therefore carries vectors as three dense ``[R]`` component arrays. ``V3`` is a NamedTuple (hence a JAX pytree): it flows
through ``lax.while_loop`` carries, ``jnp.where`` helpers below, and
arithmetic operators without ever materializing a padded array.

The helpers mirror ``utils/math3d`` expression-for-expression (same
operation order per element); results match math3d's array forms up to
XLA reduce-order ulps on dot products (XLA reduces ``jnp.sum(a*b, -1)``
in an implementation-defined order; here it is ``(x+y)+z``).

The reference's WGSL vector ops (dot/cross/normalize/reflect/refract,
restir.wgsl) map 1:1 onto these helpers.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

EPS = 1e-6  # math3d.EPS


class V3(NamedTuple):
    """Three [R]-shaped (or scalar) component arrays; a JAX pytree."""

    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray

    # -- elementwise arithmetic (V3 <op> V3, or V3 <op> [R]/scalar) --
    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

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

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, V3):
            return V3(self.x / o.x, self.y / o.y, self.z / o.z)
        return V3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)


def of(a) -> V3:
    """[..., 3] array -> V3 of [...] components."""
    return V3(a[..., 0], a[..., 1], a[..., 2])


def arr(v: V3):
    """V3 -> [..., 3] array (boundary use only - materializes padded rows)."""
    return jnp.stack([v.x, v.y, v.z], axis=-1)


def from_rows(rows, i: int) -> V3:
    """Columns i..i+2 of a gathered [R, C] row table -> V3 of dense [R]s."""
    return V3(rows[:, i], rows[:, i + 1], rows[:, i + 2])


def splat(c, like) -> V3:
    """Scalar constant -> V3 broadcast against a reference [R] array."""
    return V3(jnp.full_like(like, c), jnp.full_like(like, c),
              jnp.full_like(like, c))


def dot(a: V3, b: V3):
    return (a.x * b.x + a.y * b.y) + a.z * b.z


def cross(a: V3, b: V3) -> V3:
    return V3(a.y * b.z - a.z * b.y,
              a.z * b.x - a.x * b.z,
              a.x * b.y - a.y * b.x)


def length(v: V3):
    return jnp.sqrt(jnp.maximum(dot(v, v), 0.0))


def normalize(v: V3) -> V3:
    return v / jnp.maximum(length(v), EPS)


def reflect(v: V3, n: V3) -> V3:
    """WGSL reflect: v - 2*dot(v,n)*n (math3d.reflect order)."""
    return v - n * (2.0 * dot(v, n))


def refract(v: V3, n: V3, eta) -> V3:
    """WGSL refract; zero vector on total internal reflection."""
    cos_i = -dot(v, n)
    sin2_t = eta * eta * (1.0 - cos_i * cos_i)
    k = 1.0 - sin2_t
    tir = k < 0.0
    k = jnp.maximum(k, 0.0)
    out = v * eta + n * (eta * cos_i - jnp.sqrt(k))
    return where(tir, 0.0, out)


def where(m, a, b) -> V3:
    """jnp.where(mask[:, None], A, B) for V3/scalar operands."""
    ax, ay, az = (a.x, a.y, a.z) if isinstance(a, V3) else (a, a, a)
    bx, by, bz = (b.x, b.y, b.z) if isinstance(b, V3) else (b, b, b)
    return V3(jnp.where(m, ax, bx), jnp.where(m, ay, by),
              jnp.where(m, az, bz))


def luminance(c: V3):
    """Rec. 709 luminance (restir.wgsl:742-744; math3d.luminance order)."""
    return c.x * 0.2126 + c.y * 0.7152 + c.z * 0.0722


def vmax(v: V3):
    """max over components (jnp.max(axis=-1); exact - max is associative)."""
    return jnp.maximum(jnp.maximum(v.x, v.y), v.z)


def all_leq_zero(v: V3):
    """jnp.all(v <= 0, axis=-1)."""
    return (v.x <= 0.0) & (v.y <= 0.0) & (v.z <= 0.0)


def oct_decode(ex, ey) -> V3:
    """math3d.oct_decode on two [R] components."""
    nz = 1.0 - jnp.abs(ex) - jnp.abs(ey)
    t = jnp.maximum(-nz, 0.0)
    nx = ex + jnp.where(ex >= 0.0, -t, t)
    ny = ey + jnp.where(ey >= 0.0, -t, t)
    return normalize(V3(nx, ny, nz))


def oct_encode(n: V3):
    """math3d.oct_encode -> (ex, ey) [R] components."""
    l1 = jnp.maximum(jnp.abs(n.x) + jnp.abs(n.y) + jnp.abs(n.z), EPS)
    rx = n.x / l1
    ry = n.y / l1
    sign_x = jnp.where(rx >= 0.0, 1.0, -1.0)
    sign_y = jnp.where(ry >= 0.0, 1.0, -1.0)
    fold = n.z < 0.0
    ex = jnp.where(fold, (1.0 - jnp.abs(ry)) * sign_x, rx)
    ey = jnp.where(fold, (1.0 - jnp.abs(rx)) * sign_y, ry)
    return ex, ey


def orthonormal_basis(n: V3):
    """Branchless ONB (restir.wgsl:161-168; math3d.orthonormal_basis)."""
    sign = jnp.where(n.z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n.z)
    b = n.x * n.y * a
    tangent = V3(1.0 + sign * n.x * n.x * a, sign * b, -sign * n.x)
    bitangent = V3(b, sign + n.y * n.y * a, -n.y)
    return tangent, bitangent


def to_world(tangent: V3, bitangent: V3, n: V3, v_local: V3) -> V3:
    return tangent * v_local.x + bitangent * v_local.y + n * v_local.z


def to_local(tangent: V3, bitangent: V3, n: V3, v_world: V3) -> V3:
    return V3(dot(v_world, tangent), dot(v_world, bitangent),
              dot(v_world, n))
