"""Vector / matrix math for the ray tracer.

Everything here is pure jnp, shape-polymorphic over leading batch dims, and
jittable.  Conventions follow the reference renderer's host math (glam,
column-vector convention: ``M @ v``) so camera matrices and ray generation
reproduce the reference semantics exactly.

Reference parity notes (see /root/reference):
  - octahedral codec:  src/shaders/gbuffer.wgsl:38-62, src/geometry.rs:56-76
  - branchless ONB:    src/shaders/restir.wgsl:161-168
  - luminance:         src/shaders/restir.wgsl:742-744
  - perspective/look_at: glam's `Mat4::perspective_rh` / `Mat4::look_at_rh`
    as used in src/camera.rs:218-219 (wgpu 0..1 depth convention).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

EPS = 1e-6


# ---------------------------------------------------------------------------
# Basic vector ops (batched over leading dims; vectors live in the last dim)
# ---------------------------------------------------------------------------

def dot(a, b, keepdims: bool = False):
    return jnp.sum(a * b, axis=-1, keepdims=keepdims)


def length(v, keepdims: bool = False):
    return jnp.sqrt(jnp.maximum(dot(v, v, keepdims=keepdims), 0.0))


def normalize(v):
    return v / jnp.maximum(length(v, keepdims=True), EPS)


def cross(a, b):
    return jnp.cross(a, b)


def reflect(v, n):
    """Mirror ``v`` about plane with normal ``n`` (WGSL `reflect` semantics)."""
    return v - 2.0 * dot(v, n, keepdims=True) * n


def refract(v, n, eta):
    """WGSL `refract(I, N, eta)`: refract incident ``v`` at normal ``n``.

    Returns zero vector where total internal reflection occurs (same as WGSL).
    ``eta`` may be a scalar or broadcastable array of shape [..., 1] or [...].
    """
    eta = jnp.asarray(eta)
    if eta.ndim == v.ndim - 1:
        eta = eta[..., None]
    cos_i = -dot(v, n, keepdims=True)
    sin2_t = eta * eta * (1.0 - cos_i * cos_i)
    k = 1.0 - sin2_t
    tir = k < 0.0
    k = jnp.maximum(k, 0.0)
    out = eta * v + (eta * cos_i - jnp.sqrt(k)) * n
    return jnp.where(tir, 0.0, out)


def luminance(c):
    """Rec. 709 luminance (restir.wgsl:742-744)."""
    return c[..., 0] * 0.2126 + c[..., 1] * 0.7152 + c[..., 2] * 0.0722


# ---------------------------------------------------------------------------
# Octahedral normal codec (gbuffer.wgsl:38-62 / geometry.rs:56-76)
# ---------------------------------------------------------------------------

def oct_encode(n):
    """Encode unit vectors [..., 3] -> [..., 2] octahedral coordinates."""
    l1 = jnp.abs(n[..., 0]) + jnp.abs(n[..., 1]) + jnp.abs(n[..., 2])
    l1 = jnp.maximum(l1, EPS)
    res = n[..., :2] / l1[..., None]
    x, y = res[..., 0], res[..., 1]
    sign_x = jnp.where(x >= 0.0, 1.0, -1.0)
    sign_y = jnp.where(y >= 0.0, 1.0, -1.0)
    folded = jnp.stack([(1.0 - jnp.abs(y)) * sign_x, (1.0 - jnp.abs(x)) * sign_y], axis=-1)
    return jnp.where((n[..., 2] < 0.0)[..., None], folded, res)


def oct_decode(e):
    """Decode [..., 2] octahedral coordinates -> unit vectors [..., 3]."""
    ex, ey = e[..., 0], e[..., 1]
    nz = 1.0 - jnp.abs(ex) - jnp.abs(ey)
    t = jnp.maximum(-nz, 0.0)
    nx = ex + jnp.where(ex >= 0.0, -t, t)
    ny = ey + jnp.where(ey >= 0.0, -t, t)
    n = jnp.stack([nx, ny, nz], axis=-1)
    return normalize(n)


# ---------------------------------------------------------------------------
# Branchless orthonormal basis (restir.wgsl:161-168, Duff et al.)
# ---------------------------------------------------------------------------

def orthonormal_basis(n):
    """Return (tangent, bitangent) for unit normals ``n`` [..., 3]."""
    sign = jnp.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    tangent = jnp.stack(
        [1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b, -sign * n[..., 0]], axis=-1
    )
    bitangent = jnp.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], axis=-1)
    return tangent, bitangent


def to_world(tangent, bitangent, n, v_local):
    """Transform local-space vectors (z = n) to world space."""
    return (
        tangent * v_local[..., 0:1]
        + bitangent * v_local[..., 1:2]
        + n * v_local[..., 2:3]
    )


def to_local(tangent, bitangent, n, v_world):
    return jnp.stack(
        [dot(v_world, tangent), dot(v_world, bitangent), dot(v_world, n)], axis=-1
    )


# ---------------------------------------------------------------------------
# 4x4 matrices (host-side numpy; row-major, column-vector convention M @ v)
# ---------------------------------------------------------------------------

def perspective_rh(fov_y: float, aspect: float, z_near: float, z_far: float) -> np.ndarray:
    """glam `Mat4::perspective_rh` (right-handed, 0..1 depth) as row-major."""
    f = 1.0 / np.tan(fov_y / 2.0)
    r = z_far / (z_near - z_far)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = r
    m[2, 3] = r * z_near
    m[3, 2] = -1.0
    return m


def look_at_rh(eye, center, up) -> np.ndarray:
    """glam `Mat4::look_at_rh` as row-major."""
    eye = np.asarray(eye, dtype=np.float32)
    center = np.asarray(center, dtype=np.float32)
    up = np.asarray(up, dtype=np.float32)
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


def translation(t) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = np.asarray(t, dtype=np.float32)
    return m


def scale(s) -> np.ndarray:
    s = np.asarray(s, dtype=np.float32)
    if s.ndim == 0:
        s = np.array([s, s, s], dtype=np.float32)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[1, 1], m[2, 2] = s
    return m


def rotation_x(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    m = np.eye(4, dtype=np.float32)
    m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
    return m


def rotation_y(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    return m


def rotation_z(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 1], m[1, 0], m[1, 1] = c, -s, s, c
    return m


def transform_point(m: np.ndarray, p):
    p = np.asarray(p, dtype=np.float32)
    out = m[:3, :3] @ p + m[:3, 3]
    return out


def transform_vector(m: np.ndarray, v):
    v = np.asarray(v, dtype=np.float32)
    return m[:3, :3] @ v


def hsv_to_rgb(h: float, s: float, v: float):
    """Matches scenes.rs:226-246 exactly (sector-based)."""
    c = v * s
    x = c * (1.0 - abs((h * 6.0) % 2.0 - 1.0))
    m = v - c
    if h < 1.0 / 6.0:
        r, g, b = c, x, 0.0
    elif h < 2.0 / 6.0:
        r, g, b = x, c, 0.0
    elif h < 3.0 / 6.0:
        r, g, b = 0.0, c, x
    elif h < 4.0 / 6.0:
        r, g, b = 0.0, x, c
    elif h < 5.0 / 6.0:
        r, g, b = x, 0.0, c
    else:
        r, g, b = c, 0.0, x
    return [r + m, g + m, b + m]
