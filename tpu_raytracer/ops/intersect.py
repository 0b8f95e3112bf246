"""Ray-primitive intersection kernels (vectorized jnp).

Replaces the reference's hardware `ray_query` (gbuffer.wgsl:108-112,
restir.wgsl:601-607) with explicit math:
  - Moller-Trumbore ray/triangle (watertight enough for the scenes at hand)
  - AABB slab test (for BVH traversal)

All functions are batched: rays [..., 3], triangles broadcastable against
rays. Misses are reported as ``t = inf``.

Also here: the packed triangle layout the swept intersectors read
(`pack_triangles`, `pack_triangles_instanced`): 4 planes of shape
[3, Tp] - v0, e1, e2 and a validity row (1.0 real, 0.0 padding) - with
Tp padded to a multiple of CT so every chunk is whole.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

INF = np.float32(3.0e38)
_MT_EPS = 1e-9
CT = 128        # triangle padding granule of the packed planes
INST_GRP = 2    # CT-chunks per (instance, group) unit of the instanced scan


def _planes(v0, e1, e2, tp):
    t = v0.shape[0]
    planes = np.zeros((4, 3, tp), np.float32)
    planes[0, :, :t] = v0.T
    planes[1, :, :t] = e1.T
    planes[2, :, :t] = e2.T
    planes[3, 0, :t] = 1.0
    return planes


def pack_triangles(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray):
    """[T, 3] v0 / e1 / e2 -> tri_planes [4, 3, Tp], Tp = T padded to CT
    (at least one chunk). Padding triangles are all-zero: det 0, invalid."""
    t = v0.shape[0]
    return _planes(v0, e1, e2, max(-(-t // CT) * CT, CT))


def pack_triangles_instanced(mesh_tris, grp: int = INST_GRP):
    """Per-mesh object-space packing for the two-level instanced scan.

    mesh_tris: list of (v0 [t,3], e1, e2) per mesh. Each mesh is padded to
    a multiple of grp*CT triangles so no (instance, group) unit spans two
    meshes. Returns (planes [4, 3, TpO], spans [2, NMesh] i32 = (first
    group, group count) per mesh).
    """
    unit = grp * CT
    planes_list, spans = [], []
    g0 = 0
    for v0, e1, e2 in mesh_tris:
        tp = max(-(-v0.shape[0] // unit) * unit, unit)
        planes_list.append(_planes(v0, e1, e2, tp))
        spans.append((g0, tp // unit))
        g0 += tp // unit
    return (np.concatenate(planes_list, axis=2),
            np.asarray(spans, np.int32).T)


def moller_trumbore(ray_o, ray_d, v0, e1, e2, t_min, t_max):
    """Ray/triangle test. e1 = v1 - v0, e2 = v2 - v0 (precomputed).

    Returns (hit, t, u, v, front_face). ``front_face`` is true when the ray
    hits the CCW front side (geometric normal e1 x e2 faces the ray origin),
    matching wgpu's `front_face` committed-intersection flag with the default
    CCW winding.
    """
    pvec = jnp.cross(ray_d, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    inv_det = jnp.where(jnp.abs(det) > _MT_EPS, 1.0 / det, 0.0)
    tvec = ray_o - v0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(ray_d * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    hit = (
        (jnp.abs(det) > _MT_EPS)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > t_min)
        & (t < t_max)
    )
    front_face = det > 0.0
    return hit, jnp.where(hit, t, INF), u, v, front_face


def aabb_slab(ray_o, inv_d, box_min, box_max, t_min, t_max):
    """Slab test; returns True where the ray segment overlaps the box."""
    t0 = (box_min - ray_o) * inv_d
    t1 = (box_max - ray_o) * inv_d
    t_near = jnp.minimum(t0, t1)
    t_far = jnp.maximum(t0, t1)
    t_entry = jnp.maximum(jnp.max(t_near, axis=-1), t_min)
    t_exit = jnp.minimum(jnp.min(t_far, axis=-1), t_max)
    return t_entry <= t_exit


def safe_inv_dir(ray_d):
    """1/d with +-inf avoided (huge finite instead), sign-preserving."""
    d = jnp.where(jnp.abs(ray_d) < 1e-12, jnp.where(ray_d < 0, -1e-12, 1e-12), ray_d)
    return 1.0 / d
