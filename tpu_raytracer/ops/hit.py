"""Hit-point reconstruction from triangle ids + barycentrics.

JAX equivalent of `reconstruct_geometry_hit` (restir.wgsl:383-441) and the
G-buffer hit processing (gbuffer.wgsl:124-174). Instead of chasing the
reference's index -> attribute -> instance indirection with many narrow
gathers, the scene compile bakes ONE
wide per-triangle shading row (scene.tri_table, world-space, unnormalized
per-vertex normals/tangents so normalize-after-interpolate matches the
reference's transform order exactly) and this pass does a single row gather
plus pure VPU interpolation.

All vector math runs on component-major V3s (utils/vec3): the only wide
arrays are the gathered rows themselves; every column is sliced to a dense
[R] immediately, so no [R, 3] row-major intermediate is ever
materialized.

Materials gather through `select_gather_cols` (exact one-hot matmul,
transposed so the output is [C, R] with a dense ray minor dim) for small
material sets, falling back to a native row gather for large ones.
"""

from __future__ import annotations

import os

import jax.numpy as jnp

from ..utils import vec3
from ..utils.vec3 import V3
from .gather import select_gather_cols

# transient [M, R] f32 one-hot footprint allowed for the winner-row fetch
# (2 GB; at 262k rays that admits tables up to 2048 rows)
ONEHOT_BUDGET_BYTES = 1 << 31


def fetch_cols(table, idx):
    """Winner-row fetch: table [M, C], idx [R] -> list of C dense [R]s.

    Small/mid tables use a transposed one-hot matmul that emits [C, R]
    with the ray axis minor, so every component is a free dense slice.
    It is exact only at "highest" matmul precision (no TF32; the package
    sets it). Tables too large fall back to the native row gather plus
    ONE transpose, keeping the major-dim slices free. Whether the one-hot
    form beats `table[idx]` on the GPU is ROADMAP S3."""
    m, c = table.shape
    r = idx.shape[0]
    if m * r * 4 <= ONEHOT_BUDGET_BYTES:
        return select_gather_cols(table, idx)
    rt = table[idx].T                                  # [C, R], R minor
    return [rt[k] for k in range(c)]


def _matvec9(cols, base, v):
    """Per-lane 3x3 matvec: cols[base+k] are the row-major matrix entries
    ([R] each), v a V3 -> V3."""
    m = [cols[base + k] for k in range(9)]
    return V3(m[0] * v.x + m[1] * v.y + m[2] * v.z,
              m[3] * v.x + m[4] * v.y + m[5] * v.z,
              m[6] * v.x + m[7] * v.y + m[8] * v.z)


def _cols_of(rows, n):
    """Slice every column of a gathered [R, C] row table to a dense [R]."""
    return [rows[:, k] for k in range(n)]


def _reconstruct_hit_instanced(scene, tri_id, inst_id, ray_o, ray_d, t):
    """Instanced-scene hit reconstruction: tri_table rows are OBJECT-space
    (shared across instances); the winner's (A^-1 | b | normal-matrix |
    det-sign | mat_id) row comes from scene.inst_table. Barycentrics are
    recomputed exactly in object space (t is identical in both spaces -
    directions stay unnormalized through the transform); normals/tangents
    interpolate in object space then transform by the normal matrix
    (linear maps commute with interpolation, so this matches the
    reference's transform-then-interpolate order up to reassociation)."""
    safe_tri = jnp.maximum(tri_id, 0)
    c = fetch_cols(scene.tri_table, safe_tri)          # 35 dense [R] cols
    n_inst = scene.inst_table.shape[0]
    safe_inst = jnp.clip(inst_id, 0, n_inst - 1)
    icols = fetch_cols(scene.inst_table, safe_inst)
    binv = V3(icols[9], icols[10], icols[11])
    detsign = icols[21]
    mat_id = icols[22].astype(jnp.int32)

    o_obj = _matvec9(icols, 0, ray_o) + binv
    d_obj = _matvec9(icols, 0, ray_d)

    v0 = V3(c[26], c[27], c[28])
    e1 = V3(c[29], c[30], c[31])
    e2 = V3(c[32], c[33], c[34])
    pvec = vec3.cross(d_obj, e2)
    det = vec3.dot(e1, pvec)
    det_ok = jnp.abs(det) > 1e-9
    inv_det = jnp.where(det_ok, 1.0 / jnp.where(det_ok, det, 1.0), 0.0)
    tvec = o_obj - v0
    u = vec3.dot(tvec, pvec) * inv_det
    qvec = vec3.cross(tvec, e1)
    v = vec3.dot(d_obj, qvec) * inv_det
    front = det * detsign > 0.0
    t = jnp.where(det_ok, vec3.dot(e2, qvec) * inv_det, t)

    w = 1.0 - u - v
    n_obj = V3(c[0], c[1], c[2]) * w + V3(c[3], c[4], c[5]) * u \
        + V3(c[6], c[7], c[8]) * v
    normal = vec3.normalize(_matvec9(icols, 12, n_obj))
    uv_u = c[9] * w + c[11] * u + c[13] * v
    uv_v = c[10] * w + c[12] * u + c[14] * v
    tg_obj = V3(c[15], c[16], c[17]) * w + V3(c[18], c[19], c[20]) * u \
        + V3(c[21], c[22], c[23]) * v
    tangent = vec3.normalize(_matvec9(icols, 12, tg_obj))

    ffnormal = vec3.where(front, normal, -normal)
    pos = ray_o + ray_d * t
    return {
        "pos": pos,
        "normal": normal,
        "ffnormal": ffnormal,
        "uv": (uv_u, uv_v),
        "tangent": tangent,
        "tangent_w": c[24],
        "mat_id": mat_id,
        "front": front,
        "t": t,
    }


def reconstruct_hit(scene, tri_id, ray_o, ray_d, t, inst_id=None):
    """Gather + interpolate hit attributes via the consolidated tri table.

    The intersector returns only (t, tri); barycentrics and facing are
    recomputed here EXACTLY (same f32 Moller-Trumbore terms) from the
    world v0/e1/e2 columns of the same wide row - one [R]-sized recompute
    instead of winner-attribute selection inside the [BR x CT] sweep.

    ray_o/ray_d are V3s; inst_id: winning instance per lane - REQUIRED for
    instanced scenes (tri_id is then an object triangle id).

    Returns dict: pos/normal/ffnormal/tangent V3 (shading, world),
    uv ([R], [R]), tangent_w [R], mat_id [R] i32, front [R], t [R].
    """
    if scene.instanced:
        return _reconstruct_hit_instanced(scene, tri_id, inst_id,
                                          ray_o, ray_d, t)
    safe_tri = jnp.maximum(tri_id, 0)
    c = fetch_cols(scene.tri_table, safe_tri)          # 35 dense [R] cols

    v0 = V3(c[26], c[27], c[28])
    e1 = V3(c[29], c[30], c[31])
    e2 = V3(c[32], c[33], c[34])
    pvec = vec3.cross(ray_d, e2)
    det = vec3.dot(e1, pvec)
    det_ok = jnp.abs(det) > 1e-9
    inv_det = jnp.where(det_ok, 1.0 / jnp.where(det_ok, det, 1.0), 0.0)
    tvec = ray_o - v0
    u = vec3.dot(tvec, pvec) * inv_det
    qvec = vec3.cross(tvec, e1)
    v = vec3.dot(ray_d, qvec) * inv_det
    front = det > 0.0
    # t recomputed from the fetched row, so positions and MIS distances
    # do not depend on which intersector produced the hit.
    t = jnp.where(det_ok, vec3.dot(e2, qvec) * inv_det, t)

    w = 1.0 - u - v

    n = V3(c[0], c[1], c[2]) * w + V3(c[3], c[4], c[5]) * u \
        + V3(c[6], c[7], c[8]) * v
    normal = vec3.normalize(n)
    uv_u = c[9] * w + c[11] * u + c[13] * v
    uv_v = c[10] * w + c[12] * u + c[14] * v
    tg = V3(c[15], c[16], c[17]) * w + V3(c[18], c[19], c[20]) * u \
        + V3(c[21], c[22], c[23]) * v
    tangent = vec3.normalize(tg)
    mat_id = c[25].astype(jnp.int32)

    ffnormal = vec3.where(front, normal, -normal)
    pos = ray_o + ray_d * t

    return {
        "pos": pos,
        "normal": normal,
        "ffnormal": ffnormal,
        "uv": (uv_u, uv_v),
        "tangent": tangent,
        "tangent_w": c[24],
        "mat_id": mat_id,
        "front": front,
        "t": t,
    }


def gather_material(scene, mat_id):
    """One-shot material row fetch -> dict of lanes (see mat_table layout).

    Colors are V3s; scalars are dense [R]s."""
    m = scene.mat_table.shape[0]
    idx = jnp.clip(mat_id, 0, m - 1)
    c = fetch_cols(scene.mat_table, idx)
    return {
        "base_color": V3(c[0], c[1], c[2]),
        "emissive_factor": V3(c[4], c[5], c[6]),
        "roughness": c[7],
        "metallic": c[8],
        "transmission": c[9],
        "ior": c[10],
        "light_index": c[11].astype(jnp.int32),
        "tex_id": c[12].astype(jnp.int32),
        "normal_tex_id": c[13].astype(jnp.int32),
        "occlusion_tex_id": c[14].astype(jnp.int32),
        "emissive_tex_id": c[15].astype(jnp.int32),
        "metallic_roughness_tex_id": c[16].astype(jnp.int32),
    }


def gather_light(scene, light_idx):
    """Light row fetch -> dict (position, type, u, area, v, emission)."""
    l = scene.light_table.shape[0]
    idx = jnp.clip(light_idx, 0, l - 1)
    c = fetch_cols(scene.light_table, idx)
    return {
        "position": V3(c[0], c[1], c[2]),
        "type": c[3].astype(jnp.int32),
        "u": V3(c[4], c[5], c[6]),
        "area": c[7],
        "v": V3(c[8], c[9], c[10]),
        "emission": V3(c[11], c[12], c[13]),
        "emission_w": c[14],
    }


def apply_normal_map(ffnormal, tangent, tangent_w, normal_map_rgb, has_map):
    """Perturb ffnormal by a tangent-space normal map (restir.wgsl:655-671).

    All vectors V3. Re-orthogonalizes T against the (possibly flipped)
    ffnormal and applies the tangent handedness sign from tangent_w.
    """
    normal_local = vec3.normalize(normal_map_rgb * 2.0 - 1.0)
    t_ff = vec3.normalize(
        tangent - ffnormal * vec3.dot(ffnormal, tangent)
    )
    b_ff = vec3.normalize(vec3.cross(ffnormal, t_ff)) * tangent_w
    perturbed = vec3.normalize(
        t_ff * normal_local.x
        + b_ff * normal_local.y
        + ffnormal * normal_local.z
    )
    return vec3.where(has_map, perturbed, ffnormal)
