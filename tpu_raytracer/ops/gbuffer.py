"""G-buffer pass: primary visibility (gbuffer.wgsl:91-255).

Generates one camera ray per pixel from the inverse view/projection chain,
traces the BVH, and produces flat SoA G-buffer arrays: world position,
material id, final (normal-mapped) octahedral normal, uv, albedo
(base_color x texture x baked occlusion, gbuffer.wgsl:221), and the motion
vector `prev_uv - curr_uv` from reprojection through the previous frame's
unjittered view-proj (gbuffer.wgsl:227-242).

The reference packs these into 4 storage textures; here they stay SoA f32
arrays of shape [H*W, ...] (and un-quantized:
albedo is not crushed to 8 bits).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..scene.material import NO_TEXTURE
from ..utils import math3d, vec3
from . import textures
from .hit import apply_normal_map, gather_material, reconstruct_hit
from .trace_api import scene_trace

T_MIN = 1e-3
T_MAX = 1000.0  # gbuffer.wgsl:109


def generate_primary_rays(camera, width: int, height: int, y0=0, band_h=None):
    """gbuffer.wgsl:96-105. Returns (origins [R,3], dirs [R,3]).

    With y0/band_h, generates rays only for image rows [y0, y0+band_h) -
    the tile-sharded path (each device owns a row band).
    """
    if band_h is None:
        band_h = height
    xs = (jnp.arange(width, dtype=jnp.float32) + 0.5) / width
    ys = (jnp.asarray(y0, jnp.float32)
          + jnp.arange(band_h, dtype=jnp.float32) + 0.5) / height
    u, v = jnp.meshgrid(xs, ys, indexing="xy")  # [band_h, W]
    ndc_x = (u * 2.0 - 1.0).reshape(-1)
    ndc_y = (1.0 - v * 2.0).reshape(-1)

    origin = camera["view_inv"][:3, 3]

    ndc = jnp.stack([ndc_x, ndc_y, jnp.ones_like(ndc_x), jnp.ones_like(ndc_x)],
                    axis=-1)  # [R, 4]
    target = ndc @ camera["ray_matrix"].T
    direction = math3d.normalize(target[:, :3] / target[:, 3:4] - origin)
    origins = jnp.broadcast_to(origin, direction.shape)
    return origins, direction


def render_gbuffer(scene, camera, width: int, height: int, y0=0,
                   band_h=None) -> dict:
    """Returns the flat G-buffer dict consumed by trace_path / ReSTIR."""
    ray_o, ray_d = generate_primary_rays(camera, width, height, y0, band_h)
    res = scene_trace(scene, ray_o, ray_d, T_MIN, T_MAX)
    valid = res["tri"] >= 0

    h = reconstruct_hit(scene, res["tri"], vec3.of(ray_o), vec3.of(ray_d),
                        res["t"], inst_id=res.get("inst"))
    mat = gather_material(scene, h["mat_id"])
    uv_u, uv_v = h["uv"]

    base_color = mat["base_color"]
    if "color" in scene.tex_channels:
        base_color = base_color * textures.sample_bilinear(
            scene.color_tex, mat["tex_id"], uv_u, uv_v)
    if "occlusion" in scene.tex_channels:
        base_color = base_color * textures.sample_bilinear(
            scene.data_tex, mat["occlusion_tex_id"], uv_u, uv_v).x

    final_normal = h["ffnormal"]
    if "normal" in scene.tex_channels:
        nmap = textures.sample_bilinear(
            scene.data_tex, mat["normal_tex_id"], uv_u, uv_v)
        final_normal = apply_normal_map(
            final_normal, h["tangent"], h["tangent_w"], nmap,
            mat["normal_tex_id"] != NO_TEXTURE)

    # motion vectors (gbuffer.wgsl:227-242)
    pos = vec3.arr(h["pos"])
    pos4 = jnp.concatenate(
        [pos, jnp.ones((pos.shape[0], 1), jnp.float32)], axis=-1
    )
    curr_clip = pos4 @ camera["view_proj"].T
    prev_clip = pos4 @ camera["prev_view_proj"].T
    curr_ndc = curr_clip[:, :2] / curr_clip[:, 3:4]
    prev_ndc = prev_clip[:, :2] / prev_clip[:, 3:4]
    flip = jnp.asarray([0.5, -0.5], jnp.float32)
    motion = (prev_ndc * flip + 0.5) - (curr_ndc * flip + 0.5)

    oct_x, oct_y = vec3.oct_encode(final_normal)
    return {
        "valid": valid,
        "pos": jnp.where(valid[:, None], pos, 0.0),
        "mat_id": jnp.where(valid, h["mat_id"], 0).astype(jnp.int32),
        "oct_normal": jnp.where(valid[:, None],
                                jnp.stack([oct_x, oct_y], axis=-1), 0.0),
        "uv": jnp.where(valid[:, None],
                        jnp.stack([uv_u, uv_v], axis=-1), 0.0),
        "albedo": jnp.where(valid[:, None], vec3.arr(base_color), 0.0),
        "motion": jnp.where(valid[:, None], motion, 0.0),
    }


# ---------------------------------------------------------------------------
# Packed G-buffer: neighbor passes (temporal reproject, spatial ReSTIR, post
# stencils) read ONE wide row per tap instead of 5-6 narrow gathers.
# ---------------------------------------------------------------------------

GB_POS = slice(0, 3)
GB_OCT = slice(3, 5)
GB_UV = slice(5, 7)
GB_ALBEDO = slice(7, 10)
GB_MOTION = slice(10, 12)
GB_MAT = 12
GB_VALID = 13
GB_COLS = 14


def pack_gb(gb: dict):
    return jnp.concatenate([
        gb["pos"], gb["oct_normal"], gb["uv"], gb["albedo"], gb["motion"],
        gb["mat_id"].astype(jnp.float32)[:, None],
        gb["valid"].astype(jnp.float32)[:, None],
    ], axis=-1)


def unpack_gb(rows):
    return {
        "pos": rows[..., GB_POS],
        "oct_normal": rows[..., GB_OCT],
        "uv": rows[..., GB_UV],
        "albedo": rows[..., GB_ALBEDO],
        "motion": rows[..., GB_MOTION],
        "mat_id": rows[..., GB_MAT].astype(jnp.int32),
        "valid": rows[..., GB_VALID] > 0.5,
    }
