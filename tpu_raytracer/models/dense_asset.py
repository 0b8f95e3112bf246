"""Procedural dense test asset: a ~100k-triangle textured trefoil knot,
written as a self-contained binary .glb.

The reference repo ships no assets either but is *run* against dense
glTF models (DamagedHelmet ~100k tris, src/scene/scenes.rs:334-347);
this generator gives the framework an equivalent deterministic
workload that exercises the REAL product path - the hand-written glTF
loader (scene/loader.py), the 1024^2 texture-array policy, normal /
metallic-roughness texture sampling, and a ~100k-tri intersection -
without committing a multi-megabyte binary.

Everything is numpy + zlib (utils/png.py); the file is generated once on
first use and cached under assets/models/.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np

# anchored to the repo root (two levels above this package) so app/bench
# find the same cached asset regardless of cwd
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_PATH = os.path.join(_REPO_ROOT, "assets", "models", "dense_knot.glb")


# ---------------------------------------------------------------------------
# geometry: trefoil-knot tube
# ---------------------------------------------------------------------------

def _knot_curve(u):
    """Trefoil curve + unit Frenet-ish frame at parameters u [M]."""
    p = np.stack([np.sin(u) + 2.0 * np.sin(2.0 * u),
                  np.cos(u) - 2.0 * np.cos(2.0 * u),
                  -np.sin(3.0 * u)], axis=-1) / 3.0
    d = np.stack([np.cos(u) + 4.0 * np.cos(2.0 * u),
                  -np.sin(u) + 4.0 * np.sin(2.0 * u),
                  -3.0 * np.cos(3.0 * u)], axis=-1)
    dd = np.stack([-np.sin(u) - 8.0 * np.sin(2.0 * u),
                   -np.cos(u) + 8.0 * np.cos(2.0 * u),
                   9.0 * np.sin(3.0 * u)], axis=-1)
    t = d / np.linalg.norm(d, axis=-1, keepdims=True)
    # curve normal: curvature direction (trefoil curvature never vanishes)
    n = dd - t * np.sum(dd * t, axis=-1, keepdims=True)
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    b = np.cross(t, n)
    return p, t, n, b


def knot_mesh(major: int = 420, minor: int = 120, tube_r: float = 0.22):
    """Tube around the trefoil: (positions, normals, uvs, tangents, indices).

    major*minor vertices, 2*major*minor triangles (420x120 -> 100,800)."""
    u = np.arange(major, dtype=np.float64) * (2.0 * np.pi / major)
    c, t, n, b = _knot_curve(u)                       # [M, 3] each
    theta = np.arange(minor, dtype=np.float64) * (2.0 * np.pi / minor)
    cos_t = np.cos(theta)[None, :, None]              # [1, m, 1]
    sin_t = np.sin(theta)[None, :, None]
    ring_n = n[:, None, :] * cos_t + b[:, None, :] * sin_t   # [M, m, 3]
    pos = c[:, None, :] + tube_r * ring_n
    nrm = ring_n
    # uv tiles the texture 6x around the knot, 2x around the tube
    uu = (np.arange(major) / major)[:, None].repeat(minor, 1) * 6.0
    vv = (np.arange(minor) / minor)[None, :].repeat(major, 0) * 2.0
    uv = np.stack([uu % 1.0, vv % 1.0], axis=-1)
    # surface tangent = direction of increasing u (the curve tangent)
    tan = np.broadcast_to(t[:, None, :], pos.shape)
    tangents = np.concatenate(
        [tan.reshape(-1, 3), np.ones((major * minor, 1))], axis=-1)

    def vid(i, j):
        return (i % major) * minor + (j % minor)

    ii, jj = np.meshgrid(np.arange(major), np.arange(minor), indexing="ij")
    a = vid(ii, jj)
    b2 = vid(ii + 1, jj)
    cq = vid(ii + 1, jj + 1)
    d2 = vid(ii, jj + 1)
    # winding ORDER MATTERS: cross(v1-v0, v2-v0) must agree with the
    # outward ring normals - the front-face flip (reconstruct_hit
    # ffnormal, MT sign convention exactly like the reference's
    # ray_query) otherwise inverts EVERY shading normal and the knot
    # renders black (r5 showcase bug; pinned by
    # tests/test_procedural_assets.py::test_winding_matches_normals).
    tris = np.concatenate([
        np.stack([a, cq, b2], axis=-1).reshape(-1, 3),
        np.stack([a, d2, cq], axis=-1).reshape(-1, 3),
    ], axis=0)
    return (pos.reshape(-1, 3).astype(np.float32),
            nrm.reshape(-1, 3).astype(np.float32),
            uv.reshape(-1, 2).astype(np.float32),
            tangents.astype(np.float32),
            tris.reshape(-1).astype(np.uint32))


# ---------------------------------------------------------------------------
# textures (deterministic procedural, PNG-encoded)
# ---------------------------------------------------------------------------

def _png_bytes(arr_u8: np.ndarray) -> bytes:
    from ..utils import png

    return png.encode(arr_u8)


def _texture_set(size: int = 1024):
    """(base_color, normal, metallic_roughness) PNG bytes."""
    y, x = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    fu = x / size
    fv = y / size
    # base color: two-tone lacquer bands + fine marbling
    swirl = np.sin(2 * np.pi * (fu * 4 + 0.35 * np.sin(2 * np.pi * fv * 3)))
    marble = 0.5 + 0.5 * np.sin(
        2 * np.pi * (fv * 9 + 0.2 * np.sin(2 * np.pi * fu * 13)))
    band = (swirl > 0.0).astype(np.float64)
    r = band * (0.72 + 0.18 * marble) + (1 - band) * 0.10
    g = band * (0.20 + 0.10 * marble) + (1 - band) * 0.25
    bl = band * 0.12 + (1 - band) * (0.55 + 0.25 * marble)
    base = np.stack([r, g, bl], axis=-1)
    base_u8 = np.clip(base * 255.0 + 0.5, 0, 255).astype(np.uint8)

    # normal map from a bump height field (dimples + grooves)
    h = (0.6 * np.sin(2 * np.pi * fu * 24) * np.sin(2 * np.pi * fv * 24)
         + 0.4 * np.sin(2 * np.pi * (fu * 3 + fv * 7)))
    gx = np.roll(h, -1, 1) - np.roll(h, 1, 1)
    gy = np.roll(h, -1, 0) - np.roll(h, 1, 0)
    nz = np.full_like(h, 0.35)
    n = np.stack([-gx, -gy, nz], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    normal_u8 = np.clip((n * 0.5 + 0.5) * 255.0 + 0.5, 0, 255
                        ).astype(np.uint8)

    # glTF MR: G = roughness (rough in the grooves), B = metallic (bands)
    rough = np.clip(0.25 + 0.5 * (1.0 - band) + 0.2 * (h * 0.5 + 0.5), 0, 1)
    metal = np.clip(band * 0.9, 0, 1)
    mr = np.stack([np.zeros_like(rough), rough, metal], axis=-1)
    mr_u8 = np.clip(mr * 255.0 + 0.5, 0, 255).astype(np.uint8)
    return _png_bytes(base_u8), _png_bytes(normal_u8), _png_bytes(mr_u8)


# ---------------------------------------------------------------------------
# GLB writer
# ---------------------------------------------------------------------------

def _align4(b: bytes, pad: bytes = b"\x00") -> bytes:
    return b + pad * (-len(b) % 4)


def write_knot_glb(path: str = DEFAULT_PATH, major: int = 420,
                   minor: int = 120, tex_size: int = 1024) -> str:
    """Generate the dense knot .glb (idempotent; returns the path)."""
    pos, nrm, uv, tan, idx = knot_mesh(major, minor)
    base_png, normal_png, mr_png = _texture_set(tex_size)

    blobs = [pos.tobytes(), nrm.tobytes(), uv.tobytes(), tan.tobytes(),
             idx.tobytes(), base_png, normal_png, mr_png]
    views, offset, bin_parts = [], 0, []
    for blob in blobs:
        aligned = _align4(blob)
        views.append({"buffer": 0, "byteOffset": offset,
                      "byteLength": len(blob)})
        bin_parts.append(aligned)
        offset += len(aligned)
    bin_chunk = b"".join(bin_parts)

    nv = pos.shape[0]
    gltf = {
        "asset": {"version": "2.0", "generator": "tpu_raytracer dense_asset"},
        "buffers": [{"byteLength": len(bin_chunk)}],
        "bufferViews": views,
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": nv,
             "type": "VEC3",
             "min": pos.min(0).tolist(), "max": pos.max(0).tolist()},
            {"bufferView": 1, "componentType": 5126, "count": nv,
             "type": "VEC3"},
            {"bufferView": 2, "componentType": 5126, "count": nv,
             "type": "VEC2"},
            {"bufferView": 3, "componentType": 5126, "count": nv,
             "type": "VEC4"},
            {"bufferView": 4, "componentType": 5125,
             "count": int(idx.shape[0]), "type": "SCALAR"},
        ],
        "images": [
            {"bufferView": 5, "mimeType": "image/png"},
            {"bufferView": 6, "mimeType": "image/png"},
            {"bufferView": 7, "mimeType": "image/png"},
        ],
        "textures": [{"source": 0}, {"source": 1}, {"source": 2}],
        "materials": [{
            "name": "knot_lacquer",
            "pbrMetallicRoughness": {
                "baseColorFactor": [1.0, 1.0, 1.0, 1.0],
                "baseColorTexture": {"index": 0},
                "metallicRoughnessTexture": {"index": 2},
                "metallicFactor": 1.0,
                "roughnessFactor": 1.0,
            },
            "normalTexture": {"index": 1},
        }],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": 0, "NORMAL": 1, "TEXCOORD_0": 2,
                           "TANGENT": 3},
            "indices": 4,
            "material": 0,
        }]}],
        "nodes": [{"mesh": 0}],
        "scenes": [{"nodes": [0]}],
        "scene": 0,
    }

    json_chunk = _align4(json.dumps(gltf).encode("utf-8"), b" ")
    total = 12 + 8 + len(json_chunk) + 8 + len(bin_chunk)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, total))
        f.write(struct.pack("<II", len(json_chunk), 0x4E4F534A))
        f.write(json_chunk)
        f.write(struct.pack("<II", len(bin_chunk), 0x004E4942))
        f.write(bin_chunk)
    return path


# Bumped when the generator's OUTPUT changes (v2: outward winding fix);
# a cached .glb from an older generator is stale and regenerates.
ASSET_VERSION = 2


def _version_path(path: str) -> str:
    return path + ".version"


def ensure_dense_asset(path: str = DEFAULT_PATH) -> str:
    """Generate the asset if missing or generator-stale; returns the path."""
    vp = _version_path(path)
    try:
        cached = int(open(vp).read().strip())
    except (OSError, ValueError):
        cached = 0
    if not os.path.exists(path) or cached != ASSET_VERSION:
        write_knot_glb(path)
        os.makedirs(os.path.dirname(vp) or ".", exist_ok=True)
        with open(vp, "w") as f:
            f.write(str(ASSET_VERSION))
    return path
