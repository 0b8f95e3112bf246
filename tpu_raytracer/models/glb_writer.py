"""Minimal binary-glTF (.glb) writer for the procedural test assets.

The reference repo ships no assets but is *run* against real glTF models
(src/scene/scenes.rs:321-504: Avocado, DamagedHelmet, a VRM avatar, the
gift-wrapped chocolate). This writer lets the framework generate
deterministic equivalents that exercise the REAL product path - the
hand-written loader (scene/loader.py), texture dedup/remap, normal and
metallic-roughness sampling - instead of silently falling back to the
floor+light scene when the (non-redistributable) originals are absent.

Pure numpy + json + struct; PNG bytes from utils/png.py.
"""

from __future__ import annotations

import json
import struct

import numpy as np


def _align4(b: bytes, pad: bytes = b"\x00") -> bytes:
    return b + pad * (-len(b) % 4)


def png_bytes(arr_u8: np.ndarray) -> bytes:
    """Encode an [H, W, 3|4] uint8 array as PNG."""
    from ..utils import png

    return png.encode(arr_u8)


def write_glb(path: str, prims, images=(), materials=None,
              generator: str = "tpu_raytracer procgen") -> str:
    """Write a .glb with one glTF mesh+node per primitive.

    Args:
      path: output file.
      prims: list of dicts with keys
        pos [N,3] f32, nrm [N,3] f32, uv [N,2] f32, tan [N,4] f32,
        idx [M] u32 (triangle list), material: int index into `materials`.
      images: list of PNG byte strings; texture i sources image i.
      materials: list of glTF material dicts (texture "index" fields
        reference `images` positions). Defaults to one white material.

    Returns `path`.
    """
    if materials is None:
        materials = [{"name": "default",
                      "pbrMetallicRoughness": {
                          "baseColorFactor": [1.0, 1.0, 1.0, 1.0]}}]

    blobs, views = [], []
    offset = 0

    def add_blob(blob: bytes) -> int:
        nonlocal offset
        aligned = _align4(blob)
        views.append({"buffer": 0, "byteOffset": offset,
                      "byteLength": len(blob)})
        blobs.append(aligned)
        offset += len(aligned)
        return len(views) - 1

    accessors, meshes, nodes = [], [], []
    for p in prims:
        pos = np.ascontiguousarray(p["pos"], np.float32)
        nrm = np.ascontiguousarray(p["nrm"], np.float32)
        uv = np.ascontiguousarray(p["uv"], np.float32)
        tan = np.ascontiguousarray(p["tan"], np.float32)
        idx = np.ascontiguousarray(p["idx"], np.uint32).reshape(-1)
        nv = int(pos.shape[0])
        acc0 = len(accessors)
        accessors.extend([
            {"bufferView": add_blob(pos.tobytes()), "componentType": 5126,
             "count": nv, "type": "VEC3",
             "min": pos.min(0).tolist(), "max": pos.max(0).tolist()},
            {"bufferView": add_blob(nrm.tobytes()), "componentType": 5126,
             "count": nv, "type": "VEC3"},
            {"bufferView": add_blob(uv.tobytes()), "componentType": 5126,
             "count": nv, "type": "VEC2"},
            {"bufferView": add_blob(tan.tobytes()), "componentType": 5126,
             "count": nv, "type": "VEC4"},
            {"bufferView": add_blob(idx.tobytes()), "componentType": 5125,
             "count": int(idx.shape[0]), "type": "SCALAR"},
        ])
        meshes.append({"primitives": [{
            "attributes": {"POSITION": acc0, "NORMAL": acc0 + 1,
                           "TEXCOORD_0": acc0 + 2, "TANGENT": acc0 + 3},
            "indices": acc0 + 4,
            "material": int(p.get("material", 0)),
        }]})
        nodes.append({"mesh": len(meshes) - 1})

    image_entries = []
    for png in images:
        image_entries.append({"bufferView": add_blob(png),
                              "mimeType": "image/png"})

    bin_chunk = b"".join(blobs)
    gltf = {
        "asset": {"version": "2.0", "generator": generator},
        "buffers": [{"byteLength": len(bin_chunk)}],
        "bufferViews": views,
        "accessors": accessors,
        "materials": materials,
        "meshes": meshes,
        "nodes": nodes,
        "scenes": [{"nodes": list(range(len(nodes)))}],
        "scene": 0,
    }
    if image_entries:
        gltf["images"] = image_entries
        gltf["textures"] = [{"source": i} for i in range(len(image_entries))]

    json_chunk = _align4(json.dumps(gltf).encode("utf-8"), b" ")
    total = 12 + 8 + len(json_chunk) + 8 + len(bin_chunk)
    import os

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, total))
        f.write(struct.pack("<II", len(json_chunk), 0x4E4F534A))
        f.write(json_chunk)
        f.write(struct.pack("<II", len(bin_chunk), 0x004E4942))
        f.write(bin_chunk)
    return path
