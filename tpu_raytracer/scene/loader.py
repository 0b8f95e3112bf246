"""glTF 2.0 scene loader (manual parser - no external glTF dependency).

Replaces src/scene/loader.rs: loads .gltf (JSON + external buffers/images)
and .glb (binary container), extracting per-primitive meshes with
positions / normals (oct-encoded) / uvs / tangents and index widening
(u8/u16 -> i32, non-indexed sequential fallback; loader.rs:106-177), plus
PBR metallic-roughness materials with base-color / normal / occlusion /
emissive / MR texture indices (loader.rs:59-99). Images decode through utils/png
and are resized to the 1024x1024 texture-array policy at scene build
(loader.rs:20-57).

Returns (meshes, materials, images, material_indices) exactly like the
reference's `load_gltf`; texture ids in the returned materials index into
`images` and are remapped to the scene's color/data arrays by
`SceneBuilder`-side helpers (builder.rs:191-280 semantics in
models/scenes.py:add_gltf_to_builder).
"""

from __future__ import annotations

import base64
import json
import os
import struct

import numpy as np

from .geometry import Mesh, oct_encode_np
from .material import Material

_COMPONENT_DTYPE = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_SIZE = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
              "MAT4": 16}


def _load_glb(path: str):
    with open(path, "rb") as f:
        magic, version, _length = struct.unpack("<III", f.read(12))
        assert magic == 0x46546C67, "not a glb file"
        gltf = None
        buffers = []
        while True:
            header = f.read(8)
            if len(header) < 8:
                break
            chunk_len, chunk_type = struct.unpack("<II", header)
            data = f.read(chunk_len)
            if chunk_type == 0x4E4F534A:  # JSON
                gltf = json.loads(data.decode("utf-8"))
            elif chunk_type == 0x004E4942:  # BIN
                buffers.append(data)
    return gltf, buffers


def _load_buffers(gltf: dict, base_dir: str, glb_buffers: list) -> list:
    out = []
    for i, buf in enumerate(gltf.get("buffers", [])):
        uri = buf.get("uri")
        if uri is None:
            out.append(glb_buffers[i])
        elif uri.startswith("data:"):
            out.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            with open(os.path.join(base_dir, uri), "rb") as f:
                out.append(f.read())
    return out


def _read_accessor(gltf: dict, buffers: list, accessor_idx: int) -> np.ndarray:
    acc = gltf["accessors"][accessor_idx]
    view = gltf["bufferViews"][acc["bufferView"]]
    dtype = _COMPONENT_DTYPE[acc["componentType"]]
    ncomp = _TYPE_SIZE[acc["type"]]
    count = acc["count"]
    offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    data = buffers[view["buffer"]]
    stride = view.get("byteStride") or ncomp * np.dtype(dtype).itemsize
    item = np.dtype(dtype).itemsize * ncomp
    raw = np.frombuffer(data, np.uint8, count * stride - (stride - item),
                        offset)
    if stride == item:
        arr = raw.view(dtype).reshape(count, ncomp)
    else:
        arr = np.lib.stride_tricks.as_strided(
            raw.view(np.uint8), (count, item), (stride, 1)
        ).copy().view(dtype).reshape(count, ncomp)
    if acc.get("normalized") and dtype != np.float32:
        arr = arr.astype(np.float32) / np.iinfo(dtype).max
    return np.array(arr)


def _decode_bytes(data: bytes) -> np.ndarray:
    """Image file bytes -> [H, W, 4] uint8 RGBA. PNG decodes in numpy
    (utils/png.py); other formats (JPEG) need Pillow."""
    from ..utils import png

    if data[:8] == b"\x89PNG\r\n\x1a\n":
        img = png.decode(data)
        c = img.shape[2]
        rgb = img[:, :, :1].repeat(3, axis=2) if c <= 2 else img[:, :, :3]
        alpha = (img[:, :, -1:] if c in (2, 4)
                 else np.full(img.shape[:2] + (1,), 255, np.uint8))
        return np.concatenate([rgb, alpha], axis=2)
    try:
        from PIL import Image
    except ImportError:
        raise ValueError(
            "this glTF texture is not a PNG; decoding it (JPEG) needs "
            "Pillow, which is not installed") from None
    from io import BytesIO

    return np.asarray(Image.open(BytesIO(data)).convert("RGBA"))


def _decode_image(gltf: dict, buffers: list, base_dir: str,
                  image_idx: int) -> np.ndarray:
    img = gltf["images"][image_idx]
    if "uri" in img:
        uri = img["uri"]
        if uri.startswith("data:"):
            data = base64.b64decode(uri.split(",", 1)[1])
        else:
            with open(os.path.join(base_dir, uri), "rb") as f:
                data = f.read()
    else:
        view = gltf["bufferViews"][img["bufferView"]]
        off = view.get("byteOffset", 0)
        data = bytes(buffers[view["buffer"]][off:off + view["byteLength"]])
    return _decode_bytes(data)


def _tex_image(gltf: dict, tex_idx: int) -> int:
    return gltf["textures"][tex_idx]["source"]


def load_gltf(path: str):
    """Returns (meshes, materials, images, material_indices) - one Mesh per
    glTF primitive, material_indices[i] = material slot of primitive i
    (loader.rs:9-12 shape)."""
    base_dir = os.path.dirname(path)
    if path.endswith(".glb"):
        gltf, glb_buffers = _load_glb(path)
    else:
        with open(path) as f:
            gltf = json.load(f)
        glb_buffers = []
    buffers = _load_buffers(gltf, base_dir, glb_buffers)

    # --- materials (loader.rs:59-99); texture ids point into `images` ---
    materials = []
    for m in gltf.get("materials", [{}]):
        pbr = m.get("pbrMetallicRoughness", {})
        base = pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0])
        mat = Material(tuple(base))
        mat.roughness_ = float(pbr.get("roughnessFactor", 1.0))
        mat.metallic_ = float(pbr.get("metallicFactor", 1.0))
        mat.emissive_factor = tuple(m.get("emissiveFactor", [0, 0, 0]))
        # KHR extensions the reference's gltf crate exposes implicitly
        ext = m.get("extensions", {})
        if "KHR_materials_transmission" in ext:
            mat.transmission_ = float(
                ext["KHR_materials_transmission"].get(
                    "transmissionFactor", 0.0))
        if "KHR_materials_ior" in ext:
            mat.ior_ = float(ext["KHR_materials_ior"].get("ior", 1.5))
        if "baseColorTexture" in pbr:
            mat.texture(_tex_image(gltf, pbr["baseColorTexture"]["index"]))
        if "metallicRoughnessTexture" in pbr:
            mat.metallic_roughness_texture(
                _tex_image(gltf, pbr["metallicRoughnessTexture"]["index"]))
        if "normalTexture" in m:
            mat.normal_texture(_tex_image(gltf, m["normalTexture"]["index"]))
        if "occlusionTexture" in m:
            mat.occlusion_texture(
                _tex_image(gltf, m["occlusionTexture"]["index"]))
        if "emissiveTexture" in m:
            mat.emissive_texture(
                _tex_image(gltf, m["emissiveTexture"]["index"]))
        materials.append(mat)

    images = [
        _decode_image(gltf, buffers, base_dir, i)
        for i in range(len(gltf.get("images", [])))
    ]

    # --- meshes: one Mesh per primitive (loader.rs:106-177) ---
    meshes, mat_indices = [], []
    for gmesh in gltf.get("meshes", []):
        for prim in gmesh.get("primitives", []):
            attrs = prim["attributes"]
            positions = _read_accessor(gltf, buffers, attrs["POSITION"]
                                       ).astype(np.float32)
            count = len(positions)
            if "NORMAL" in attrs:
                normals = _read_accessor(gltf, buffers, attrs["NORMAL"])
            else:
                normals = np.tile([0.0, 1.0, 0.0], (count, 1))
            normals = normals.astype(np.float32)
            normals /= np.maximum(
                np.linalg.norm(normals, axis=1, keepdims=True), 1e-12)
            if "TEXCOORD_0" in attrs:
                uvs = _read_accessor(gltf, buffers, attrs["TEXCOORD_0"]
                                     ).astype(np.float32)[:, :2]
            else:
                uvs = np.zeros((count, 2), np.float32)
            if "TANGENT" in attrs:
                tangents = _read_accessor(gltf, buffers, attrs["TANGENT"]
                                          ).astype(np.float32)
            else:
                tangents = np.tile([1.0, 0.0, 0.0, 1.0], (count, 1)
                                   ).astype(np.float32)

            if "indices" in prim:
                indices = _read_accessor(gltf, buffers, prim["indices"]
                                         ).reshape(-1).astype(np.uint32)
            else:  # non-indexed sequential fallback (loader.rs:170-176)
                indices = np.arange(count, dtype=np.uint32)

            meshes.append(Mesh(
                positions=positions[:, :3],
                oct_normals=oct_encode_np(normals),
                uvs=uvs,
                tangents=tangents,
                indices=indices,
            ))
            mat_indices.append(prim.get("material", 0))

    return meshes, materials, images, mat_indices
