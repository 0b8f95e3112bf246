"""Scene system tests: materials, lights, builder compile, glTF loader."""

import json
import os

import numpy as np

from tpu_raytracer.models import scenes
from tpu_raytracer.scene import geometry, light
from tpu_raytracer.scene.builder import SceneBuilder
from tpu_raytracer.scene.loader import load_gltf
from tpu_raytracer.scene.material import NO_TEXTURE, Material


def test_material_builders():
    m = Material((0.5, 0.8, 1.0, 1.0)).glass(1.5)
    assert m.transmission_ == 1.0 and m.ior_ == 1.5 and m.roughness_ == 0.0
    m2 = Material().metallic(0.01)
    assert m2.metallic_ == 1.0 and m2.roughness_ == 0.01
    m3 = Material().texture(3).normal_texture(4).emissive([1, 2, 3])
    assert m3.tex_id == 3 and m3.normal_tex_id == 4
    assert m3.occlusion_tex_id == NO_TEXTURE


def test_light_area_math():
    # quad area = 4*|u x v| (builder.rs:392-415)
    q = light.make_quad_light([0, 1, 0], [0.5, 0, 0], [0, 0, -0.5],
                              [1, 1, 1, 10])
    assert abs(q.area - 4 * 0.25) < 1e-6
    # sphere area = 4 pi r^2, radius in v.x (builder.rs:418-429)
    s = light.make_sphere_light([0, 0, 0], 0.05, [1, 0, 0, 20])
    assert abs(s.area - 4 * np.pi * 0.05 ** 2) < 1e-9
    assert s.v[0] == 0.05


def test_procedural_meshes():
    assert geometry.create_plane().num_triangles == 2
    assert geometry.create_cube().num_triangles == 12
    sphere = geometry.create_sphere(2)
    assert sphere.num_triangles == 20 * 4 ** 2
    crystal = geometry.create_crystal()
    assert crystal.num_triangles == 16
    # icosphere vertices lie on radius 0.5
    r = np.linalg.norm(sphere.positions, axis=1)
    assert np.abs(r - 0.5).max() < 1e-6


def test_cornell_compile_shapes():
    scene = scenes.create_cornell_box()
    t = scene.num_triangles
    assert t > 1000
    assert scene.tri_table.shape == (t, 35)
    assert scene.num_lights == 2
    assert scene.mat_table.shape[1] == 17
    assert "color" in scene.tex_channels          # checker floor
    assert "normal" not in scene.tex_channels
    # tri_table mat ids are valid
    mats = np.asarray(scene.tri_table[:, 25]).astype(int)
    assert mats.min() >= 0 and mats.max() < scene.mat_table.shape[0]


def _write_tiny_gltf(tmpdir: str) -> str:
    """Minimal valid .gltf: one textured triangle."""
    positions = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    normals = np.tile([0, 0, 1], (3, 1)).astype(np.float32)
    uvs = np.array([[0, 0], [1, 0], [0, 1]], np.float32)
    indices = np.array([0, 1, 2], np.uint16)
    blob = (positions.tobytes() + normals.tobytes() + uvs.tobytes()
            + indices.tobytes())
    with open(os.path.join(tmpdir, "buf.bin"), "wb") as f:
        f.write(blob)
    from tpu_raytracer.utils import png

    png.write(os.path.join(tmpdir, "tex.png"),
              (np.random.rand(8, 8, 3) * 255).astype(np.uint8))

    doc = {
        "asset": {"version": "2.0"},
        "buffers": [{"uri": "buf.bin", "byteLength": len(blob)}],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": 36},
            {"buffer": 0, "byteOffset": 36, "byteLength": 36},
            {"buffer": 0, "byteOffset": 72, "byteLength": 24},
            {"buffer": 0, "byteOffset": 96, "byteLength": 6},
        ],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 3,
             "type": "VEC3"},
            {"bufferView": 1, "componentType": 5126, "count": 3,
             "type": "VEC3"},
            {"bufferView": 2, "componentType": 5126, "count": 3,
             "type": "VEC2"},
            {"bufferView": 3, "componentType": 5123, "count": 3,
             "type": "SCALAR"},
        ],
        "images": [{"uri": "tex.png"}],
        "textures": [{"source": 0}],
        "materials": [{
            "pbrMetallicRoughness": {
                "baseColorFactor": [0.8, 0.2, 0.1, 1.0],
                "baseColorTexture": {"index": 0},
                "metallicFactor": 0.0,
                "roughnessFactor": 0.7,
            },
            "emissiveFactor": [0.1, 0.0, 0.0],
        }],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": 0, "NORMAL": 1, "TEXCOORD_0": 2},
            "indices": 3, "material": 0,
        }]}],
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
    }
    path = os.path.join(tmpdir, "tiny.gltf")
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def test_gltf_loader_and_scene(tmp_path):
    path = _write_tiny_gltf(str(tmp_path))
    meshes, materials, images, mat_indices = load_gltf(path)
    assert len(meshes) == 1 and meshes[0].num_triangles == 1
    assert len(images) == 1 and images[0].shape == (8, 8, 4)
    assert materials[0].base_color == (0.8, 0.2, 0.1, 1.0)
    assert materials[0].roughness_ == 0.7
    assert materials[0].tex_id == 0

    scene = scenes.create_gltf_scene(path)
    assert scene.num_triangles == 2 + 1 + 2   # floor + tri + light quad
    assert "color" in scene.tex_channels


def test_gltf_multi_primitive_multi_material(tmp_path):
    """Multi-material model path (scenes.rs:349 VRM-class): one mesh
    with TWO primitives bound to different materials, plus a second
    node reusing the mesh under a transform - exercises per-primitive
    material indices and node-hierarchy flattening in the loader."""
    positions = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    normals = np.tile([0, 0, 1], (3, 1)).astype(np.float32)
    indices = np.array([0, 1, 2], np.uint16)
    blob = positions.tobytes() + normals.tobytes() + indices.tobytes()
    with open(os.path.join(str(tmp_path), "buf.bin"), "wb") as f:
        f.write(blob)
    doc = {
        "asset": {"version": "2.0"},
        "buffers": [{"uri": "buf.bin", "byteLength": len(blob)}],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": 36},
            {"buffer": 0, "byteOffset": 36, "byteLength": 36},
            {"buffer": 0, "byteOffset": 72, "byteLength": 6},
        ],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 3,
             "type": "VEC3"},
            {"bufferView": 1, "componentType": 5126, "count": 3,
             "type": "VEC3"},
            {"bufferView": 2, "componentType": 5123, "count": 3,
             "type": "SCALAR"},
        ],
        "materials": [
            {"pbrMetallicRoughness": {
                "baseColorFactor": [0.9, 0.1, 0.1, 1.0]}},
            {"pbrMetallicRoughness": {
                "baseColorFactor": [0.1, 0.9, 0.1, 1.0],
                "metallicFactor": 1.0, "roughnessFactor": 0.2}},
        ],
        "meshes": [{"primitives": [
            {"attributes": {"POSITION": 0, "NORMAL": 1}, "indices": 2,
             "material": 0},
            {"attributes": {"POSITION": 0, "NORMAL": 1}, "indices": 2,
             "material": 1},
        ]}],
        "nodes": [{"mesh": 0}],
        "scenes": [{"nodes": [0]}],
    }
    path = os.path.join(str(tmp_path), "multi.gltf")
    with open(path, "w") as f:
        json.dump(doc, f)

    meshes, materials, images, mat_indices = load_gltf(path)
    assert len(materials) == 2
    assert materials[1].metallic_ == 1.0
    # two primitives -> two loaded mesh entries with distinct materials
    # (one Mesh per primitive, node transforms ignored - loader.rs shape)
    assert len(meshes) == 2
    assert list(mat_indices) == [0, 1]

    scene = scenes.create_gltf_scene(path)
    # floor(2) + light quad(2) + 2 single-triangle primitives
    assert scene.num_triangles == 2 + 2 + 2
    # both materials survive into the compiled scene (plus floor/light)
    assert scene.materials["metallic"].shape[0] >= 4
    assert float(scene.materials["metallic"].max()) == 1.0
    scene = scenes.create_gltf_scene(str(tmp_path / "missing.gltf"))
    assert scene.num_triangles == 4            # floor + light quad only
    assert scene.num_lights == 1
