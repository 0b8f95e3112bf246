"""SceneBuilder: the user-facing scene-definition API.

Shape-compatible with the reference's fluent builder
(src/scene/builder.rs:23-589): `add_mesh` / `add_material` / `add_instance`
/ `register_quad_light` / `register_sphere_light` / `add_*_texture` /
`build()`.  Where the reference's `build` uploads GPU buffers and asks the
driver for TLAS/BLAS builds (builder.rs:143-179,454-468), this one compiles
the scene into device arrays:

  * instances' triangles are transformed to world space into one flat soup
    (per-triangle instance/prim metadata preserves the reference's
    `(mesh_id << 16) | mat_id` custom-data semantics, builder.rs:181-189),
  * a unified-stream BVH is built over the soup (ops/bvh.py) - the explicit
    replacement for the driver's opaque TLAS+BLAS,
  * object-space triangles + per-instance affines are kept so per-frame
    instance motion only needs a vectorized re-transform + device-side box
    refit, mirroring TLAS update semantics,
  * materials/lights become SoA tables, textures become bf16 arrays with
    sRGB pre-decoded to linear (the reference samples Rgba8UnormSrgb
    hardware-decoded, builder.rs:489).
"""

from __future__ import annotations

import numpy as np

from ..ops import bvh as bvh_ops
from ..ops.intersect import pack_triangles
from ..utils import math3d
from . import light as light_mod
from .geometry import Mesh
from .material import Material, pack_materials
from .resources import CompiledScene

TEXTURE_SIZE = 1024  # reference: scene/mod.rs TEXTURE_WIDTH/HEIGHT = 1024

# "auto" instancing threshold, in flattened world triangles. A flattened
# triangle costs ~420 bytes of scene arrays (shading rows, planes, BVH
# stream; textures aside), so 32M of them take ~13 GB - a fifth of the
# 60 GB a JAX process holds on an 80 GB H100. Below that the flattened
# world is faster: on an H100 (700 W limit) the 100-instance gallery
# (512k world triangles) takes 1,357 ms per 262k-ray call on the
# instanced scan and 19.7 ms flattened on the BVH walk, and renders at
# 3.95 fps flattened.
INSTANCE_AUTO_TRIS = 32 * 1024 * 1024


def _subdivide_world(bundle, scalars, max_diag):
    """Iterative longest-edge bisection of oversized world triangles.

    bundle: [T, 3, 20] per-vertex data
        (world pos 3 | world n 3 | world t 3 | uv 2 |
         local pos 3 | local n 3 | local t 3)
    scalars: [T, 4] per-tri (sign, mat_id, inst, prim).
    All per-vertex quantities interpolate linearly, so midpoint insertion
    leaves the rendered distribution unchanged (normalize-after-interp is
    scale-invariant); only per-ray float rounding differs.
    """
    while True:
        pos = bundle[:, :, 0:3]
        diag = np.linalg.norm(pos.max(axis=1) - pos.min(axis=1), axis=1)
        big = diag > max_diag
        if not big.any():
            return bundle, scalars
        keep_b, keep_s = bundle[~big], scalars[~big]
        b = bundle[big]
        s = scalars[big]
        p = b[:, :, 0:3]
        e_len = np.stack([
            np.linalg.norm(p[:, 1] - p[:, 0], axis=1),
            np.linalg.norm(p[:, 2] - p[:, 1], axis=1),
            np.linalg.norm(p[:, 0] - p[:, 2], axis=1),
        ], axis=1)
        i = np.argmax(e_len, axis=1)          # split edge (i, i+1), keep i+2
        j = (i + 1) % 3
        k = (i + 2) % 3
        r = np.arange(len(b))
        vi, vj, vk = b[r, i], b[r, j], b[r, k]
        m = (vi + vj) * 0.5
        tri_a = np.stack([vi, m, vk], axis=1)   # (Pi, M, Pk): CCW preserved
        tri_b = np.stack([m, vj, vk], axis=1)   # (M, Pj, Pk)
        bundle = np.concatenate([keep_b, tri_a, tri_b], axis=0)
        scalars = np.concatenate([keep_s, s, s], axis=0)


def _oct_decode_np(e: np.ndarray) -> np.ndarray:
    """Octahedral decode (host, matches gbuffer.wgsl:38-44 / math3d)."""
    ex, ey = e[:, 0], e[:, 1]
    nz = 1.0 - np.abs(ex) - np.abs(ey)
    t = np.maximum(-nz, 0.0)
    nx = ex + np.where(ex >= 0.0, -t, t)
    ny = ey + np.where(ey >= 0.0, -t, t)
    n = np.stack([nx, ny, nz], axis=-1).astype(np.float32)
    return n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-6)


def _srgb_to_linear(x: np.ndarray) -> np.ndarray:
    """Exact piecewise sRGB EOTF (matches hardware Rgba8UnormSrgb decode)."""
    x = x.astype(np.float32) / 255.0
    return np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def _prep_texture(img: np.ndarray, srgb: bool) -> np.ndarray:
    """To [TEXTURE_SIZE, TEXTURE_SIZE, 3] float32 (linear)."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[:, :, None].repeat(3, axis=2)
    img = img[:, :, :3]
    if img.dtype == np.uint8:
        img = _srgb_to_linear(img) if srgb else img.astype(np.float32) / 255.0
    else:
        img = img.astype(np.float32)
    if img.shape[0] != TEXTURE_SIZE or img.shape[1] != TEXTURE_SIZE:
        # resize to the fixed array size (loader.rs:20-57 policy): cubic
        # spline per channel through scipy, clamped to the texel range
        from scipy import ndimage

        zoom = (TEXTURE_SIZE / img.shape[0], TEXTURE_SIZE / img.shape[1])
        img = np.stack([ndimage.zoom(np.clip(img[:, :, k], 0.0, 1.0), zoom,
                                     order=3, grid_mode=True, mode="reflect")
                        for k in range(3)], axis=-1)
        img = np.clip(img, 0.0, 1.0)
    return img


def _default_color_textures() -> list:
    """builder.rs:41-75: 0 = white, 1 = 64-px checker, 2 = black."""
    s = TEXTURE_SIZE
    white = np.ones((s, s, 3), np.float32)
    yy, xx = np.meshgrid(np.arange(s), np.arange(s), indexing="ij")
    check = (((xx // 64) + (yy // 64)) % 2 == 0).astype(np.float32)
    checker = np.repeat(check[:, :, None], 3, axis=2)
    black = np.zeros((s, s, 3), np.float32)
    return [white, checker, black]


def _default_data_textures() -> list:
    """builder.rs:77-91: 0 = white, 1 = flat normal, 2 = black (linear)."""
    s = TEXTURE_SIZE
    white = np.ones((s, s, 3), np.float32)
    flat_normal = np.tile(
        np.array([128 / 255.0, 128 / 255.0, 1.0], np.float32), (s, s, 1)
    )
    black = np.zeros((s, s, 3), np.float32)
    return [white, flat_normal, black]


class SceneBuilder:
    def __init__(self):
        self.meshes: list[Mesh] = []
        self.materials: list[Material] = []
        self.instances: list[tuple] = []  # (mesh_id, mat_id, transform 4x4)
        self.lights: list = []
        self.color_textures: list[np.ndarray] = _default_color_textures()
        self.data_textures: list[np.ndarray] = _default_data_textures()

    # ---------------- registration API (builder.rs parity) ----------------

    def add_mesh(self, mesh: Mesh) -> int:
        self.meshes.append(mesh)
        return len(self.meshes) - 1

    def add_material(self, mat: Material) -> int:
        self.materials.append(mat)
        return len(self.materials) - 1

    def add_instance(self, mesh_id: int, mat_id: int, transform: np.ndarray,
                     mask: int = 0x1) -> int:
        # mask accepted for API parity; the reference always traces 0xFF
        # (builder.rs:187), so it has no render-time effect there either.
        self.instances.append((mesh_id, mat_id, np.asarray(transform, np.float32)))
        return len(self.instances) - 1

    def add_color_texture(self, img: np.ndarray, srgb: bool = True) -> int:
        self.color_textures.append(_prep_texture(img, srgb=srgb))
        return len(self.color_textures) - 1

    def add_data_texture(self, img: np.ndarray) -> int:
        self.data_textures.append(_prep_texture(img, srgb=False))
        return len(self.data_textures) - 1

    def add_quad_light(self, position, u, v, emission) -> int:
        self.lights.append(light_mod.make_quad_light(position, u, v, emission))
        return len(self.lights) - 1

    def add_sphere_light(self, center, radius, emission) -> int:
        self.lights.append(light_mod.make_sphere_light(center, radius, emission))
        return len(self.lights) - 1

    def register_quad_light(self, mesh_id: int, transform: np.ndarray,
                            color, intensity: float) -> None:
        """builder.rs:316-351: emissive material + instance + NEE record."""
        emission_factor = [c * intensity for c in color]
        mat_id = self.add_material(
            Material((1.0, 1.0, 1.0, 1.0))
            .light_index(len(self.lights))
            .emissive(emission_factor)
            .texture(0)
        )
        self.add_instance(mesh_id, mat_id, transform)
        position = transform[:3, 3]
        u = math3d.transform_vector(transform, [1.0, 0.0, 0.0]) * 0.5
        v = math3d.transform_vector(transform, [0.0, 0.0, -1.0]) * 0.5
        self.add_quad_light(position, u, v, [color[0], color[1], color[2], intensity])

    def register_sphere_light(self, mesh_id: int, transform: np.ndarray,
                              color, intensity: float) -> None:
        """builder.rs:353-385."""
        emission_factor = [c * intensity for c in color]
        mat_id = self.add_material(
            Material((1.0, 1.0, 1.0, 1.0))
            .light_index(len(self.lights))
            .emissive(emission_factor)
            .texture(0)
        )
        self.add_instance(mesh_id, mat_id, transform)
        position = transform[:3, 3]
        radius = float(np.linalg.norm(
            math3d.transform_vector(transform, [1.0, 0.0, 0.0]))) * 0.5
        self.add_sphere_light(position, radius, [color[0], color[1], color[2], intensity])

    # ---------------- compile ----------------

    def _pack_tables(self):
        """Materials / lights / textures -> device tables (shared by the
        flattened and instanced build paths)."""
        materials = pack_materials(self.materials)
        m = materials["base_color"].shape[0]
        mat_table = np.zeros((m, 17), np.float32)
        mat_table[:, 0:4] = materials["base_color"]
        mat_table[:, 4:7] = materials["emissive_factor"]
        mat_table[:, 7] = materials["roughness"]
        mat_table[:, 8] = materials["metallic"]
        mat_table[:, 9] = materials["transmission"]
        mat_table[:, 10] = materials["ior"]
        mat_table[:, 11] = materials["light_index"]
        mat_table[:, 12] = materials["tex_id"]
        mat_table[:, 13] = materials["normal_tex_id"]
        mat_table[:, 14] = materials["occlusion_tex_id"]
        mat_table[:, 15] = materials["emissive_tex_id"]
        mat_table[:, 16] = materials["metallic_roughness_tex_id"]

        from .material import NO_TEXTURE

        channels = []
        for name, key in (("color", "tex_id"), ("normal", "normal_tex_id"),
                          ("occlusion", "occlusion_tex_id"),
                          ("emissive", "emissive_tex_id"),
                          ("metallic_roughness",
                           "metallic_roughness_tex_id")):
            if (materials[key] != NO_TEXTURE).any():
                channels.append(name)
        tex_channels = frozenset(channels)

        lights = light_mod.pack_lights(self.lights)
        nl = lights["position"].shape[0]
        light_table = np.zeros((nl, 15), np.float32)
        light_table[:, 0:3] = lights["position"]
        light_table[:, 3] = lights["type"]
        light_table[:, 4:7] = lights["u"]
        light_table[:, 7] = lights["area"]
        light_table[:, 8:11] = lights["v"]
        light_table[:, 11:15] = lights["emission"]
        color_tex = np.stack(self.color_textures).astype(np.float32)
        data_tex = np.stack(self.data_textures).astype(np.float32)
        return (materials, mat_table, tex_channels, lights, light_table,
                color_tex, data_tex)

    def build(self, dtype=np.float32,
              subdivide_max_diag: float | None = None,
              instancing: str = "auto") -> CompiledScene:
        """Compile the scene.

        subdivide_max_diag: optional fraction of the scene AABB diagonal;
        world triangles larger than this are longest-edge split at build
        time. Pure culling aid (tighter intersector chunk AABBs for scenes
        with giant triangles) - shading attributes interpolate linearly so
        the rendered distribution is unchanged, but per-ray float rounding
        differs, so golden comparisons are not bit-stable across this
        setting. Default off.

        instancing: "auto" | "on" | "off" - two-level shared-BLAS mode
        (src/scene/builder.rs:143-189 economics): ONE object-space
        triangle block per mesh, instances as transforms only, traced by
        an unculled scan over every (instance, chunk group)
        (trace_api._trace_instanced_xla). "auto" enables it only when the
        flattened world would pass INSTANCE_AUTO_TRIS: flattened scenes
        get the sweep or the BVH walk, which the scan does not beat (see
        INSTANCE_AUTO_TRIS), so instancing is worth it for memory alone.
        """
        import jax.numpy as jnp

        from ..ops import textures as textures_mod

        if instancing not in ("auto", "on", "off"):
            raise ValueError(f"instancing={instancing!r}")
        t_world = sum(self.meshes[m].num_triangles
                      for m, _, _ in self.instances)
        want_instanced = (instancing == "on") or (
            instancing == "auto" and t_world > INSTANCE_AUTO_TRIS)
        if want_instanced:
            if subdivide_max_diag is not None:
                raise ValueError(
                    "subdivide_max_diag is a flattened-mode culling aid")
            return self._build_instanced()

        # 1. global concatenated attributes / indices (builder.rs:123-141)
        attr_n, attr_uv, attr_tan, indices = [], [], [], []
        mesh_voff, mesh_ioff = [], []
        local_v0, local_e1, local_e2 = [], [], []
        mesh_tri_off = []  # offset into local_* per mesh
        v_off = i_off = t_off = 0
        for mesh in self.meshes:
            mesh_voff.append(v_off)
            mesh_ioff.append(i_off)
            mesh_tri_off.append(t_off)
            attr_n.append(mesh.oct_normals)
            attr_uv.append(mesh.uvs)
            attr_tan.append(mesh.tangents)
            indices.append(mesh.indices.astype(np.int32))
            tri = mesh.indices.reshape(-1, 3)
            p = mesh.positions
            local_v0.append(p[tri[:, 0]])
            local_e1.append(p[tri[:, 1]] - p[tri[:, 0]])
            local_e2.append(p[tri[:, 2]] - p[tri[:, 0]])
            v_off += len(mesh.positions)
            i_off += len(mesh.indices)
            t_off += mesh.num_triangles

        cat = lambda xs, w: (np.concatenate(xs, axis=0) if xs
                             else np.zeros((0, w) if w else (0,), np.float32))
        attr_n = cat(attr_n, 2)
        attr_uv = cat(attr_uv, 2)
        attr_tan = cat(attr_tan, 4)
        indices = (np.concatenate(indices) if indices else np.zeros((0,), np.int32))
        local_v0, local_e1, local_e2 = cat(local_v0, 3), cat(local_e1, 3), cat(local_e2, 3)

        # 2. flatten instances to a world-space soup
        tri_inst, tri_prim, tri_local = [], [], []
        world_v0, world_e1, world_e2 = [], [], []
        inst_mesh, inst_mat, inst_tf, inst_nm = [], [], [], []
        for inst_id, (mesh_id, mat_id, tf) in enumerate(self.instances):
            mesh = self.meshes[mesh_id]
            nt = mesh.num_triangles
            a = tf[:3, :3]
            t = tf[:3, 3]
            lo = mesh_tri_off[mesh_id]
            lv0 = local_v0[lo:lo + nt]
            lv1 = lv0 + local_e1[lo:lo + nt]
            lv2 = lv0 + local_e2[lo:lo + nt]
            wv0 = lv0 @ a.T + t
            wv1 = lv1 @ a.T + t
            wv2 = lv2 @ a.T + t
            world_v0.append(wv0)
            world_e1.append(wv1 - wv0)
            world_e2.append(wv2 - wv0)
            tri_inst.append(np.full(nt, inst_id, np.int32))
            tri_prim.append(np.arange(nt, dtype=np.int32))
            tri_local.append(np.arange(lo, lo + nt, dtype=np.int32))
            inst_mesh.append(mesh_id)
            inst_mat.append(mat_id)
            inst_tf.append(tf[:3, :4])
            inst_nm.append(np.linalg.inv(a).T.astype(np.float32))

        world_v0 = cat(world_v0, 3)
        world_e1 = cat(world_e1, 3)
        world_e2 = cat(world_e2, 3)
        tri_inst = (np.concatenate(tri_inst) if tri_inst else np.zeros((0,), np.int32))
        tri_prim = (np.concatenate(tri_prim) if tri_prim else np.zeros((0,), np.int32))
        tri_local = (np.concatenate(tri_local) if tri_local else np.zeros((0,), np.int32))

        # 2b. consolidated per-triangle shading tables (ORIGINAL order):
        # one wide gather per hit replaces the index->attribute->instance
        # gather chain. Per-vertex world normals/tangents stored
        # UNNORMALIZED so normalize(interp(..)) is bit-equivalent to the
        # reference's transform-after-interpolate order (restir.wgsl:422-431).
        t_total = len(tri_inst)
        tri_table = np.zeros((max(t_total, 1), 26), np.float32)
        tri_table_local = np.zeros_like(tri_table)
        row = 0
        for inst_id, (mesh_id, mat_id, tf) in enumerate(self.instances):
            mesh = self.meshes[mesh_id]
            nt = mesh.num_triangles
            nm = np.linalg.inv(tf[:3, :3]).T.astype(np.float32)
            tri = mesh.indices.reshape(-1, 3).astype(np.int64)
            n_local = _oct_decode_np(mesh.oct_normals)          # [V, 3]
            n_world = n_local @ nm.T
            t_local = mesh.tangents[:, :3]
            t_world = t_local @ nm.T
            blk = tri_table[row:row + nt]
            blk_l = tri_table_local[row:row + nt]
            for k in range(3):
                blk[:, k * 3:k * 3 + 3] = n_world[tri[:, k]]
                blk_l[:, k * 3:k * 3 + 3] = n_local[tri[:, k]]
                blk[:, 9 + k * 2:11 + k * 2] = mesh.uvs[tri[:, k]]
                blk_l[:, 9 + k * 2:11 + k * 2] = mesh.uvs[tri[:, k]]
                blk[:, 15 + k * 3:18 + k * 3] = t_world[tri[:, k]]
                blk_l[:, 15 + k * 3:18 + k * 3] = t_local[tri[:, k]]
            blk[:, 24] = mesh.tangents[tri[:, 0], 3]   # sign from v0
            blk[:, 25] = mat_id
            blk_l[:, 24:26] = blk[:, 24:26]
            row += nt

        # 2c. optional oversized-triangle subdivision (culling aid)
        if subdivide_max_diag is not None and t_total > 0:
            scene_diag = float(np.linalg.norm(
                np.maximum.reduce([world_v0, world_v0 + world_e1,
                                   world_v0 + world_e2]).max(axis=0)
                - np.minimum.reduce([world_v0, world_v0 + world_e1,
                                     world_v0 + world_e2]).min(axis=0)))
            lv0 = local_v0[tri_local]
            lv1 = lv0 + local_e1[tri_local]
            lv2 = lv0 + local_e2[tri_local]
            bundle = np.zeros((t_total, 3, 20), np.float32)
            for k, (wv, lv) in enumerate(zip(
                    (world_v0, world_v0 + world_e1, world_v0 + world_e2),
                    (lv0, lv1, lv2))):
                bundle[:, k, 0:3] = wv
                bundle[:, k, 3:6] = tri_table[:, k * 3:k * 3 + 3]
                bundle[:, k, 6:9] = tri_table[:, 15 + k * 3:18 + k * 3]
                bundle[:, k, 9:11] = tri_table[:, 9 + k * 2:11 + k * 2]
                bundle[:, k, 11:14] = lv
                bundle[:, k, 14:17] = tri_table_local[:, k * 3:k * 3 + 3]
                bundle[:, k, 17:20] = tri_table_local[:, 15 + k * 3:18 + k * 3]
            scalars = np.stack([tri_table[:, 24],
                                tri_table[:, 25],
                                tri_inst.astype(np.float32),
                                tri_prim.astype(np.float32)], axis=1)
            bundle, scalars = _subdivide_world(
                bundle, scalars, subdivide_max_diag * scene_diag)
            t_total = len(bundle)
            world_v0 = bundle[:, 0, 0:3].copy()
            world_e1 = bundle[:, 1, 0:3] - world_v0
            world_e2 = bundle[:, 2, 0:3] - world_v0
            local_v0 = bundle[:, 0, 11:14].copy()
            local_e1 = bundle[:, 1, 11:14] - local_v0
            local_e2 = bundle[:, 2, 11:14] - local_v0
            tri_local = np.arange(t_total, dtype=np.int32)
            tri_table = np.zeros((t_total, 26), np.float32)
            tri_table_local = np.zeros_like(tri_table)
            for k in range(3):
                tri_table[:, k * 3:k * 3 + 3] = bundle[:, k, 3:6]
                tri_table[:, 15 + k * 3:18 + k * 3] = bundle[:, k, 6:9]
                tri_table[:, 9 + k * 2:11 + k * 2] = bundle[:, k, 9:11]
                tri_table_local[:, k * 3:k * 3 + 3] = bundle[:, k, 14:17]
                tri_table_local[:, 15 + k * 3:18 + k * 3] = bundle[:, k, 17:20]
                tri_table_local[:, 9 + k * 2:11 + k * 2] = bundle[:, k, 9:11]
            tri_table[:, 24] = scalars[:, 0]
            tri_table[:, 25] = scalars[:, 1]
            tri_table_local[:, 24:26] = tri_table[:, 24:26]
            tri_inst = scalars[:, 2].astype(np.int32)
            tri_prim = scalars[:, 3].astype(np.int32)

        # 3. BVH over the soup; then REORDER all per-triangle data into the
        # BVH's DFS leaf order. Consecutive triangles become spatially
        # coherent (nearby rows in every per-triangle table) and BVH leaf
        # ranges stay contiguous.
        wv1 = world_v0 + world_e1
        wv2 = world_v0 + world_e2
        aabb_min = np.minimum(np.minimum(world_v0, wv1), wv2)
        aabb_max = np.maximum(np.maximum(world_v0, wv1), wv2)
        tree = bvh_ops.build_bvh(aabb_min, aabb_max)

        t_total = len(tri_inst)
        if t_total > 0:
            order = tree.tri_id[tree.skip < 0].astype(np.int64)  # DFS order
            inv = np.empty_like(order)
            inv[order] = np.arange(t_total, dtype=np.int64)
            world_v0, world_e1, world_e2 = (
                world_v0[order], world_e1[order], world_e2[order])
            tri_inst, tri_prim, tri_local = (
                tri_inst[order], tri_prim[order], tri_local[order])
            tri_table = tri_table[order]
            tri_table_local = tri_table_local[order]
            tree.tri_id[tree.skip < 0] = inv[order].astype(np.int32)  # = 0..T-1

        bvh_ops.fill_triangles(tree, world_v0, world_e1, world_e2)
        tri_planes = pack_triangles(world_v0, world_e1, world_e2)

        # widen the shading rows with world v0/e1/e2 (cols 26:35): the
        # intersector returns only (t, tri) and reconstruct_hit recomputes
        # exact u/v/front from this one wide gather, so the sweep carries
        # no per-chunk winner attribute selection.
        if t_total > 0:
            tri_table = np.concatenate(
                [tri_table, world_v0, world_e1, world_e2], axis=1)
        else:
            tri_table = np.concatenate(
                [tri_table, np.zeros((tri_table.shape[0], 9), np.float32)],
                axis=1)

        # stream row of each triangle's BVH record (for on-device refit)
        bvh_tri_rows = np.zeros((max(t_total, 1),), np.int32)
        tri_rows = np.where(tree.skip < 0)[0]
        if t_total > 0:
            bvh_tri_rows[tree.tri_id[tri_rows]] = tri_rows.astype(np.int32)

        # material / light / texture tables (+ texture-channel flags)
        (materials, mat_table, tex_channels, lights, light_table,
         color_tex, data_tex) = self._pack_tables()


        i = np.int32
        f = np.float32
        scene = CompiledScene(
            **_empty_instanced_fields(),
            tri_planes=tri_planes,
            tri_table=tri_table.astype(f),
            tri_table_local=tri_table_local.astype(f),
            bvh_tri_rows=bvh_tri_rows,
            mat_table=mat_table.astype(f),
            light_table=light_table.astype(f),
            bvh_rec=tree.rec.astype(f),
            bvh_skip=tree.skip.astype(i),
            bvh_tri=tree.tri_id.astype(i),
            bvh_left=tree.box_left.astype(i),
            bvh_right=tree.box_right.astype(i),
            bvh_depth=tree.depth.astype(i),
            tri_inst=tri_inst,
            tri_prim=tri_prim,
            tri_local=tri_local,
            local_v0=local_v0.astype(f),
            local_e1=local_e1.astype(f),
            local_e2=local_e2.astype(f),
            inst_mesh_id=np.asarray(inst_mesh, i),
            inst_mat_id=np.asarray(inst_mat, i),
            inst_transform=(np.stack(inst_tf).astype(f) if inst_tf
                            else np.zeros((0, 3, 4), f)),
            inst_normal_mat=(np.stack(inst_nm).astype(f) if inst_nm
                             else np.zeros((0, 3, 3), f)),
            attr_oct_normal=attr_n.astype(f),
            attr_uv=attr_uv.astype(f),
            attr_tangent=attr_tan.astype(f),
            indices=indices.astype(i),
            mesh_vertex_offset=np.asarray(mesh_voff, i),
            mesh_index_offset=np.asarray(mesh_ioff, i),
            materials=materials,
            lights=lights,
            color_tex=textures_mod.pack_pairs(
                jnp.asarray(color_tex, jnp.bfloat16)),
            data_tex=textures_mod.pack_pairs(
                jnp.asarray(data_tex, jnp.bfloat16)),
            num_lights=len(self.lights),
            num_instances=len(self.instances),
            bvh_max_depth=tree.max_depth,
            tex_channels=tex_channels,
            instanced=False,
            world_tri_count=0,
            inst_grp=0,
        )
        import jax

        return jax.tree_util.tree_map(jnp.asarray, scene)

    def _build_instanced(self) -> CompiledScene:
        """Two-level shared-BLAS compile (src/scene/builder.rs:143-189
        economics, traced by trace_api._trace_instanced_xla):

          * ONE object-space triangle block per unique mesh
            (padded to grp*CT so chunk groups never span meshes) - memory
            is sum-of-unique-meshes, not instances x mesh size;
          * per-instance world->object affine + world AABB + normal
            matrix packed into inst_table [I, 23] - moving an instance is
            a transform update (refit.update_instances instanced branch),
            the TLAS-update analogue of builder.rs:454-468;
          * hits return (object tri, instance); ops/hit.py reconstructs
            attributes in object space and maps them through the
            instance's normal matrix.
        """
        import jax
        import jax.numpy as jnp

        from ..ops import textures as textures_mod
        from ..ops.intersect import CT, INST_GRP, pack_triangles_instanced

        unit = INST_GRP * CT
        i = np.int32
        f = np.float32

        # 1. global concatenated attributes / indices (API parity with
        # the flattened path; cheap, and keeps loaders interchangeable)
        attr_n, attr_uv, attr_tan, indices = [], [], [], []
        mesh_voff, mesh_ioff = [], []
        local_v0, local_e1, local_e2 = [], [], []
        mesh_tri_off = []
        v_off = i_off = t_off = 0
        for mesh in self.meshes:
            mesh_voff.append(v_off)
            mesh_ioff.append(i_off)
            mesh_tri_off.append(t_off)
            attr_n.append(mesh.oct_normals)
            attr_uv.append(mesh.uvs)
            attr_tan.append(mesh.tangents)
            indices.append(mesh.indices.astype(np.int32))
            tri = mesh.indices.reshape(-1, 3)
            p = mesh.positions
            local_v0.append(p[tri[:, 0]])
            local_e1.append(p[tri[:, 1]] - p[tri[:, 0]])
            local_e2.append(p[tri[:, 2]] - p[tri[:, 0]])
            v_off += len(mesh.positions)
            i_off += len(mesh.indices)
            t_off += mesh.num_triangles

        cat = lambda xs, w: (np.concatenate(xs, axis=0) if xs
                             else np.zeros((0, w) if w else (0,), np.float32))
        attr_n = cat(attr_n, 2)
        attr_uv = cat(attr_uv, 2)
        attr_tan = cat(attr_tan, 4)
        indices = (np.concatenate(indices) if indices
                   else np.zeros((0,), np.int32))
        local_v0 = cat(local_v0, 3)
        local_e1 = cat(local_e1, 3)
        local_e2 = cat(local_e2, 3)

        # 2. object-space packing per USED mesh (deduped: N instances of
        # one mesh share its block)
        used = sorted({m for m, _, _ in self.instances})
        slot = {m: k for k, m in enumerate(used)}
        mesh_tris = []
        obj_aabb_mesh = []        # per-used-mesh object AABB (for inst_aabb)
        for m in used:
            lo = mesh_tri_off[m]
            nt = self.meshes[m].num_triangles
            v0 = local_v0[lo:lo + nt]
            e1 = local_e1[lo:lo + nt]
            e2 = local_e2[lo:lo + nt]
            mesh_tris.append((v0, e1, e2))
            vs = np.concatenate([v0, v0 + e1, v0 + e2], axis=0)
            obj_aabb_mesh.append((vs.min(axis=0), vs.max(axis=0)))
        obj_planes, spans = pack_triangles_instanced(mesh_tris, grp=INST_GRP)
        tp_obj = obj_planes.shape[2]

        # 3. object-space shading rows [TpO, 35] at the PADDED layout
        # offsets (object tri id = column in obj_planes). Same column
        # layout as the flattened tri_table; cols 0:24 are OBJECT-space
        # (hit.py transforms through the instance normal matrix), col 25
        # unused (material is per-instance), cols 26:35 object v0/e1/e2.
        tri_table = np.zeros((tp_obj, 35), np.float32)
        tri_local = np.zeros((tp_obj,), np.int32)
        tri_prim = np.zeros((tp_obj,), np.int32)
        for m in used:
            base_g, ng = spans[0, slot[m]], spans[1, slot[m]]
            off = int(base_g) * unit
            lo = mesh_tri_off[m]
            mesh = self.meshes[m]
            nt = mesh.num_triangles
            tri = mesh.indices.reshape(-1, 3).astype(np.int64)
            n_obj = _oct_decode_np(mesh.oct_normals)
            blk = tri_table[off:off + nt]
            for k in range(3):
                blk[:, k * 3:k * 3 + 3] = n_obj[tri[:, k]]
                blk[:, 9 + k * 2:11 + k * 2] = mesh.uvs[tri[:, k]]
                blk[:, 15 + k * 3:18 + k * 3] = mesh.tangents[tri[:, k], :3]
            blk[:, 24] = mesh.tangents[tri[:, 0], 3]
            blk[:, 26:29] = local_v0[lo:lo + nt]
            blk[:, 29:32] = local_e1[lo:lo + nt]
            blk[:, 32:35] = local_e2[lo:lo + nt]
            tri_local[off:off + nt] = np.arange(lo, lo + nt, dtype=np.int32)
            tri_prim[off:off + nt] = np.arange(nt, dtype=np.int32)

        # 4. per-instance tables
        n_inst = len(self.instances)
        inst_table = np.zeros((max(n_inst, 1), 23), np.float32)
        inst_aabb = np.zeros((max(n_inst, 1), 8), np.float32)
        inst_obj_aabb = np.zeros((max(n_inst, 1), 6), np.float32)
        inst_mesh, inst_mat, inst_tf, inst_nm = [], [], [], []
        unit_inst, unit_group = [], []
        world_tris = 0
        for inst_id, (mesh_id, mat_id, tf) in enumerate(self.instances):
            a = tf[:3, :3].astype(np.float64)
            t = tf[:3, 3].astype(np.float64)
            a_inv = np.linalg.inv(a)
            nm = a_inv.T                       # world n = inv(A)^T @ obj n
            inst_table[inst_id, 0:9] = a_inv.reshape(-1)
            inst_table[inst_id, 9:12] = -(a_inv @ t)
            inst_table[inst_id, 12:21] = nm.reshape(-1)
            inst_table[inst_id, 21] = np.sign(np.linalg.det(a)) or 1.0
            inst_table[inst_id, 22] = mat_id
            mn, mx = obj_aabb_mesh[slot[mesh_id]]
            inst_obj_aabb[inst_id, 0:3] = mn
            inst_obj_aabb[inst_id, 3:6] = mx
            c_o = (mn + mx) * 0.5
            e_o = (mx - mn) * 0.5
            c_w = a @ c_o + t
            e_w = np.abs(a) @ e_o
            inst_aabb[inst_id, 0:3] = c_w - e_w
            inst_aabb[inst_id, 3:6] = c_w + e_w
            base_g, ng = spans[0, slot[mesh_id]], spans[1, slot[mesh_id]]
            unit_inst.extend([inst_id] * int(ng))
            unit_group.extend(range(int(base_g), int(base_g + ng)))
            world_tris += self.meshes[mesh_id].num_triangles
            inst_mesh.append(mesh_id)
            inst_mat.append(mat_id)
            inst_tf.append(tf[:3, :4].astype(np.float32))
            inst_nm.append(nm.astype(np.float32))

        (materials, mat_table, tex_channels, lights, light_table,
         color_tex, data_tex) = self._pack_tables()

        scene = CompiledScene(
            tri_planes=obj_planes,
            tri_table=tri_table,
            tri_table_local=np.zeros((1, 26), f),
            bvh_tri_rows=np.zeros((1,), i),
            mat_table=mat_table.astype(f),
            light_table=light_table.astype(f),
            bvh_rec=np.zeros((1, 12), f),        # no world BVH: the
            bvh_skip=np.full((1,), -1, i),       # instanced scan tests
            bvh_tri=np.zeros((1,), i),           # every (instance, unit)
            bvh_left=np.zeros((1,), i),
            bvh_right=np.zeros((1,), i),
            bvh_depth=np.zeros((1,), i),
            tri_inst=np.zeros((1,), i),
            tri_prim=tri_prim,
            tri_local=tri_local,
            local_v0=local_v0.astype(f),
            local_e1=local_e1.astype(f),
            local_e2=local_e2.astype(f),
            inst_mesh_id=np.asarray(inst_mesh, i),
            inst_mat_id=np.asarray(inst_mat, i),
            inst_transform=(np.stack(inst_tf) if inst_tf
                            else np.zeros((0, 3, 4), f)),
            inst_normal_mat=(np.stack(inst_nm) if inst_nm
                             else np.zeros((0, 3, 3), f)),
            inst_table=inst_table,
            inst_affine_inv=inst_table[:, :12].T.copy(),
            inst_aabb=inst_aabb,
            inst_obj_aabb=inst_obj_aabb,
            unit_inst=np.asarray(unit_inst, i),
            unit_group=np.asarray(unit_group, i),
            attr_oct_normal=attr_n.astype(f),
            attr_uv=attr_uv.astype(f),
            attr_tangent=attr_tan.astype(f),
            indices=indices.astype(i),
            mesh_vertex_offset=np.asarray(mesh_voff, i),
            mesh_index_offset=np.asarray(mesh_ioff, i),
            materials=materials,
            lights=lights,
            color_tex=textures_mod.pack_pairs(
                jnp.asarray(color_tex, jnp.bfloat16)),
            data_tex=textures_mod.pack_pairs(
                jnp.asarray(data_tex, jnp.bfloat16)),
            num_lights=len(self.lights),
            num_instances=n_inst,
            bvh_max_depth=0,
            tex_channels=tex_channels,
            instanced=True,
            world_tri_count=world_tris,
            inst_grp=INST_GRP,
        )
        return jax.tree_util.tree_map(jnp.asarray, scene)


def _empty_instanced_fields():
    """Instanced-intersector fields for a FLATTENED CompiledScene."""
    i = np.int32
    f = np.float32
    return dict(
        inst_table=np.zeros((0, 23), f),
        inst_affine_inv=np.zeros((12, 0), f),
        inst_aabb=np.zeros((0, 8), f),
        inst_obj_aabb=np.zeros((0, 6), f),
        unit_inst=np.zeros((0,), i),
        unit_group=np.zeros((0,), i),
    )
