"""Compiled scene resources: the pytree of device arrays a render consumes.

This is the JAX analogue of the reference's `SceneResources`
(src/scene/resources.rs:11-22): instead of driver-owned TLAS/BLAS handles and
GPU buffer objects, everything is a JAX array in one pytree, so the whole
scene can be donated, sharded (replicated per device - scenes are small next
to device memory), and threaded through jitted render steps.

Static (non-array) facts live in metadata fields so jit re-traces only when
the scene's *shape* changes, not its contents.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import numpy as np


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "tri_planes", "tri_table", "tri_table_local",
        "mat_table", "light_table", "bvh_tri_rows",
        "bvh_rec", "bvh_skip", "bvh_tri",
        "bvh_left", "bvh_right", "bvh_depth",
        "tri_inst", "tri_prim", "tri_local",
        "local_v0", "local_e1", "local_e2",
        "inst_mesh_id", "inst_mat_id", "inst_transform", "inst_normal_mat",
        "inst_table", "inst_affine_inv", "inst_aabb", "inst_obj_aabb",
        "unit_inst", "unit_group",
        "attr_oct_normal", "attr_uv", "attr_tangent",
        "indices", "mesh_vertex_offset", "mesh_index_offset",
        "materials", "lights",
        "color_tex", "data_tex",
    ],
    meta_fields=["num_lights", "num_instances", "bvh_max_depth",
                 "tex_channels", "instanced", "world_tri_count",
                 "inst_grp"],
)
@dataclasses.dataclass
class CompiledScene:
    # --- swept intersector planes (see ops/intersect.pack_triangles) ---
    tri_planes: jax.Array   # [4, 3, Tp] f32 (v0 | e1 | e2 | valid-mask)

    # --- consolidated shading tables (one wide gather per hit; ops/hit.py) ---
    # tri_table [T, 35]; cols 26:35 = world v0 | e1 | e2 (exact u/v/front
    # recompute in ops/hit.py). Cols 0:26: world n0 n1 n2 (9) | uv0 uv1 uv2 (6) |
    #                    world t0 t1 t2 (9) | tangent sign | mat_id
    tri_table: jax.Array
    # tri_table in OBJECT space (same layout; world = per-instance transform
    # applied at refit time, ops/refit.py)
    tri_table_local: jax.Array
    # mat_table [M, 17]: base_color(4) emissive(3) roughness metallic
    #                    transmission ior light_index tex ids(5)
    mat_table: jax.Array
    # stream row index of each triangle's record in the BVH stream [T] i32
    bvh_tri_rows: jax.Array
    # light_table [L, 15]: position(3) type u(3) area v(3) emission(4)
    light_table: jax.Array

    # --- traversal stream (see ops/bvh.py) ---
    bvh_rec: jax.Array      # [S, 12] f32
    bvh_skip: jax.Array     # [S] i32
    bvh_tri: jax.Array      # [S] i32 (original world-triangle id; -1 for boxes)
    bvh_left: jax.Array     # [S] i32 (refit: left child box; -1 if leaf/tri)
    bvh_right: jax.Array    # [S] i32
    bvh_depth: jax.Array    # [S] i32

    # --- per world triangle (original order) ---
    tri_inst: jax.Array     # [T] i32 instance id
    tri_prim: jax.Array     # [T] i32 primitive index within its mesh
    tri_local: jax.Array    # [T] i32 index into local_* concatenated tri arrays

    # --- per mesh-local triangle (for TLAS-style refit under new transforms) ---
    local_v0: jax.Array     # [TL, 3] f32 object-space v0
    local_e1: jax.Array     # [TL, 3] f32
    local_e2: jax.Array     # [TL, 3] f32

    # --- per instance ---
    inst_mesh_id: jax.Array    # [I] i32
    inst_mat_id: jax.Array     # [I] i32
    inst_transform: jax.Array  # [I, 3, 4] f32 object->world affine
    inst_normal_mat: jax.Array  # [I, 3, 3] f32 (world normal = nm @ local n)

    # --- two-level INSTANCED intersector (shared-BLAS analogue; empty for
    # flattened scenes - see ops/trace_api._trace_instanced_xla) ---
    # inst_table [I, 23]: A^-1 (9) | b (3) | nm (9) | det-sign | mat_id -
    # the per-hit reconstruction row (ops/hit.py instanced branch)
    inst_table: jax.Array
    inst_affine_inv: jax.Array  # [12, I] f32 world->object, transposed
    inst_aabb: jax.Array        # [I, 8] f32 instance WORLD AABBs
    inst_obj_aabb: jax.Array    # [I, 6] f32 mesh OBJECT AABB (refit input)
    unit_inst: jax.Array        # [NU] i32 instance of each scan unit
    unit_group: jax.Array       # [NU] i32 object chunk group of each unit

    # --- global concatenated vertex attributes (builder.rs:123-141 layout) ---
    attr_oct_normal: jax.Array  # [A, 2] f32
    attr_uv: jax.Array          # [A, 2] f32
    attr_tangent: jax.Array     # [A, 4] f32
    indices: jax.Array          # [Itot] i32
    mesh_vertex_offset: jax.Array  # [Msh] i32
    mesh_index_offset: jax.Array   # [Msh] i32

    # --- tables ---
    materials: dict          # SoA dict, see material.pack_materials
    lights: dict             # SoA dict, see light.pack_lights

    # --- texture arrays (1024x1024, bf16, 2x2-QUAD packed for 1-gather
    # bilinear; color pre-decoded sRGB->linear) ---
    color_tex: jax.Array     # [C, H, W, 12]
    data_tex: jax.Array      # [D, H, W, 12]

    # --- static metadata ---
    num_lights: int
    num_instances: int
    bvh_max_depth: int
    # which texture channels exist anywhere in the scene - sampling for an
    # absent channel is compiled out entirely (frozenset of:
    # "color", "normal", "occlusion", "emissive", "metallic_roughness")
    tex_channels: frozenset
    # two-level instanced mode: tri_planes/tri_table are OBJECT-space and
    # shared across instances; traces return (t, obj tri, inst)
    instanced: bool
    # logical world triangle count (= sum of instanced mesh sizes); equals
    # len(tri_inst) for flattened scenes
    world_tri_count: int
    inst_grp: int   # chunk-group width of the instanced object layout

    @property
    def num_triangles(self) -> int:
        if self.world_tri_count:
            return int(self.world_tri_count)
        return int(self.tri_inst.shape[0])


def to_device(scene: "CompiledScene") -> "CompiledScene":
    """Move all host numpy arrays onto the default device."""
    return jax.tree_util.tree_map(jax.numpy.asarray, scene)


def checkpoint_state(accum, reservoirs, frame_count: int, camera_state: dict) -> dict:
    """Serializable pause/resume state (SURVEY.md §5 checkpoint plan)."""
    return {
        "accum": np.asarray(accum),
        "reservoirs": jax.tree_util.tree_map(np.asarray, reservoirs),
        "frame_count": frame_count,
        "camera_state": camera_state,
    }
