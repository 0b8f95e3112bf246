"""On-device scene refit: per-frame instance motion (TLAS-update analog).

The reference rebuilds its driver TLAS to move instances
(builder.rs:454-468, AccelerationStructureUpdateMode::Build); the JAX
equivalent is a fully-jitted retransform of every derived structure from
object-space data + new per-instance affines:

  * world triangle soup -> intersector planes (tri_planes),
  * the consolidated world-space shading rows (tri_table) from the
    object-space copy (tri_table_local) via inverse-transpose normal math,
  * instance transform / normal-matrix tables,
  * BVH box records bottom-up (level-ordered masked sweeps) for the
    large-scene traversal path.

Topology is untouched (same BVH structure, refit only) - matching the
semantics of a driver TLAS update. `update_instances` is safe to call
every frame inside the render step (BASELINE.md config 4).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp


def _affine(transforms):
    """[I, 3, 4] or [I, 4, 4] -> (A [I,3,3], t [I,3], normal_mat [I,3,3])."""
    transforms = jnp.asarray(transforms, jnp.float32)
    a = transforms[:, :3, :3]
    t = transforms[:, :3, 3]
    nm = jnp.swapaxes(jnp.linalg.inv(a), -1, -2)
    return a, t, nm


def update_instances(scene, transforms, changed=None, repack=False):
    """Return a new CompiledScene with instances moved to `transforms`.

    transforms: [I, 3, 4] or [I, 4, 4] object->world affines (all
    instances; pass scene.inst_transform rows for unchanged ones).

    changed: optional STATIC tuple of instance ids that actually moved
    (builder.rs:454-468 updates the whole TLAS; restricting the refit to
    the moved instances' triangle ranges makes per-frame cost scale with
    moved geometry, not scene size - the triangle indices are resolved
    host-side once per `changed` set, so everything stays static-shaped
    under jit). With changed=None every instance is re-transformed.

    repack: additionally re-sort the triangle stream by Morton code
    (ops/lbvh.py) so chunk culling stays tight after LARGE motion - the
    analog of the reference's full-rebuild TLAS update mode
    (AccelerationStructureUpdateMode::Build, builder.rs:465). Refit
    alone preserves order; repack restores spatial coherence of the
    triangle stream at the cost of an on-device sort.
    """
    if scene.instanced:
        # Two-level mode: geometry is object-space and SHARED, so moving
        # instances is a pure O(I) transform-table update - the real
        # TLAS-update economics of builder.rs:454-468. `changed`/`repack`
        # are no-ops here (the whole update is already instance-count
        # sized and the object blocks never need re-sorting).
        return _update_instanced(scene, transforms)
    if repack:
        from .lbvh import morton_reorder

        full = update_instances(scene, transforms, changed=None)
        return morton_reorder(full)
    if changed is not None:
        return _update_changed(scene, transforms, tuple(sorted(changed)))
    return _update_full(scene, jnp.asarray(transforms, jnp.float32))


@jax.jit
def _update_full(scene, transforms):
    """Whole-scene refit, ONE jitted dispatch per frame.

    Jitting matters beyond fusion: run eagerly, the `_refit_boxes`
    fori_loop re-traces per call with fresh closure constants
    (`jnp.maximum(scene.bvh_left, 0)` makes a new array each call), so
    XLA recompiled the level scan EVERY frame (~0.4 s/frame on CPU) -
    exactly the per-frame cost config 4 pays. Under jit the trace is
    cached on scene SHAPE (CompiledScene's meta fields are static), so
    steady-state frames are a single cached dispatch."""
    a, t, nm = _affine(transforms)
    inst = scene.tri_inst                      # [T]
    a_t = a[inst]                              # [T, 3, 3]
    t_t = t[inst]
    nm_t = nm[inst]

    lv0 = scene.local_v0[scene.tri_local]
    le1 = scene.local_e1[scene.tri_local]
    le2 = scene.local_e2[scene.tri_local]
    wv0 = jnp.einsum("tij,tj->ti", a_t, lv0) + t_t
    we1 = jnp.einsum("tij,tj->ti", a_t, le1)
    we2 = jnp.einsum("tij,tj->ti", a_t, le2)

    # --- intersector planes ---
    t_count = wv0.shape[0]
    planes = scene.tri_planes
    planes = planes.at[0, :, :t_count].set(wv0.T)
    planes = planes.at[1, :, :t_count].set(we1.T)
    planes = planes.at[2, :, :t_count].set(we2.T)

    wv1 = wv0 + we1
    wv2 = wv0 + we2
    mn = jnp.minimum(jnp.minimum(wv0, wv1), wv2)
    mx = jnp.maximum(jnp.maximum(wv0, wv1), wv2)

    # --- world shading rows from object-space copy ---
    tl = scene.tri_table_local
    tri_table = scene.tri_table
    for k in range(3):
        n_w = jnp.einsum("tij,tj->ti", nm_t, tl[:, k * 3:k * 3 + 3])
        t_w = jnp.einsum("tij,tj->ti", nm_t, tl[:, 15 + k * 3:18 + k * 3])
        tri_table = tri_table.at[:, k * 3:k * 3 + 3].set(n_w)
        tri_table = tri_table.at[:, 15 + k * 3:18 + k * 3].set(t_w)
    # world geometry columns (26:35) used by reconstruct_hit's exact
    # u/v/front recompute
    tri_table = tri_table.at[:, 26:29].set(wv0)
    tri_table = tri_table.at[:, 29:32].set(we1)
    tri_table = tri_table.at[:, 32:35].set(we2)

    # --- BVH: triangle records + bottom-up box refit ---
    rec = scene.bvh_rec
    rows = scene.bvh_tri_rows
    rec = rec.at[rows, 0:3].set(wv0)
    rec = rec.at[rows, 3:6].set(we1)
    rec = rec.at[rows, 6:9].set(we2)
    rec = _refit_boxes(scene, rec, mn, mx)

    return dataclasses.replace(
        scene,
        tri_planes=planes,
        tri_table=tri_table,
        bvh_rec=rec,
        inst_transform=jnp.asarray(transforms, jnp.float32)[:, :3, :4],
        inst_normal_mat=nm,
    )


@jax.jit
def _update_instanced(scene, transforms):
    """Instanced-scene refit: rebuild inst_table / inst_affine_inv /
    inst_aabb from new object->world affines. O(instances) device work;
    object triangle blocks are untouched."""
    a, t, nm = _affine(transforms)
    n_i = a.shape[0]
    a_inv = jnp.linalg.inv(a)
    b = -jnp.einsum("iab,ib->ia", a_inv, t)
    det = jnp.linalg.det(a)
    detsign = jnp.where(det >= 0.0, 1.0, -1.0)
    inst_table = jnp.concatenate(
        [a_inv.reshape(n_i, 9), b, nm.reshape(n_i, 9),
         detsign[:, None], scene.inst_table[:, 22:23]], axis=1)

    mn_o = scene.inst_obj_aabb[:, 0:3]
    mx_o = scene.inst_obj_aabb[:, 3:6]
    c_o = (mn_o + mx_o) * 0.5
    e_o = (mx_o - mn_o) * 0.5
    c_w = jnp.einsum("iab,ib->ia", a, c_o) + t
    e_w = jnp.einsum("iab,ib->ia", jnp.abs(a), e_o)
    inst_aabb = (scene.inst_aabb
                 .at[:, 0:3].set(c_w - e_w)
                 .at[:, 3:6].set(c_w + e_w))
    return dataclasses.replace(
        scene,
        inst_table=inst_table,
        inst_affine_inv=inst_table[:, :12].T,
        inst_aabb=inst_aabb,
        inst_transform=jnp.asarray(transforms, jnp.float32)[:, :3, :4],
        inst_normal_mat=nm,
    )


_CHANGED_CACHE: dict = {}
_CHANGED_CACHE_MAX = 64


def _update_changed(scene, transforms, changed):
    """Refit restricted to `changed` instances' triangle ranges.

    Host-resolves the static triangle/row index sets once per
    (scene, changed) pair; per-frame device work is then
    O(moved triangles) einsums + O(T) elementwise box reductions
    (the latter are trivial next to the transforms).

    Cache entries are keyed on id(tri_inst) but carry a weakref to the
    keying array whose finalizer evicts the entry - a recycled CPython id
    (the original scene garbage-collected, a new array reusing its id)
    can never serve another scene's index sets. The cache is also bounded
    (FIFO eviction) so long-lived processes don't pin old device arrays."""
    import weakref

    import numpy as np

    if not changed:
        return scene
    key = (id(scene.tri_inst), changed)
    if key not in _CHANGED_CACHE:
        inst_h = np.asarray(scene.tri_inst)
        sel_np = np.where(np.isin(inst_h, np.asarray(changed)))[0]
        sel_np = sel_np.astype(np.int32)
        remap = np.zeros(max(int(inst_h.max(initial=0)) + 1, 1), np.int32)
        for j, ci in enumerate(changed):
            remap[ci] = j
        while len(_CHANGED_CACHE) >= _CHANGED_CACHE_MAX:
            _CHANGED_CACHE.pop(next(iter(_CHANGED_CACHE)))
        try:
            guard = weakref.ref(
                scene.tri_inst, lambda _r, k=key: _CHANGED_CACHE.pop(k, None))
        except TypeError:   # plain np.ndarray (host-only tests): no weakref
            guard = None
        _CHANGED_CACHE[key] = (
            jnp.asarray(sel_np),
            jnp.asarray(np.asarray(scene.tri_local)[sel_np]),
            jnp.asarray(remap[inst_h[sel_np]]),
            jnp.asarray(np.asarray(scene.bvh_tri_rows)[sel_np]),
            guard,
        )
    sel, local, sub_inst, rows, _guard = _CHANGED_CACHE[key]
    return _changed_device(scene, jnp.asarray(transforms, jnp.float32),
                           sel, local, sub_inst, rows, changed)


@functools.partial(jax.jit, static_argnames=("changed",))
def _changed_device(scene, tf_all, sel, local, sub_inst, rows, changed):
    """Device half of the changed-instance refit - ONE jitted dispatch
    (see `_update_full` for why eager refit recompiled every frame);
    `changed` is static so the per-changed-set index constants fold."""
    tf = tf_all[jnp.asarray(changed)]
    a, t, nm = _affine(tf)
    a_t, t_t, nm_t = a[sub_inst], t[sub_inst], nm[sub_inst]
    lv0 = scene.local_v0[local]
    le1 = scene.local_e1[local]
    le2 = scene.local_e2[local]
    wv0 = jnp.einsum("tij,tj->ti", a_t, lv0) + t_t      # [S, 3]
    we1 = jnp.einsum("tij,tj->ti", a_t, le1)
    we2 = jnp.einsum("tij,tj->ti", a_t, le2)

    planes = scene.tri_planes
    planes = planes.at[0, :, sel].set(wv0)
    planes = planes.at[1, :, sel].set(we1)
    planes = planes.at[2, :, sel].set(we2)

    # per-triangle boxes over the UPDATED planes (cheap elementwise O(T))
    t_count = scene.tri_inst.shape[0]
    v0 = planes[0, :, :t_count].T
    v1 = v0 + planes[1, :, :t_count].T
    v2 = v0 + planes[2, :, :t_count].T
    mn = jnp.minimum(jnp.minimum(v0, v1), v2)
    mx = jnp.maximum(jnp.maximum(v0, v1), v2)

    tl_sel = scene.tri_table_local[sel]
    tri_table = scene.tri_table
    for k in range(3):
        n_w = jnp.einsum("tij,tj->ti", nm_t, tl_sel[:, k * 3:k * 3 + 3])
        t_w = jnp.einsum("tij,tj->ti", nm_t,
                         tl_sel[:, 15 + k * 3:18 + k * 3])
        tri_table = tri_table.at[sel, k * 3:k * 3 + 3].set(n_w)
        tri_table = tri_table.at[sel, 15 + k * 3:18 + k * 3].set(t_w)
    tri_table = tri_table.at[sel, 26:29].set(wv0)
    tri_table = tri_table.at[sel, 29:32].set(we1)
    tri_table = tri_table.at[sel, 32:35].set(we2)

    rec = scene.bvh_rec
    rec = rec.at[rows, 0:3].set(wv0)
    rec = rec.at[rows, 3:6].set(we1)
    rec = rec.at[rows, 6:9].set(we2)
    rec = _refit_boxes(scene, rec, mn, mx)

    ch = jnp.asarray(changed)
    inst_tf = scene.inst_transform.at[ch].set(tf[:, :3, :4])
    inst_nm = scene.inst_normal_mat.at[ch].set(nm)
    return dataclasses.replace(
        scene,
        tri_planes=planes,
        tri_table=tri_table,
        bvh_rec=rec,
        inst_transform=inst_tf,
        inst_normal_mat=inst_nm,
    )


def _refit_boxes(scene, rec, tri_mn, tri_mx):
    """Bottom-up AABB refit of the unified stream's box records.

    Leaf boxes take the min/max over their (up to LEAF_SIZE) triangle
    records; inner boxes the union of their two children. Processes depths
    max..0 with masked whole-array updates - O(max_depth) sweeps, fully
    vectorized (a few dense passes instead of a serial tree walk).
    """
    from .bvh import LEAF_SIZE

    s = rec.shape[0]
    is_box = scene.bvh_skip >= 0
    is_leaf_box = is_box & (scene.bvh_left < 0)
    idx = jnp.arange(s, dtype=jnp.int32)

    # leaf boxes: triangles are the records idx+1 .. skip-1
    leaf_mn = jnp.full((s, 3), 3.0e38, jnp.float32)
    leaf_mx = jnp.full((s, 3), -3.0e38, jnp.float32)
    for k in range(LEAF_SIZE):
        child = jnp.clip(idx + 1 + k, 0, s - 1)
        in_range = (idx + 1 + k) < scene.bvh_skip
        tid = jnp.maximum(scene.bvh_tri[child], 0)
        ok = (is_leaf_box & in_range)[:, None]
        leaf_mn = jnp.where(ok, jnp.minimum(leaf_mn, tri_mn[tid]), leaf_mn)
        leaf_mx = jnp.where(ok, jnp.maximum(leaf_mx, tri_mx[tid]), leaf_mx)

    new_mn = jnp.where(is_leaf_box[:, None], leaf_mn, rec[:, 0:3])
    new_mx = jnp.where(is_leaf_box[:, None], leaf_mx, rec[:, 3:6])

    max_depth = int(scene.bvh_max_depth)
    left = jnp.maximum(scene.bvh_left, 0)
    right = jnp.maximum(scene.bvh_right, 0)
    is_inner = is_box & (scene.bvh_left >= 0)

    def level(d, carry):
        mn, mx = carry
        at_level = is_inner & (scene.bvh_depth == max_depth - 1 - d)
        u_mn = jnp.minimum(mn[left], mn[right])
        u_mx = jnp.maximum(mx[left], mx[right])
        mn = jnp.where(at_level[:, None], u_mn, mn)
        mx = jnp.where(at_level[:, None], u_mx, mx)
        return mn, mx

    new_mn, new_mx = jax.lax.fori_loop(0, max_depth, level, (new_mn, new_mx))
    rec = rec.at[:, 0:3].set(jnp.where(is_box[:, None], new_mn, rec[:, 0:3]))
    rec = rec.at[:, 3:6].set(jnp.where(is_box[:, None], new_mx, rec[:, 3:6]))
    return rec
