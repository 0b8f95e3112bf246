"""Instance-motion refit: retransformed scene must trace like a fresh build."""

import numpy as np
import jax.numpy as jnp

from tpu_raytracer.models import scenes
from tpu_raytracer.ops import refit, trace_api, traversal
from tpu_raytracer.scene.material import Material
from tpu_raytracer.scene.builder import SceneBuilder
from tpu_raytracer.scene.geometry import create_cube, create_plane
from tpu_raytracer.utils.math3d import rotation_y, scale, translation


def _two_box_scene(box_pos):
    b = SceneBuilder()
    plane_id = b.add_mesh(create_plane())
    cube_id = b.add_mesh(create_cube())
    mat = b.add_material(Material((0.7, 0.7, 0.7, 1.0)))
    b.add_instance(plane_id, mat, translation([0, -1, 0]) @ scale(4.0))
    b.add_instance(cube_id, mat,
                   translation(box_pos) @ rotation_y(0.3) @ scale(0.5))
    b.register_quad_light(plane_id, translation([0, 2, 0]) @ scale(0.5),
                          [1, 1, 1], 5.0)
    return b.build()


def _rays(n=512, seed=0):
    r = np.random.default_rng(seed)
    o = (r.random((n, 3), np.float32) - 0.5) * 6
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def test_update_instances_matches_fresh_build():
    scene = _two_box_scene([0.0, -0.5, 0.0])
    fresh = _two_box_scene([0.6, -0.2, 0.3])

    # move instance 1 (the cube) on device
    new_tf = np.stack([
        np.asarray(scene.inst_transform[0]),
        (translation([0.6, -0.2, 0.3]) @ rotation_y(0.3) @ scale(0.5))[:3, :4],
        np.asarray(scene.inst_transform[2]),
    ]).astype(np.float32)
    moved = refit.update_instances(scene, jnp.asarray(new_tf))

    ro, rd = _rays()
    got = trace_api.scene_trace(moved, ro, rd, 1e-3, 100.0)
    want = trace_api.scene_trace(fresh, ro, rd, 1e-3, 100.0)
    # same hit distances (triangle ids differ: independent BVH orders)
    hit_g = np.asarray(got["tri"]) >= 0
    hit_w = np.asarray(want["tri"]) >= 0
    assert (hit_g == hit_w).all()
    assert np.abs(np.where(hit_g, np.asarray(got["t"]) - np.asarray(want["t"]),
                           0)).max() < 1e-4

    # the refit BVH stream stays valid for the pointer-traversal path too
    got_bvh = traversal.trace(moved.bvh_rec, moved.bvh_skip, moved.bvh_tri,
                              ro, rd, 1e-3, 100.0)
    assert ((np.asarray(got_bvh["tri"]) >= 0) == hit_w).all()
    assert np.abs(np.where(hit_w, np.asarray(got_bvh["t"]) -
                           np.asarray(want["t"]), 0)).max() < 1e-4

    # shading rows: world normals follow the instance rotation
    tid = int(np.asarray(got["tri"])[np.argmax(hit_g)])
    row = np.asarray(moved.tri_table[tid])
    n0 = row[0:3] / np.linalg.norm(row[0:3])
    assert np.isfinite(n0).all()


def test_refit_changed_subset_matches_full():
    """changed=(i,) refit must produce the SAME compiled scene as the
    full-instance refit when only instance i moved (TLAS-update
    restriction, builder.rs:454-468)."""
    scene = _two_box_scene([0.0, -0.5, 0.0])
    new_tf = np.stack([
        np.asarray(scene.inst_transform[0]),
        (translation([0.6, -0.2, 0.3]) @ rotation_y(0.9) @ scale(0.5))[:3, :4],
        np.asarray(scene.inst_transform[2]),
    ]).astype(np.float32)
    full = refit.update_instances(scene, jnp.asarray(new_tf))
    part = refit.update_instances(scene, jnp.asarray(new_tf), changed=(1,))

    for field in ("tri_planes", "tri_table", "bvh_rec",
                  "inst_transform", "inst_normal_mat"):
        a = np.asarray(getattr(full, field))
        b = np.asarray(getattr(part, field))
        assert np.allclose(a, b, atol=1e-5), field


def test_refit_repack_preserves_trace():
    """repack=True (Morton re-sort, the full-rebuild TLAS mode analog)
    must not change ANY trace result - brute path AND the unified-stream
    BVH path (whose tri-id mapping must follow the permutation)."""
    scene = _two_box_scene([0.0, -0.5, 0.0])
    new_tf = np.stack([
        np.asarray(scene.inst_transform[0]),
        (translation([0.9, -0.1, 0.6]) @ rotation_y(1.3) @ scale(0.5))[:3, :4],
        np.asarray(scene.inst_transform[2]),
    ]).astype(np.float32)
    plain = refit.update_instances(scene, jnp.asarray(new_tf))
    packed = refit.update_instances(scene, jnp.asarray(new_tf), repack=True)

    ro, rd = _rays()
    want = trace_api.scene_trace(plain, ro, rd, 1e-3, 100.0)
    got = trace_api.scene_trace(packed, ro, rd, 1e-3, 100.0)
    hit_w = np.asarray(want["tri"]) >= 0
    assert ((np.asarray(got["tri"]) >= 0) == hit_w).all()
    assert np.abs(np.where(hit_w, np.asarray(got["t"]) -
                           np.asarray(want["t"]), 0)).max() < 1e-4
    # shading row of the winner must be the SAME triangle's data
    lane = int(np.argmax(hit_w))
    row_w = np.asarray(plain.tri_table)[int(np.asarray(want["tri"])[lane])]
    row_g = np.asarray(packed.tri_table)[int(np.asarray(got["tri"])[lane])]
    assert np.allclose(row_w, row_g, atol=1e-5)

    got_bvh = traversal.trace(packed.bvh_rec, packed.bvh_skip,
                              packed.bvh_tri, ro, rd, 1e-3, 100.0)
    assert ((np.asarray(got_bvh["tri"]) >= 0) == hit_w).all()
    # BVH path returns ids in the packed order; winner row must match
    row_b = np.asarray(packed.tri_table)[
        int(np.asarray(got_bvh["tri"])[lane])]
    assert np.allclose(row_w, row_b, atol=1e-5)
    # refit AFTER a repack still works (tri_local/bvh_tri_rows followed)
    again = refit.update_instances(packed, jnp.asarray(new_tf))
    got2 = trace_api.scene_trace(again, ro, rd, 1e-3, 100.0)
    assert np.abs(np.where(hit_w, np.asarray(got2["t"]) -
                           np.asarray(want["t"]), 0)).max() < 1e-4


def test_refit_identity_is_noop():
    scene = scenes.create_cornell_box_diffuse()
    moved = refit.update_instances(scene, scene.inst_transform)
    assert np.allclose(np.asarray(moved.tri_planes),
                       np.asarray(scene.tri_planes), atol=1e-5)
    assert np.allclose(np.asarray(moved.tri_table),
                       np.asarray(scene.tri_table), atol=1e-5)
    # refit boxes must CONTAIN the originals (equal here, identity motion)
    rec0 = np.asarray(scene.bvh_rec)
    rec1 = np.asarray(moved.bvh_rec)
    boxes = np.asarray(scene.bvh_skip) >= 0
    assert np.abs(rec1[boxes, 0:6] - rec0[boxes, 0:6]).max() < 1e-4


def test_changed_cache_evicts_on_scene_gc_and_stays_bounded(monkeypatch):
    """The changed-refit cache keys on id(tri_inst), which CPython can
    recycle after the original scene is garbage-collected - the weakref
    finalizer must evict the entry the moment its keying array dies, so
    a recycled id can never serve another scene's host-resolved index
    sets. The cache is also FIFO-bounded."""
    import gc

    refit._CHANGED_CACHE.clear()
    scene = _two_box_scene([0.0, 0.0, 0.0])
    tf = [np.asarray(t, np.float32) for t in
          (translation([0, -1, 0]) @ scale(4.0),
           translation([0.2, 0, 0]) @ rotation_y(0.3) @ scale(0.5))]
    refit.update_instances(scene, np.stack(tf), changed=(1,))
    assert len(refit._CHANGED_CACHE) == 1
    key = next(iter(refit._CHANGED_CACHE))
    assert key[0] == id(scene.tri_inst)

    del scene
    gc.collect()
    assert key not in refit._CHANGED_CACHE, (
        "entry must die with its keying array (id-reuse safety)")

    # FIFO bound: distinct (scene, changed) keys never exceed the cap
    monkeypatch.setattr(refit, "_CHANGED_CACHE_MAX", 2)
    scene2 = _two_box_scene([0.3, 0.0, 0.0])
    for changed in ((0,), (1,), (0, 1)):
        refit.update_instances(scene2, np.stack(tf), changed=changed)
    assert len(refit._CHANGED_CACHE) <= 2
    assert (id(scene2.tri_inst), (0,)) not in refit._CHANGED_CACHE

    # and two scenes alive at once resolve to their OWN index sets
    scene3 = _two_box_scene([-0.4, 0.0, 0.0])
    out2 = refit.update_instances(scene2, np.stack(tf), changed=(1,))
    out3 = refit.update_instances(scene3, np.stack(tf), changed=(1,))
    o, d = _rays()
    t2 = trace_api.scene_trace(scene2, o, d, 1e-3, 100.0)["t"]
    t2b = trace_api.scene_trace(out2, o, d, 1e-3, 100.0)["t"]
    t3b = trace_api.scene_trace(out3, o, d, 1e-3, 100.0)["t"]
    del t2
    # both refits moved the SAME cube to the SAME world transform, so
    # their traces agree with each other (cross-served index sets from a
    # shared cache entry would corrupt one of them)
    np.testing.assert_allclose(np.asarray(t2b), np.asarray(t3b), atol=1e-5)


def test_refit_does_not_recompile_per_frame():
    """Per-frame refit must be ONE cached jitted dispatch (config 4 calls
    it every fly-through frame; run eagerly the _refit_boxes fori_loop
    re-traced with fresh closure constants and XLA recompiled its scan
    EVERY frame - ~0.4 s/frame on CPU)."""
    scene = _two_box_scene([0.0, -0.5, 0.0])
    base = np.asarray(scene.inst_transform)

    def tf(i):
        out = base.copy()
        out[1] = (translation([0.1 * i, -0.2, 0.0]) @ scale(0.5))[:3, :4]
        return jnp.asarray(out)

    # warm both paths, then snapshot cache sizes
    s_full = refit.update_instances(scene, tf(0))
    refit.update_instances(scene, tf(0), changed=(1,))
    full_n = refit._update_full._cache_size()
    changed_n = refit._changed_device._cache_size()
    for i in range(1, 4):
        s_full = refit.update_instances(scene, tf(i))
        refit.update_instances(scene, tf(i), changed=(1,))
    assert refit._update_full._cache_size() == full_n
    assert refit._changed_device._cache_size() == changed_n
    # a different changed-set is a NEW static key (expected retrace)
    refit.update_instances(scene, tf(1), changed=(0, 1))
    assert refit._changed_device._cache_size() == changed_n + 1
    # and the jitted path still traces correctly after the loop
    o, d = _rays()
    t = np.asarray(trace_api.scene_trace(s_full, o, d, 1e-3, 100.0)["t"])
    assert np.isfinite(t).any()
