"""BVH invariants + traversal vs brute-force ground truth (SURVEY.md §4.1)."""

import numpy as np
import jax.numpy as jnp

from tpu_raytracer.ops import bvh as bvh_ops
from tpu_raytracer.ops import traversal
from tpu_raytracer.scene import geometry


def _random_tris(n, seed=0, spread=4.0):
    r = np.random.default_rng(seed)
    v0 = (r.random((n, 3), np.float32) - 0.5) * spread
    e1 = (r.random((n, 3), np.float32) - 0.5)
    e2 = (r.random((n, 3), np.float32) - 0.5)
    return v0.astype(np.float32), e1.astype(np.float32), e2.astype(np.float32)


def _build(v0, e1, e2):
    v1, v2 = v0 + e1, v0 + e2
    mn = np.minimum(np.minimum(v0, v1), v2)
    mx = np.maximum(np.maximum(v0, v1), v2)
    tree = bvh_ops.build_bvh(mn, mx)
    bvh_ops.fill_triangles(tree, v0, e1, e2)
    return tree


def test_stream_structure_invariants():
    v0, e1, e2 = _random_tris(257, seed=1)
    tree = _build(v0, e1, e2)
    s = tree.size
    is_tri = tree.skip < 0
    # every triangle appears exactly once
    ids = np.sort(tree.tri_id[is_tri])
    assert (ids == np.arange(257)).all()
    # box skip targets are forward jumps within [i+1, S]
    boxes = np.where(~is_tri)[0]
    assert (tree.skip[boxes] > boxes).all()
    assert (tree.skip[boxes] <= s).all()
    # parent box contains children boxes
    for b in boxes:
        l, r = tree.box_left[b], tree.box_right[b]
        if l >= 0:
            for c in (l, r):
                assert (tree.rec[b, 0:3] <= tree.rec[c, 0:3] + 1e-6).all()
                assert (tree.rec[b, 3:6] >= tree.rec[c, 3:6] - 1e-6).all()


def test_traversal_matches_brute_force():
    v0, e1, e2 = _random_tris(300, seed=2)
    tree = _build(v0, e1, e2)
    r = np.random.default_rng(3)
    n_rays = 512
    ray_o = (r.random((n_rays, 3), np.float32) - 0.5) * 8.0
    ray_d = r.normal(size=(n_rays, 3)).astype(np.float32)
    ray_d /= np.linalg.norm(ray_d, axis=1, keepdims=True)

    got = traversal.trace(
        jnp.asarray(tree.rec), jnp.asarray(tree.skip), jnp.asarray(tree.tri_id),
        jnp.asarray(ray_o), jnp.asarray(ray_d), 1e-3, 1e4,
    )
    want = traversal.trace_brute(
        jnp.asarray(v0), jnp.asarray(e1), jnp.asarray(e2),
        jnp.asarray(ray_o), jnp.asarray(ray_d), 1e-3, 1e4,
    )
    got_t, want_t = np.asarray(got["t"]), np.asarray(want["t"])
    got_tri, want_tri = np.asarray(got["tri"]), np.asarray(want["tri"])
    hit = want_tri >= 0
    assert (got_tri >= 0).sum() == hit.sum()
    assert np.abs(np.where(hit, got_t - want_t, 0)).max() < 1e-4
    # tri ids can differ only where two tris intersect at (almost) equal t
    mismatch = (got_tri != want_tri) & hit
    assert np.abs(got_t[mismatch] - want_t[mismatch]).max(initial=0) < 1e-4


def test_any_hit_occlusion():
    v0, e1, e2 = _random_tris(100, seed=4)
    tree = _build(v0, e1, e2)
    r = np.random.default_rng(5)
    n_rays = 256
    ray_o = (r.random((n_rays, 3), np.float32) - 0.5) * 8.0
    ray_d = r.normal(size=(n_rays, 3)).astype(np.float32)
    ray_d /= np.linalg.norm(ray_d, axis=1, keepdims=True)
    occ = np.asarray(traversal.occluded(
        jnp.asarray(tree.rec), jnp.asarray(tree.skip), jnp.asarray(tree.tri_id),
        jnp.asarray(ray_o), jnp.asarray(ray_d), 1e-3, 1e4,
    ))
    want = np.asarray(traversal.trace_brute(
        jnp.asarray(v0), jnp.asarray(e1), jnp.asarray(e2),
        jnp.asarray(ray_o), jnp.asarray(ray_d), 1e-3, 1e4,
    )["tri"]) >= 0
    assert (occ == want).all()


def test_sphere_mesh_self_consistency():
    """Rays at an icosphere from outside: all centered rays hit near r=0.5."""
    mesh = geometry.create_sphere(3)
    tri = mesh.indices.reshape(-1, 3)
    v0 = mesh.positions[tri[:, 0]]
    e1 = mesh.positions[tri[:, 1]] - v0
    e2 = mesh.positions[tri[:, 2]] - v0
    tree = _build(v0, e1, e2)
    r = np.random.default_rng(6)
    d = r.normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = -d * 3.0
    res = traversal.trace(
        jnp.asarray(tree.rec), jnp.asarray(tree.skip), jnp.asarray(tree.tri_id),
        jnp.asarray(o), jnp.asarray(d), 1e-3, 1e4,
    )
    t = np.asarray(res["t"])
    assert (np.asarray(res["tri"]) >= 0).all()
    assert np.abs(t - 2.5).max() < 0.02  # hit distance ~= 3.0 - 0.5
    assert np.asarray(res["front"]).all()


def test_empty_scene():
    tree = bvh_ops.build_bvh(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32))
    res = traversal.trace(
        jnp.asarray(tree.rec), jnp.asarray(tree.skip), jnp.asarray(tree.tri_id),
        jnp.zeros((4, 3)), jnp.asarray([[0, 0, 1.0]] * 4), 1e-3, 1e4,
    )
    assert (np.asarray(res["tri"]) == -1).all()


def test_brute_max_routing_knob(monkeypatch):
    """Lowering trace_api.BRUTE_FORCE_MAX_TRIS reroutes the sweep to the
    stream-BVH pointer walk at TRACE time; both intersectors must agree
    on a real catalog scene, so moving the routing cap can never change
    images beyond exact-t ties."""
    import jax

    from tpu_raytracer.models import scenes
    from tpu_raytracer.ops import trace_api

    scene = scenes.create_cornell_box()
    rng = np.random.default_rng(61)
    r = 600
    ro = jnp.asarray(rng.uniform(-0.8, 0.8, (r, 3)).astype(np.float32))
    rd = rng.standard_normal((r, 3)).astype(np.float32)
    rd = jnp.asarray(rd / np.linalg.norm(rd, axis=-1, keepdims=True))

    swept = trace_api.scene_trace(scene, ro, rd, 1e-3, 50.0)
    monkeypatch.setattr(trace_api, "BRUTE_FORCE_MAX_TRIS", 1)  # the walk
    jax.clear_caches()
    walk = trace_api.scene_trace(scene, ro, rd, 1e-3, 50.0)
    jax.clear_caches()
    st, wt = np.asarray(swept["tri"]), np.asarray(walk["tri"])
    assert ((st >= 0) == (wt >= 0)).all()
    np.testing.assert_allclose(np.asarray(swept["t"]),
                               np.asarray(walk["t"]), rtol=1e-5)
    both = (st >= 0) & (wt >= 0)
    assert (st[both] == wt[both]).mean() > 0.99
