"""The sweep kernel (ops/sweep_kernel.py, interpret mode) against the CPU
oracle, plus its wrapper: padding, the tie rule, any-hit early exit."""

import jax.numpy as jnp
import numpy as np
import pytest

from route_cases import RAY_SETS, TRI_COUNTS, check, rays, tris
from tpu_raytracer.ops import sweep_kernel, trace_api
from tpu_raytracer.ops.intersect import pack_triangles


@pytest.mark.parametrize("n_tris", TRI_COUNTS)
@pytest.mark.parametrize("kind", RAY_SETS)
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_kernel_matches_oracle(n_tris, kind, any_hit):
    v0, e1, e2 = tris(n_tris)
    o, d, t_max, active = rays(kind, v0, e1, e2)
    res = sweep_kernel.trace_sweep(
        jnp.asarray(pack_triangles(v0, e1, e2)), jnp.asarray(o),
        jnp.asarray(d), 1e-3, jnp.asarray(t_max), any_hit=any_hit,
        active=None if active is None else jnp.asarray(active),
        interpret=True)
    check(res["tri"], res["t"], v0, e1, e2, o, d, t_max, active, any_hit)


def test_kernel_pads_rays_and_component_tuples():
    """R not a multiple of the block: padding lanes are cut off, and the
    wavefront's component tuples give the same answer as [R, 3] arrays."""
    v0, e1, e2 = tris(129)
    o, d, t_max, _ = rays("camera", v0, e1, e2)
    o, d = o[:50], d[:50]
    planes = jnp.asarray(pack_triangles(v0, e1, e2))
    a = sweep_kernel.trace_sweep(planes, jnp.asarray(o), jnp.asarray(d),
                                 1e-3, 100.0, interpret=True)
    b = sweep_kernel.trace_sweep(
        planes, tuple(jnp.asarray(o[:, k]) for k in range(3)),
        tuple(jnp.asarray(d[:, k]) for k in range(3)), 1e-3, 100.0,
        interpret=True)
    assert a["tri"].shape == (50,)
    np.testing.assert_array_equal(np.asarray(a["tri"]), np.asarray(b["tri"]))
    np.testing.assert_array_equal(np.asarray(a["t"]), np.asarray(b["t"]))


def test_kernel_pack_rays_layout():
    o = jnp.arange(15, dtype=jnp.float32).reshape(5, 3)
    d = -o
    act = jnp.asarray([True, False, True, True, False])
    packed, r = sweep_kernel.pack_rays(o, d, 0.5, 7.0, act)
    assert r == 5 and packed.shape == (8, sweep_kernel.BLOCK_R)
    np.testing.assert_array_equal(packed[:3, :5], np.asarray(o).T)
    np.testing.assert_array_equal(packed[3:6, :5], -np.asarray(o).T)
    np.testing.assert_array_equal(packed[6, :5], 0.5)
    np.testing.assert_array_equal(packed[7, :5], [7, 0, 7, 7, 0])
    assert (packed[:, 5:] == 0).all()          # padding lanes: t_max 0


def test_kernel_rejects_ragged_triangle_count():
    with pytest.raises(ValueError, match="multiple of chunk"):
        sweep_kernel.trace_sweep(jnp.zeros((4, 3, 44)), jnp.zeros((4, 3)),
                                 jnp.ones((4, 3)), 1e-3, 1.0,
                                 interpret=True)


def test_kernel_tie_goes_to_lowest_index():
    """Duplicate triangles hit at exactly the same t, in one chunk and in
    different chunks: the lowest index wins, as in the XLA sweep."""
    v0 = np.zeros((200, 3), np.float32)
    e1 = np.tile([[1.0, 0.0, 0.0]], (200, 1)).astype(np.float32)
    e2 = np.tile([[0.0, 0.0, 1.0]], (200, 1)).astype(np.float32)
    v0[:] = [0.0, -5.0, 0.0]                   # all far away ...
    for k in (5, 7, 70, 150):                  # ... but four duplicates,
        v0[k] = [0.0, 0.0, 0.0]                # two in the same chunk
    planes = jnp.asarray(pack_triangles(v0, e1, e2))
    o = jnp.asarray([[0.2, 1.0, 0.2], [0.1, 2.0, 0.3]], jnp.float32)
    d = jnp.asarray([[0.0, -1.0, 0.0]] * 2, jnp.float32)
    got = sweep_kernel.trace_sweep(planes, o, d, 1e-3, 3.0, interpret=True)
    want = trace_api._trace_brute_xla(planes, o, d, 1e-3, 3.0)
    np.testing.assert_array_equal(np.asarray(got["tri"]), [5, 5])
    np.testing.assert_array_equal(np.asarray(want["tri"]), [5, 5])


def test_kernel_any_hit_stops_early():
    """Any-hit: once every ray of a block has a hit the later chunks are
    never visited - a hit planted past the first hit's chunk must not be
    the one reported; closest-hit still finds the nearer later one."""
    v0 = np.tile([[0.0, 0.0, 0.0]], (256, 1)).astype(np.float32)
    e1 = np.tile([[1.0, 0.0, 0.0]], (256, 1)).astype(np.float32)
    e2 = np.tile([[0.0, 0.0, 1.0]], (256, 1)).astype(np.float32)
    v0[:] = [0.0, -9.0, 0.0]
    v0[3] = [0.0, 0.0, 0.0]                    # far hit, chunk 0
    v0[200] = [0.0, 0.5, 0.0]                  # nearer hit, chunk 6
    planes = jnp.asarray(pack_triangles(v0, e1, e2))
    o = jnp.tile(jnp.asarray([[0.3, 1.0, 0.3]], jnp.float32), (4, 1))
    d = jnp.tile(jnp.asarray([[0.0, -1.0, 0.0]], jnp.float32), (4, 1))
    anyh = sweep_kernel.trace_sweep(planes, o, d, 1e-3, 5.0, any_hit=True,
                                    interpret=True)
    closest = sweep_kernel.trace_sweep(planes, o, d, 1e-3, 5.0,
                                       interpret=True)
    np.testing.assert_array_equal(np.asarray(anyh["tri"]), [3] * 4)
    np.testing.assert_array_equal(np.asarray(closest["tri"]), [200] * 4)


def test_scene_trace_routes_by_backend():
    """scene_trace lowers to the kernel for CUDA and to the XLA sweep for
    the CPU - the choice is made at lowering time, from one trace."""
    import jax

    from tpu_raytracer.models import scenes

    scene = scenes.create_cornell_box()
    o = jnp.asarray([[0.0, 0.0, 3.0], [0.3, 0.2, 2.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, -1.0], [0.0, -0.2, -1.0]], jnp.float32)
    d = d / jnp.linalg.norm(d, axis=1, keepdims=True)

    def f(scene, o, d):
        return trace_api.scene_trace(scene, o, d, 1e-3, 100.0)

    traced = jax.jit(f).trace(scene, o, d)
    cuda = traced.lower(lowering_platforms=("cuda",)).as_text()
    cpu = traced.lower(lowering_platforms=("cpu",)).as_text()
    assert "triton" in cuda and "triton" not in cpu
    got = jax.jit(f)(scene, o, d)
    want = trace_api._trace_brute_xla(scene.tri_planes, o, d, 1e-3, 100.0)
    np.testing.assert_array_equal(np.asarray(got["tri"]),
                                  np.asarray(want["tri"]))
