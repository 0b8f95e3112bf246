"""Unified ray-trace entry point: picks the intersector per scene.

  - flattened scenes up to BRUTE_FORCE_MAX_TRIS: a sweep that tests every
    ray against every triangle - the fused Triton kernel
    (ops/sweep_kernel.py) where the program is lowered for CUDA, the XLA
    scan `_trace_brute_xla` on every other platform (the CPU tests);
  - larger flattened scenes: the stackless BVH walk (ops/traversal.py);
  - instanced scenes: the XLA scan over (instance, chunk-group) units,
    `_trace_instanced_xla`.

The choice is static per compiled scene (triangle count is shape
metadata), so each jitted pipeline contains exactly one intersector.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import sweep_kernel, traversal
from .intersect import _MT_EPS, CT, INF, INST_GRP

# Above this many (padded) triangles the sweep gives way to the BVH walk.
# Measured end to end on an H100 (400 W limit), 512x512 ReSTIR frames:
# Cornell (1,408) 15.3 fps on the sweep kernel vs 7.5 fps on the walk;
# the bunny-class scene (15,488) 2.38 fps vs 4.02 fps. Frame time
# interpolated linearly in triangle count crosses at ~5.4k triangles.
# Per call (262k rays) the walk already leads at 15k: 12.7 ms vs 14.8 ms,
# and at 100k (23 ms vs 90 ms) and 512k (19 ms vs 475 ms) by far.
# `bench.py --traces` re-times the per-call side.
BRUTE_FORCE_MAX_TRIS = 5120


def _broadcast_t(t_min, t_max, active, r):
    t_min = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), (r,))
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (r,))
    if active is not None:
        t_max = jnp.where(active, t_max, 0.0)
    return t_min, t_max


def _mt_chunk(o, d, chunk, t_min, t_max, t_best):
    """Moller-Trumbore of R rays against one [4, 3, c] chunk -> [R, c]
    candidate t (INF where no hit strictly inside (t_min, t_max, t_best))."""
    v0 = chunk[0].T[None]  # [1, c, 3]
    e1 = chunk[1].T[None]
    e2 = chunk[2].T[None]
    valid_t = chunk[3, 0] > 0.5
    pvec = jnp.cross(d[:, None, :], e2)
    det = jnp.sum(e1 * pvec, -1)
    ok = jnp.abs(det) > _MT_EPS
    inv = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
    tvec = o[:, None, :] - v0
    u = jnp.sum(tvec * pvec, -1) * inv
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(d[:, None, :] * qvec, -1) * inv
    t = jnp.sum(e2 * qvec, -1) * inv
    hit = (ok & valid_t[None] & (u >= 0) & (v >= 0) & (u + v <= 1)
           & (t > t_min[:, None]) & (t < t_max[:, None])
           & (t < t_best[:, None]))
    return jnp.where(hit, t, jnp.float32(INF))


def _trace_brute_xla(tri_planes, ray_o, ray_d, t_min, t_max, active=None):
    """Plain XLA sweep: scan over 128-triangle chunks with a running
    arg-min. The reference the sweep kernel is held to: lowest triangle
    index on exact t ties, `active=False` lanes never hit."""
    r = ray_o.shape[0]
    tp = tri_planes.shape[2]
    tri = jnp.moveaxis(tri_planes.reshape(4, 3, tp // CT, CT), 2, 0)
    t_min, t_max = _broadcast_t(t_min, t_max, active, r)

    def body(carry, chunk):
        t_best, idx_best, base = carry
        t_cand = _mt_chunk(ray_o, ray_d, chunk, t_min, t_max, t_best)
        lane = jnp.argmin(t_cand, axis=1)
        t_new = t_cand[jnp.arange(r), lane]
        improved = t_new < t_best
        t_best = jnp.where(improved, t_new, t_best)
        idx_best = jnp.where(improved, base + lane.astype(jnp.int32), idx_best)
        return (t_best, idx_best, base + CT), None

    init = (jnp.full((r,), INF, jnp.float32),
            jnp.full((r,), -1, jnp.int32), jnp.int32(0))
    (t_best, idx_best, _), _ = jax.lax.scan(body, init, tri)
    missed = idx_best < 0
    return {"t": jnp.where(missed, jnp.float32(INF), t_best),
            "tri": idx_best}


def _trace_instanced_xla(obj_planes, unit_inst, unit_group,
                         inst_affine_inv, ray_o, ray_d, t_min, t_max,
                         active=None, grp: int = INST_GRP):
    """Instanced sweep: scan over (instance, chunk-group) units, rays
    moved into each unit's object space. Returns the closest hit's t,
    object-space triangle (column of obj_planes) and instance."""
    r = ray_o.shape[0]
    t_min, t_max = _broadcast_t(t_min, t_max, active, r)
    unit = grp * CT
    tri = jnp.moveaxis(
        obj_planes.reshape(4, 3, obj_planes.shape[2] // unit, unit),
        2, 0)                                           # [NU_obj, 4, 3, unit]

    def body(carry, xs):
        t_best, idx_best, inst_best = carry
        inst_id, g = xs
        aff = inst_affine_inv[:, inst_id]               # [12]
        a = aff[:9].reshape(3, 3)
        o = ray_o @ a.T + aff[9:12]
        d = ray_d @ a.T
        t_cand = _mt_chunk(o, d, tri[g], t_min, t_max, t_best)
        lane = jnp.argmin(t_cand, axis=1)
        t_new = t_cand[jnp.arange(r), lane]
        improved = t_new < t_best
        t_best = jnp.where(improved, t_new, t_best)
        idx_best = jnp.where(improved,
                             g * unit + lane.astype(jnp.int32), idx_best)
        inst_best = jnp.where(improved, inst_id, inst_best)
        return (t_best, idx_best, inst_best), None

    init = (jnp.full((r,), INF, jnp.float32),
            jnp.full((r,), -1, jnp.int32),
            jnp.full((r,), -1, jnp.int32))
    (t_best, idx_best, inst_best), _ = jax.lax.scan(
        body, init, (unit_inst, unit_group))
    missed = idx_best < 0
    return {"t": jnp.where(missed, jnp.float32(INF), t_best),
            "tri": idx_best, "inst": inst_best}


def scene_trace(scene, ray_o, ray_d, t_min, t_max, any_hit=False,
                active=None):
    """Closest-hit (any_hit=False) or occlusion-style first-hit query.

    ray_o/ray_d: [R, 3] arrays OR component tuples/V3s of three [R]
    arrays (the wavefront's native form - the sweep kernel consumes the
    components directly, so no [R, 3] array is built on that route).

    With any_hit=True only `tri >= 0` is meaningful: the kernel stops at
    the first chunk where every ray of its block has a hit.

    Instanced scenes (scene.instanced, the shared-BLAS analogue) return
    an extra "inst" id per lane; callers feed it to hit.reconstruct_hit.
    """
    swept = (not scene.instanced
             and scene.tri_planes.shape[2] <= BRUTE_FORCE_MAX_TRIS)
    if swept:
        # the kernel where the program is lowered for CUDA, the XLA scan
        # elsewhere - chosen at lowering time, so one traced program
        # serves both (and a CPU-placed call in a GPU process works)
        def kernel(planes, o, d, tmn, tmx, act):
            return sweep_kernel.trace_sweep(planes, o, d, tmn, tmx,
                                            any_hit=any_hit, active=act)

        def xla(planes, o, d, tmn, tmx, act):
            if isinstance(o, tuple):
                o, d = jnp.stack(o, axis=-1), jnp.stack(d, axis=-1)
            return _trace_brute_xla(planes, o, d, tmn, tmx, active=act)

        return jax.lax.platform_dependent(
            scene.tri_planes, tuple(ray_o) if isinstance(ray_o, tuple)
            else ray_o, tuple(ray_d) if isinstance(ray_d, tuple) else ray_d,
            t_min, t_max, active, cuda=kernel, default=xla)
    if isinstance(ray_o, tuple):
        ray_o = jnp.stack(list(ray_o), axis=-1)
        ray_d = jnp.stack(list(ray_d), axis=-1)
    if scene.instanced:
        return _trace_instanced_xla(
            scene.tri_planes, scene.unit_inst, scene.unit_group,
            scene.inst_affine_inv, ray_o, ray_d, t_min, t_max,
            active=active, grp=scene.inst_grp)
    return traversal.trace(
        scene.bvh_rec, scene.bvh_skip, scene.bvh_tri,
        ray_o, ray_d, t_min, t_max, any_hit=any_hit, active=active)


def scene_occluded(scene, ray_o, ray_d, t_min, t_max, active=None):
    res = scene_trace(scene, ray_o, ray_d, t_min, t_max, any_hit=True,
                      active=active)
    return res["tri"] >= 0
