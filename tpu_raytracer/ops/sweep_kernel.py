"""Fused Moller-Trumbore sweep for the GPU (Pallas, Triton route).

The same query as trace_api._trace_brute_xla - every ray against every
triangle, closest hit with the lowest triangle index on exact t ties -
as one kernel. XLA's scan writes a [R, 128] candidate array per chunk
step and reads it back for the arg-min; here each lane owns one ray and
keeps its running (t_best, tri) in registers across all triangles, which
it reads as scalars (uniform loads that hit L1/L2 at the scene sizes
this route serves), CHUNK of them per unrolled loop step. No cross-lane
reduction is needed: a strict `<` update in index order keeps the lowest
index on ties. All arithmetic is fp32.

Layout: rays component-major [8, R] (o.xyz, d.xyz, t_min, t_max), so a
block's loads coalesce; triangles are the scene's [4, 3, Tp] planes seen
as [12, Tp] (rows v0.xyz, e1.xyz, e2.xyz, valid).

Early exit: the chunk loop is a while loop that stops once no ray of the
block can still change its answer - all rays dead (t_max <= t_min, as
inactive lanes are) or, for any-hit, all live rays already hit.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .intersect import _MT_EPS, INF

# timed on an H100 (PERF.md): 128 rays over 2 warps with 8 triangles per
# unrolled step was the fastest of the block shapes tried
BLOCK_R = 128
CHUNK = 8
NUM_WARPS = 2


def _sweep_kernel(rays_ref, tri_ref, t_ref, idx_ref, *, chunk, any_hit):
    ox, oy, oz, dx, dy, dz, t_min, t_max = (rays_ref[k, :] for k in range(8))
    block = t_ref.shape[0]
    n_chunks = tri_ref.shape[1] // chunk
    hopeless = t_max <= t_min

    def body(carry):
        c, t_best, idx_best = carry
        for j in range(chunk):
            i = c * chunk + j
            v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, valid = (
                tri_ref[k, i] for k in range(10))
            px = dy * e2z - dz * e2y
            py = dz * e2x - dx * e2z
            pz = dx * e2y - dy * e2x
            det = e1x * px + e1y * py + e1z * pz
            ok = jnp.abs(det) > _MT_EPS
            inv = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
            tx = ox - v0x
            ty = oy - v0y
            tz = oz - v0z
            u = (tx * px + ty * py + tz * pz) * inv
            qx = ty * e1z - tz * e1y
            qy = tz * e1x - tx * e1z
            qz = tx * e1y - ty * e1x
            v = (dx * qx + dy * qy + dz * qz) * inv
            t = (e2x * qx + e2y * qy + e2z * qz) * inv
            hit = (ok & (valid > 0.5) & (u >= 0.0) & (v >= 0.0)
                   & (u + v <= 1.0) & (t > t_min) & (t < t_max)
                   & (t < t_best))
            t_best = jnp.where(hit, t, t_best)
            idx_best = jnp.where(hit, i, idx_best)
        return c + 1, t_best, idx_best

    def cond(carry):
        c, _, idx = carry
        live = ~hopeless & (idx < 0) if any_hit else ~hopeless
        return (c < n_chunks) & (jnp.max(live.astype(jnp.int32)) > 0)

    _, t_best, idx_best = lax.while_loop(
        cond, body, (jnp.int32(0), jnp.full((block,), INF, jnp.float32),
                     jnp.full((block,), -1, jnp.int32)))
    t_ref[...] = t_best
    idx_ref[...] = idx_best


@functools.partial(jax.jit, static_argnames=("any_hit", "interpret"))
def _sweep(rays, tri, any_hit, interpret):
    rp = rays.shape[1]
    kernel = functools.partial(_sweep_kernel, chunk=CHUNK, any_hit=any_hit)
    return pl.pallas_call(
        kernel,
        grid=(rp // BLOCK_R,),
        in_specs=[pl.BlockSpec((8, BLOCK_R), lambda i: (0, i)),
                  pl.BlockSpec(tri.shape, lambda i: (0, 0))],
        out_specs=[pl.BlockSpec((BLOCK_R,), lambda i: (i,)),
                   pl.BlockSpec((BLOCK_R,), lambda i: (i,))],
        out_shape=[jax.ShapeDtypeStruct((rp,), jnp.float32),
                   jax.ShapeDtypeStruct((rp,), jnp.int32)],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="mt_sweep_any" if any_hit else "mt_sweep",
    )(rays, tri)


def pack_rays(ray_o, ray_d, t_min, t_max, active=None):
    """Rays ([R, 3] arrays or 3-tuples of [R]) -> ([8, Rp] f32, R), Rp a
    multiple of BLOCK_R. Inactive and padding lanes get t_max = 0."""
    if isinstance(ray_o, tuple):
        comps = [*ray_o, *ray_d]
    else:
        comps = [ray_o[:, k] for k in range(3)] + [ray_d[:, k]
                                                   for k in range(3)]
    r = comps[0].shape[0]
    t_min = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), (r,))
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (r,))
    if active is not None:
        t_max = jnp.where(active, t_max, 0.0)
    rays = jnp.stack([c.astype(jnp.float32) for c in comps]
                     + [t_min, t_max])
    rp = -(-r // BLOCK_R) * BLOCK_R
    return jnp.pad(rays, ((0, 0), (0, rp - r))), r


def trace_sweep(tri_planes, ray_o, ray_d, t_min, t_max, any_hit=False,
                active=None, *, interpret=False):
    """Sweep kernel over packed planes [4, 3, Tp] (Tp a multiple of CHUNK).

    Returns {"t": [R] (INF on miss), "tri": [R] i32 (-1 on miss)}; with
    any_hit only `tri >= 0` is meaningful. interpret=True runs the kernel
    through the Pallas interpreter (CPU tests); the GPU never does.
    """
    tp = tri_planes.shape[2]
    if tp % CHUNK:
        raise ValueError(f"{tp} triangles is not a multiple of chunk={CHUNK}")
    rays, r = pack_rays(ray_o, ray_d, t_min, t_max, active)
    t, idx = _sweep(rays, tri_planes.reshape(12, tp), any_hit, interpret)
    return {"t": t[:r], "tri": idx[:r]}
