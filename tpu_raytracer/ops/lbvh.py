"""On-device LBVH: Morton codes + sort + Karras hierarchy + AABB build.

The driver-side acceleration-structure build the reference relies on
(builder.rs:143-179) has two JAX replacements here:

  * host binned-SAH (ops/bvh.py) - highest quality, used at scene compile;
  * this module - a fully jitted linear BVH for DYNAMIC geometry: 30-bit
    Morton codes over triangle centroids, `jnp.sort`, Karras 2012 internal-node construction (each node finds its
    range/split by vectorized binary searches over common-prefix lengths),
    and a level-swept bottom-up AABB pass.

`morton_reorder` applies the Morton order to the intersector's triangle
stream - the on-device retopology path that restores spatial coherence
after large deformations (the refit path, ops/refit.py, covers rigid
instance motion exactly).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _expand_bits(v):
    """Spread 10 bits to every 3rd bit (Morton interleave)."""
    v = v.astype(jnp.uint32)
    v = (v * jnp.uint32(0x00010001)) & jnp.uint32(0xFF0000FF)
    v = (v * jnp.uint32(0x00000101)) & jnp.uint32(0x0F00F00F)
    v = (v * jnp.uint32(0x00000011)) & jnp.uint32(0xC30C30C3)
    v = (v * jnp.uint32(0x00000005)) & jnp.uint32(0x49249249)
    return v


def morton_codes(centroids, scene_min, scene_max):
    """30-bit Morton codes for [T, 3] centroids within the scene bounds."""
    q = (centroids - scene_min) / jnp.maximum(scene_max - scene_min, 1e-12)
    q = jnp.clip(q * 1024.0, 0.0, 1023.0).astype(jnp.uint32)
    return (_expand_bits(q[:, 0]) << 2) | (_expand_bits(q[:, 1]) << 1) \
        | _expand_bits(q[:, 2])


def _clz32(x):
    """Count leading zeros of uint32 (integer-exact, 5 shift steps)."""
    x = x.astype(jnp.uint32)
    msb = jnp.zeros(x.shape, jnp.int32)
    cur = x
    for sh in (16, 8, 4, 2, 1):
        y = cur >> jnp.uint32(sh)
        take = y != 0
        cur = jnp.where(take, y, cur)
        msb = msb + jnp.where(take, sh, 0)
    return jnp.where(x == 0, 32, 31 - msb)


def _delta(codes_aug, i, j, t):
    """Common-prefix length between sorted (code, index)-augmented keys;
    -1 outside [0, t). When codes are equal the prefix continues into the
    index bits (Karras's duplicate-code tie break)."""
    valid = (j >= 0) & (j < t)
    j_c = jnp.clip(j, 0, t - 1)
    x = codes_aug[i] ^ codes_aug[j_c]
    idx_x = (i ^ j_c).astype(jnp.uint32)
    lz = jnp.where(x != 0, _clz32(x), 32 + _clz32(idx_x))
    return jnp.where(valid, lz, -1)


def build_lbvh(aabb_min, aabb_max):
    """Build a Karras LBVH over triangle AABBs, fully on device.

    Returns dict:
      order    [T]   sorted triangle ids (Morton order; = leaf order)
      left/right [T-1] child ids (< T-1: internal node; >= T-1: leaf
                 (id - (T-1)) in SORTED positions)
      node_min/node_max [2T-1, 3]: internal nodes first, then leaves
    """
    t = aabb_min.shape[0]
    centroids = (aabb_min + aabb_max) * 0.5
    smin = jnp.min(aabb_min, axis=0)
    smax = jnp.max(aabb_max, axis=0)
    codes = morton_codes(centroids, smin, smax)
    order = jnp.argsort(codes)
    codes = codes[order]

    n_int = t - 1
    i_arr = jnp.arange(n_int, dtype=jnp.int32)

    def delta(i, j):
        return _delta(codes, i, j, t)

    # --- Karras: direction + range length via doubling search ---
    d = jnp.sign(delta(i_arr, i_arr + 1) - delta(i_arr, i_arr - 1)
                 ).astype(jnp.int32)
    d = jnp.where(d == 0, 1, d)
    delta_min = delta(i_arr, i_arr - d)

    # upper bound by doubling (fixed 31 steps covers T < 2^32)
    lmax = jnp.full((n_int,), 2, jnp.int32)
    for _ in range(31):
        cond = delta(i_arr, i_arr + lmax * d) > delta_min
        lmax = jnp.where(cond, lmax * 2, lmax)

    # binary search the exact range end
    l = jnp.zeros((n_int,), jnp.int32)
    step = lmax
    for _ in range(32):
        step = jnp.maximum(step // 2, 0)
        cand = l + step
        ok = (step > 0) & (delta(i_arr, i_arr + cand * d) > delta_min)
        l = jnp.where(ok, cand, l)
    j_end = i_arr + l * d

    # --- split position: binary search highest differing bit ---
    delta_node = delta(i_arr, j_end)
    s = jnp.zeros((n_int,), jnp.int32)
    denom = jnp.full((n_int,), 2, jnp.int32)
    for _ in range(32):
        tstep = (l + denom - 1) // denom
        cand = s + tstep
        ok = (tstep >= 1) & (delta(i_arr, i_arr + cand * d) > delta_node)
        s = jnp.where(ok, cand, s)
        denom = denom * 2
    gamma = i_arr + s * d + jnp.minimum(d, 0)

    range_lo = jnp.minimum(i_arr, j_end)
    range_hi = jnp.maximum(i_arr, j_end)
    # child is a leaf when it covers exactly one sorted position
    left = jnp.where(range_lo == gamma, gamma + n_int, gamma)
    right = jnp.where(range_hi == gamma + 1, gamma + 1 + n_int, gamma + 1)

    # --- bottom-up AABBs: iterate until converged (<= tree depth sweeps) ---
    leaf_min = aabb_min[order]
    leaf_max = aabb_max[order]
    node_min = jnp.concatenate(
        [jnp.full((n_int, 3), 3.0e38, jnp.float32), leaf_min], axis=0)
    node_max = jnp.concatenate(
        [jnp.full((n_int, 3), -3.0e38, jnp.float32), leaf_max], axis=0)

    if n_int > 0:
        def sweep(carry):
            node_min, node_max, _ = carry
            new_min = jnp.minimum(node_min[left], node_min[right])
            new_max = jnp.maximum(node_max[left], node_max[right])
            # a node is ready only when BOTH subtrees are complete
            ready = ((node_min[left] < 1.0e38).all(axis=1)
                     & (node_min[right] < 1.0e38).all(axis=1))
            node_min = node_min.at[:n_int].set(
                jnp.where(ready[:, None], new_min, node_min[:n_int]))
            node_max = node_max.at[:n_int].set(
                jnp.where(ready[:, None], new_max, node_max[:n_int]))
            return node_min, node_max, ready.all()

        node_min, node_max, _ = jax.lax.while_loop(
            lambda c: ~c[2], sweep,
            (node_min, node_max, jnp.asarray(False)))
    return {
        "order": order.astype(jnp.int32),
        "left": left, "right": right,
        "node_min": node_min, "node_max": node_max,
    }


def morton_reorder(scene):
    """On-device dynamic retopology: re-sort the triangle stream by Morton
    code. Returns the new CompiledScene (shading tables and metadata
    follow the order)."""
    import dataclasses

    t = scene.num_triangles
    v0 = scene.tri_planes[0, :, :t].T
    e1 = scene.tri_planes[1, :, :t].T
    e2 = scene.tri_planes[2, :, :t].T
    v1 = v0 + e1
    v2 = v0 + e2
    mn = jnp.minimum(jnp.minimum(v0, v1), v2)
    mx = jnp.maximum(jnp.maximum(v0, v1), v2)
    smin = jnp.min(mn, axis=0)
    smax = jnp.max(mx, axis=0)
    order = jnp.argsort(morton_codes((mn + mx) * 0.5, smin, smax))

    planes = scene.tri_planes
    planes = planes.at[0, :, :t].set(v0[order].T)
    planes = planes.at[1, :, :t].set(e1[order].T)
    planes = planes.at[2, :, :t].set(e2[order].T)

    # keep the unified-stream BVH consistent with the new triangle ids:
    # leaf-tri rows reference tri ids (bvh_tri) and refit scatters by
    # tri -> row (bvh_tri_rows); both must follow the permutation.
    inv = jnp.argsort(order).astype(jnp.int32)
    is_tri = scene.bvh_skip < 0
    bvh_tri = jnp.where(is_tri, inv[jnp.maximum(scene.bvh_tri, 0)],
                        scene.bvh_tri)

    return dataclasses.replace(
        scene,
        tri_planes=planes,
        tri_table=scene.tri_table[order],
        tri_table_local=scene.tri_table_local[order],
        tri_inst=scene.tri_inst[order],
        tri_prim=scene.tri_prim[order],
        tri_local=scene.tri_local[order],
        bvh_tri=bvh_tri,
        bvh_tri_rows=scene.bvh_tri_rows[order],
    )
