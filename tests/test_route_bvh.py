"""The stackless BVH walk (ops/traversal.trace) against the CPU oracle."""

import jax.numpy as jnp
import numpy as np
import pytest

from route_cases import RAY_SETS, TRI_COUNTS, check, rays, tris
from tpu_raytracer.ops import bvh as bvh_ops
from tpu_raytracer.ops import traversal


def _tree(v0, e1, e2):
    mn = np.minimum(np.minimum(v0, v0 + e1), v0 + e2)
    mx = np.maximum(np.maximum(v0, v0 + e1), v0 + e2)
    tree = bvh_ops.build_bvh(mn, mx)
    bvh_ops.fill_triangles(tree, v0, e1, e2)
    return tree


@pytest.mark.parametrize("n_tris", TRI_COUNTS)
@pytest.mark.parametrize("kind", RAY_SETS)
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_bvh_walk_matches_oracle(n_tris, kind, any_hit):
    v0, e1, e2 = tris(n_tris)
    o, d, t_max, active = rays(kind, v0, e1, e2)
    tree = _tree(v0, e1, e2)
    res = traversal.trace(
        jnp.asarray(tree.rec), jnp.asarray(tree.skip),
        jnp.asarray(tree.tri_id), jnp.asarray(o), jnp.asarray(d), 1e-3,
        jnp.asarray(t_max), any_hit=any_hit,
        active=None if active is None else jnp.asarray(active))
    check(res["tri"], res["t"], v0, e1, e2, o, d, t_max, active, any_hit)
