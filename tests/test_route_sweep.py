"""The XLA sweep (trace_api._trace_brute_xla) against the CPU oracle."""

import jax.numpy as jnp
import pytest

from route_cases import RAY_SETS, TRI_COUNTS, check, rays, tris
from tpu_raytracer.ops import trace_api
from tpu_raytracer.ops.intersect import pack_triangles


@pytest.mark.parametrize("n_tris", TRI_COUNTS)
@pytest.mark.parametrize("kind", RAY_SETS)
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_xla_sweep_matches_oracle(n_tris, kind, any_hit):
    v0, e1, e2 = tris(n_tris)
    o, d, t_max, active = rays(kind, v0, e1, e2)
    res = trace_api._trace_brute_xla(
        jnp.asarray(pack_triangles(v0, e1, e2)), jnp.asarray(o),
        jnp.asarray(d), 1e-3, jnp.asarray(t_max),
        active=None if active is None else jnp.asarray(active))
    check(res["tri"], res["t"], v0, e1, e2, o, d, t_max, active, any_hit)
