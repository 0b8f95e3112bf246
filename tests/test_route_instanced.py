"""The instanced scan (trace_api._trace_instanced_xla) against the plain
sweep over the same world built flattened: {1, 3, 17} instances x
{closest, any-hit} x the route ray sets."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

from route_cases import RAY_SETS, _bary, rays
from tpu_raytracer.ops import trace_api
from tpu_raytracer.scene.builder import SceneBuilder
from tpu_raytracer.scene.geometry import create_sphere
from tpu_raytracer.scene.material import Material
from tpu_raytracer.utils.math3d import rotation_y, scale, translation

T_TOL = 1e-4   # object- vs world-space rounding of the same hit
GRAZE = 1e-4   # ... which can flip a ray aimed exactly at an edge


@functools.lru_cache(maxsize=None)
def _worlds(n_inst):
    """(instanced, flattened) builds of n_inst spheres on a grid, scaled
    and turned differently, all inside the route rays' [-1, 1] box."""
    def build(mode):
        b = SceneBuilder()
        mesh = b.add_mesh(create_sphere(1))
        mat = b.add_material(Material((0.7, 0.7, 0.7, 1.0)))
        rng = np.random.default_rng(n_inst)
        for k in range(n_inst):
            p = rng.uniform(-0.7, 0.7, 3) * [1.0, 0.2, 1.0]
            b.add_instance(mesh, mat, translation(p) @ rotation_y(0.3 * k)
                           @ scale(rng.uniform(0.15, 0.35)))
        return b.build(instancing=mode)
    return build("on"), build("off")


@pytest.mark.parametrize("n_inst", [1, 3, 17])
@pytest.mark.parametrize("kind", RAY_SETS)
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_instanced_scan_matches_flattened_sweep(n_inst, kind, any_hit):
    si, sf = _worlds(n_inst)
    n = sf.num_triangles
    v = np.asarray(sf.tri_planes)[:, :, :n]
    o, d, t_max, active = rays(kind, v[0].T, v[1].T, v[2].T)
    act = None if active is None else jnp.asarray(active)
    ri = trace_api._trace_instanced_xla(
        si.tri_planes, si.unit_inst, si.unit_group, si.inst_affine_inv,
        jnp.asarray(o), jnp.asarray(d), 1e-3, jnp.asarray(t_max),
        active=act, grp=si.inst_grp)
    rf = trace_api._trace_brute_xla(sf.tri_planes, jnp.asarray(o),
                                    jnp.asarray(d), 1e-3,
                                    jnp.asarray(t_max), active=act)
    hi, hf = np.asarray(ri["tri"]) >= 0, np.asarray(rf["tri"]) >= 0
    if active is not None:
        assert not hi[~active].any() and not hf[~active].any()

    def grazes(r):
        t_all, margin = _bary(v[0].T, v[1].T, v[2].T, o[r], d[r])
        return ((t_all > 1e-3) & (t_all < t_max[r])
                & (np.abs(margin) < GRAZE)).any()

    ti, tf = np.asarray(ri["t"]), np.asarray(rf["t"])
    t_off = np.abs(ti - tf) > T_TOL * np.maximum(np.abs(tf), 1.0)
    bad = (hi != hf) | (hf & hi & t_off & (not any_hit))
    # a ray aimed exactly at an edge or vertex may slip through on one
    # side of the rounding: those differences only
    for r in np.nonzero(bad)[0]:
        assert grazes(r), f"ray {r}: routes differ away from any edge"
    both = hi & hf & ~bad
    if any_hit or not both.any():
        return
    # the instanced hit, as a world triangle, lies at the flattened t
    # (the same triangle, or one tied with it at that t)
    world = {(i, p): k for k, (i, p) in enumerate(
        zip(np.asarray(sf.tri_inst)[:n], np.asarray(sf.tri_prim)[:n]))}
    for r in np.nonzero(both)[0]:
        k = world[(int(ri["inst"][r]),
                   int(np.asarray(si.tri_prim)[int(ri["tri"][r])]))]
        if k == int(rf["tri"][r]):
            continue
        t_all, _ = _bary(v[0].T, v[1].T, v[2].T, o[r], d[r])
        assert abs(t_all[k] - tf[r]) <= T_TOL * max(abs(tf[r]), 1.0), r
