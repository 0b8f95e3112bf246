"""Triangle sets, ray sets and the oracle comparison shared by the
intersector route tests (test_route_*.py).

Every route - the XLA sweep, the BVH walk, the sweep kernel - is held to
tests/oracle.intersect / occluded on the same cases:
  {closest, any-hit} x RAY_SETS x TRI_COUNTS.
Where a route and the oracle disagree, the route's answer must be right
in float64 up to exact-t ties and edge grazes (see `check`).
"""

import functools

import numpy as np

from oracle import intersect, occluded

TRI_COUNTS = (1, 127, 128, 129, 1000)
RAY_SETS = ("camera", "random", "edges", "miss", "half_active",
            "short_tmax")
N_RAYS = 64
T_MIN = 1e-3
T_TOL = 1e-5      # |dt| <= T_TOL * max(t, 1), as chip_smoke.py
GRAZE = 1e-5


@functools.lru_cache(maxsize=None)
def tris(n: int):
    """n triangles (v0, e1, e2 [n, 3] f32): a triangulated heightfield,
    so neighbours share edges and vertices, plus a few free-floating
    triangles above it once n allows."""
    rng = np.random.default_rng(n)
    side = int(np.ceil(np.sqrt(n / 2))) + 1
    xs = np.linspace(-1.0, 1.0, side + 1)
    hgt = rng.uniform(-0.1, 0.1, (side + 1, side + 1))
    out = []
    for i in range(side):
        for j in range(side):
            p00 = (xs[i], hgt[i, j], xs[j])
            p10 = (xs[i + 1], hgt[i + 1, j], xs[j])
            p01 = (xs[i], hgt[i, j + 1], xs[j + 1])
            p11 = (xs[i + 1], hgt[i + 1, j + 1], xs[j + 1])
            out += [(p00, p10, p11), (p00, p11, p01)]
    v = np.asarray(out, np.float64)[:max(n - n // 8, 1)]
    n_free = n - len(v)
    if n_free:
        c = rng.uniform(-0.8, 0.8, (n_free, 1, 3)) + [0.0, 0.5, 0.0]
        v = np.concatenate([v, c + rng.uniform(-0.2, 0.2, (n_free, 3, 3))])
    v = v.astype(np.float32)
    return v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]


def rays(kind: str, v0, e1, e2, seed=0):
    """(o [R,3], d [R,3], t_max [R], active [R] or None) for one set."""
    rng = np.random.default_rng(seed)
    n = N_RAYS
    eye = np.asarray([0.3, 2.5, 0.4], np.float32)
    t_max = np.full(n, 100.0, np.float32)
    active = None
    if kind in ("camera", "short_tmax", "half_active"):
        gx, gz = np.meshgrid(np.linspace(-1.1, 1.1, 8),
                             np.linspace(-1.1, 1.1, 8))
        tgt = np.stack([gx.ravel(), np.zeros(n), gz.ravel()], 1)
        o = np.tile(eye, (n, 1))
        d = tgt - o
        if kind == "short_tmax":
            t_max = (np.linalg.norm(d, axis=1)
                     * rng.uniform(0.5, 1.2, n)).astype(np.float32)
        if kind == "half_active":
            active = np.arange(n) % 2 == 0
    elif kind == "random":
        o = rng.uniform(-1.5, 1.5, (n, 3))
        d = rng.normal(size=(n, 3))
    elif kind == "edges":
        # exactly at shared vertices and edge midpoints of the mesh
        k = rng.integers(0, len(v0), n)
        w = np.where((np.arange(n) % 2 == 0)[:, None],
                     np.asarray([[0.0, 0.0]]), np.asarray([[0.5, 0.5]]))
        tgt = v0[k] + w[:, :1] * e1[k] + w[:, 1:] * e2[k]
        o = np.tile(eye, (n, 1))
        d = tgt - o
    elif kind == "miss":
        o = rng.uniform(-1.0, 1.0, (n, 3)) + [0.0, 3.0, 0.0]
        d = rng.normal(size=(n, 3))
        d[:, 1] = np.abs(d[:, 1]) + 0.5            # up, away from all tris
    else:
        raise ValueError(kind)
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32), t_max, active


def _bary(v0, e1, e2, o, d):
    """float64 MT over all triangles for one ray: (t, margin) where
    margin = min(u, v, 1-u-v) (negative = outside)."""
    v0, e1, e2 = (x.astype(np.float64) for x in (v0, e1, e2))
    o, d = o.astype(np.float64), d.astype(np.float64)
    p = np.cross(d[None], e2)
    det = np.sum(e1 * p, 1)
    det = np.where(np.abs(det) > 1e-12, det, np.nan)
    tv = o[None] - v0
    u = np.sum(tv * p, 1) / det
    q = np.cross(tv, e1)
    v = np.sum(d[None] * q, 1) / det
    t = np.sum(e2 * q, 1) / det
    return t, np.minimum(np.minimum(u, v), 1.0 - u - v)


def check(got_tri, got_t, v0, e1, e2, o, d, t_max, active, any_hit):
    """Assert a route's (tri, t) against the oracle, ray by ray.

    Where the route and the oracle disagree, the route's answer must still
    be right in float64: a reported triangle is a real (possibly grazing)
    hit at the reported t with no solid hit strictly nearer, and a miss
    means no solid hit exists. Solid = barycentric margin above GRAZE."""
    valid = np.ones(len(v0), bool)
    soup = (v0, e1, e2, valid)
    for r in range(len(o)):
        g = int(got_tri[r])
        if active is not None and not active[r]:
            assert g < 0, f"ray {r}: inactive lane hit tri {g}"
            continue
        if any_hit:
            want = occluded(soup, o[r], d[r], np.float32(T_MIN), t_max[r])
            if not want and g < 0:
                continue
        else:
            want = intersect(soup, o[r], d[r], np.float32(T_MIN), t_max[r])
            if want is None and g < 0:
                continue
            if (want is not None and want["tri"] == g
                    and abs(float(got_t[r]) - float(want["t"]))
                    <= T_TOL * max(abs(float(want["t"])), 1.0)):
                continue
        t_all, margin = _bary(v0, e1, e2, o[r], d[r])
        inside = (t_all > T_MIN) & (t_all < t_max[r])
        solid = inside & (margin > GRAZE)
        if g < 0:
            assert not solid.any(), f"ray {r}: missed solid hits"
            continue
        assert inside[g] and margin[g] >= -GRAZE, f"ray {r}: {g} no hit"
        if any_hit:
            continue
        tol = T_TOL * max(abs(t_all[g]), 1.0)
        assert abs(float(got_t[r]) - t_all[g]) <= tol, (r, g, got_t[r])
        nearer = solid & (t_all < t_all[g] - tol)
        assert not nearer.any(), f"ray {r}: solid hit nearer than {g}"
