"""One-hot matmul gathers: exactness of the winner-row fetch.

The winner-row fetch (ops/hit.fetch_cols) must be BIT-EXACT: t/u/v are
recomputed from the fetched row and integer ids ride bitcast-as-float
columns. `select_gather_cols` is an exact-f32 one-hot matmul; fetch_cols
must route through it (or an exact gather+transpose past the one-hot
budget), including zero rows for invalid (-1) idx.
"""

import numpy as np

from tpu_raytracer.ops.gather import select_gather, select_gather_cols
from tpu_raytracer.ops.hit import fetch_cols

import jax.numpy as jnp


def _table(rng, t, c):
    table = (rng.standard_normal((t, c))
             * np.exp(rng.uniform(-6, 6, (t, c)))).astype(np.float32)
    table[:, min(10, c - 1)] = rng.integers(0, 1 << 24, t).astype(np.float32)
    return table


def test_select_gather_cols_exact_and_zero_on_miss():
    rng = np.random.default_rng(9)
    t, c, r = 1408, 35, 2500
    table = _table(rng, t, c)
    tj = jnp.asarray(table)
    idx_np = rng.integers(-1, t, r).astype(np.int32)
    idx = jnp.asarray(idx_np)

    got = np.stack(select_gather_cols(tj, idx))         # [C, R]
    miss = idx_np < 0
    ref = table[np.maximum(idx_np, 0)].T.copy()
    ref[:, miss] = 0.0
    assert np.array_equal(ref, got)


def test_fetch_cols_exact_both_routes():
    rng = np.random.default_rng(11)
    for t, c, r in ((640, 12, 4096),          # one-hot matmul route
                    (1 << 11, 8, 1 << 18)):   # past budget: gather+T route
        table = _table(rng, t, c)
        tj = jnp.asarray(table)
        idx_np = rng.integers(0, t, r).astype(np.int32)
        got = np.stack(fetch_cols(tj, jnp.asarray(idx_np)))
        assert np.array_equal(table[idx_np].T, got), (t, c, r)


def test_select_gather_rows_exact():
    rng = np.random.default_rng(13)
    table = _table(rng, 64, 7)
    idx_np = rng.integers(0, 64, 333).astype(np.int32)
    got = np.asarray(select_gather(jnp.asarray(table), jnp.asarray(idx_np)))
    assert np.array_equal(table[idx_np], got)
