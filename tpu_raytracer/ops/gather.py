"""Table gathers written as one-hot matmuls.

Per-ray random table lookups are reformulated as ONE-HOT MATMULS (a
layout that made row gathers cheap on the accelerator this was first
tuned for; whether they beat `table[idx]` on the GPU is ROADMAP S3/D5):

  * `select_gather`  - tiny tables (materials, lights, mesh infos; M <= 64):
    a plain XLA one-hot [R, M] @ table [M, C] matmul. With the framework's
    "highest" matmul precision this is exact f32 and costs microseconds.
  * larger tables: a transposed [M, R] one-hot matmul (the output comes
    out [C, R], ray axis minor) under `hit.fetch_cols`' 2 GB budget.

Integer columns ride along bitcast to f32 through `pack_table` /
`int_rows` (bitcasts survive the hi/lo trick only if values fit f32's
mantissa as integers - use small ints (< 2^24) or dedicated int columns
gathered via select_gather; triangle tables store ids < 2^24).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def pack_table_np(columns: list) -> np.ndarray:
    """Stack host columns [T] -> [T, C] f32. Int columns stored as FLOATS
    (exact below 2^24); recover with .astype(int32)."""
    t = len(columns[0])
    out = np.zeros((t, len(columns)), np.float32)
    for c, col in enumerate(columns):
        out[:, c] = np.asarray(col).astype(np.float32)
    return out


def select_gather(table, idx):
    """table [M, C] (M small), idx [R] -> [R, C] exact f32 one-hot matmul."""
    m = table.shape[0]
    oh = (idx[:, None] == jnp.arange(m, dtype=idx.dtype)[None, :]).astype(
        jnp.float32)
    return jax.lax.dot_general(
        oh, table, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST)


def select_gather_cols(table, idx):
    """table [M, C] (M small), idx [R] -> list of C dense [R] columns.

    Transposed form of `select_gather`: the [C, R] one-hot product keeps
    the ray axis minor, so the result rows are dense [R] arrays with no
    T(8,128) lane padding (a [R, C<128] output pads C to 128 lanes - 42x
    traffic for C=3; PERF.md r3). Same exact-f32 one-hot guarantee."""
    m, c = table.shape
    oh = (idx[None, :] == jnp.arange(m, dtype=idx.dtype)[:, None]).astype(
        jnp.float32)                                   # [M, R]
    out = jax.lax.dot_general(
        table, oh, (((0,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST)           # [C, R]
    return [out[k] for k in range(c)]


def pad_table(table: np.ndarray, row_mult: int = 128,
              col_mult: int = 128) -> np.ndarray:
    t, c = table.shape
    tp = max(((t + row_mult - 1) // row_mult) * row_mult, row_mult)
    cp = max(((c + col_mult - 1) // col_mult) * col_mult, col_mult)
    out = np.zeros((tp, cp), table.dtype)
    out[:t, :c] = table
    return out
