"""Frame renderer: the jitted per-frame pipeline.

JAX equivalent of `Renderer::render` (src/renderer.rs:349-515): the whole
frame - G-buffer, path trace / ReSTIR, post - is ONE jitted function over a
functional FrameState pytree (the reference's ping-pong buffers become
carried state with donated buffers; parity tricks like `frame_count % 2`
bind-group swaps disappear - purity designs the races out).

This module provides the simple progressive path (candidate path tracing +
1/(N+1) accumulation, the reference's static accumulation mode,
post.wgsl:246-259). The full ReSTIR pipeline lives in render/pipeline.py.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..ops import gbuffer as gbuffer_ops
from ..ops import path_trace
from ..utils import rng


def camera_to_device(camera: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in camera.items()}


@partial(jax.jit, static_argnames=("width", "height"), donate_argnums=(3,))
def render_progressive(scene, camera, seed_offset, accum, width: int, height: int):
    """One progressive frame: 1 candidate path per pixel, running average.

    Args:
      scene: CompiledScene.
      camera: device camera uniform dict.
      seed_offset: uint32 scalar = frame_count (selects the RNG stream,
        restir.wgsl:797: seed = pcg_hash(pixel + frame * 927163)).
      accum: [H*W, 3] running radiance average (donated).

    Returns (new_accum, radiance) both [H*W, 3] linear HDR.
    """
    gb = gbuffer_ops.render_gbuffer(scene, camera, width, height)
    n = width * height
    pixel_idx = jnp.arange(n, dtype=jnp.uint32)
    seed = rng.pcg_hash(pixel_idx + seed_offset.astype(jnp.uint32) * jnp.uint32(927163))
    result = path_trace.trace_path(scene, gb, camera["view_pos"][:3], seed)
    radiance = result["radiance"]

    # progressive average: blend = 1 - 1/(N+1)  (post.wgsl:256-259)
    frame = seed_offset.astype(jnp.float32)
    blend = 1.0 - 1.0 / (frame + 1.0)
    new_accum = accum * blend + radiance * (1.0 - blend)
    return new_accum, radiance


def make_accum(width: int, height: int):
    return jnp.zeros((width * height, 3), jnp.float32)
