"""Texture-array sampling.

Replaces the reference's hardware sampler over 1024x1024 texture arrays
(builder.rs:477-575; sampled with `textureSampleLevel(..., 0.0)` and repeat
addressing). Color textures are pre-decoded sRGB->linear at build time, so
bilinear filtering here happens in linear space exactly like hardware
Rgba8UnormSrgb (decode-then-filter).

Sampling is 4 flat gathers + lerp, fully vectorized over rays.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..scene.material import NO_TEXTURE
from ..utils import vec3


def pack_pairs(tex):
    """[L, H, W, 3] -> [L, H, W, 12]: each row stores the full bilinear
    2x2 quad (x,y), (x+1,y), (x,y+1), (x+1,y+1) with wrap addressing, so a
    bilinear sample is ONE row gather. Costs 4x texture memory to cut
    the gathered row count by 4."""
    right = jnp.roll(tex, -1, axis=2)
    down = jnp.roll(tex, -1, axis=1)
    down_right = jnp.roll(down, -1, axis=2)
    return jnp.concatenate([tex, right, down, down_right], axis=-1)


def sample_bilinear(tex_quads, layer, u, v):
    """Sample a quad-packed [L, H, W, 12] array with repeat addressing +
    bilinear filter (a single row gather per sample).

    Args:
      tex_quads: [L, H, W, 12] from `pack_pairs` (any float dtype).
      layer: [R] int32 texture ids. ``NO_TEXTURE`` lanes return 1.0 (callers
        typically multiply; matches the reference's `if tex_id != 65535`
        guards, e.g. gbuffer.wgsl:182-193).
      u, v: [R] float32 texture coordinates.

    Returns a V3 of dense [R] channels (the quad gather row stays the only
    wide intermediate - the lerps run on unpadded component arrays).
    """
    l, h, w = tex_quads.shape[0], tex_quads.shape[1], tex_quads.shape[2]
    valid = layer != NO_TEXTURE
    layer_safe = jnp.where(valid, jnp.minimum(layer, l - 1), 0)

    x = u * w - 0.5
    y = v * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0
    xi0 = jnp.mod(x0.astype(jnp.int32), w)
    yi0 = jnp.mod(y0.astype(jnp.int32), h)

    flat = tex_quads.reshape(-1, 12)
    quad = flat[layer_safe * (h * w) + yi0 * w + xi0].astype(jnp.float32)

    def chan(k):
        top = quad[:, k] * (1 - fx) + quad[:, 3 + k] * fx
        bot = quad[:, 6 + k] * (1 - fx) + quad[:, 9 + k] * fx
        out = top * (1 - fy) + bot * fy
        return jnp.where(valid, out, 1.0)

    return vec3.V3(chan(0), chan(1), chan(2))
