"""Edge-aware a-trous wavelet denoiser: the OIDN screenshot path.

The reference pipes screenshots through Intel OIDN (CPU neural denoiser,
src/screenshot.rs:69-118, optional `ai-denoise` feature). The on-device
replacement is an SVGF-style edge-aware a-trous wavelet filter guided by
the G-buffer (albedo/normal/depth), run fully on-device as part of the
screenshot pass (BASELINE.md config 5):

  - N iterations of the 5x5 B3-spline a-trous kernel with power-of-two
    dilation (Dammertz et al. 2010),
  - edge-stopping weights on world position, normal and albedo so the
    filter smooths illumination noise without crossing geometry,
  - operates on demodulated irradiance (color / albedo) and remodulates,
    preserving texture detail exactly like OIDN's albedo-guided mode.

Pure jnp roll+mask stencils; runs identically on any backend and shards
over row bands like the post pass (dilated taps stay within the halo for
the sizes used at screenshot time; full-frame screenshots run unsharded).

Layout: every stencil runs on per-channel [H, W] PLANES (V3-of-planes
for colors) rather than a rank-3 [H, W, 3] intermediate with a minor dim
of 3. Inputs de-interleave through ONE transpose each; only the final
output restacks.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..utils import vec3
from ..utils.vec3 import V3

_B3 = [1 / 16, 1 / 4, 3 / 8, 1 / 4, 1 / 16]

SIGMA_ALBEDO = 0.15
SIGMA_NORMAL = 12.0
SIGMA_POS = 0.8


def _to_planes(img):
    """[H, W, C] -> list of C dense [H, W] planes (one tiled transpose)."""
    h, w, c = img.shape
    t = img.reshape(h * w, c).T
    return [t[k].reshape(h, w) for k in range(c)]


def _shift(p, dy, dx):
    """Roll one [H, W] plane; mask handled once by the caller."""
    return jnp.roll(p, (-dy, -dx), axis=(0, 1))


def _shift3(v, dy, dx):
    return V3(_shift(v.x, dy, dx), _shift(v.y, dy, dx), _shift(v.z, dy, dx))


def _filter_level(irr, ap, normal, pp, step: int, h: int, w: int,
                  halo: int, band_h: int, gy0):
    """One a-trous level for the CENTER band rows of (possibly
    halo-extended) planes.

    irr/ap/normal/pp: [band_h + 2*halo, W] planes (V3s). halo=0,
    band_h=h, gy0=0 reproduces the whole-frame filter. Out-of-image
    taps carry weight 0 in both forms (full-frame roll wraps and banded
    zero-pads both multiply a finite weight by an exact 0 mask), so
    banded == whole-frame up to XLA FMA-contraction rounding at the
    program boundaries (~1 ULP; tests/test_denoise_banded.py).
    """
    def center(q):
        return q[halo:halo + band_h] if halo else q

    def tap(q, dy, dx):
        return jnp.roll(q, (-dy, -dx), axis=(0, 1))[halo:halo + band_h] \
            if halo else _shift(q, dy, dx)

    def tap3(v, dy, dx):
        return V3(tap(v.x, dy, dx), tap(v.y, dy, dx), tap(v.z, dy, dx))

    irr0 = V3(center(irr.x), center(irr.y), center(irr.z))
    ap0 = V3(center(ap.x), center(ap.y), center(ap.z))
    n0 = V3(center(normal.x), center(normal.y), center(normal.z))
    pp0 = V3(center(pp.x), center(pp.y), center(pp.z))

    ys = gy0 + jnp.arange(band_h, dtype=jnp.int32)[:, None]
    xs = jnp.arange(w, dtype=jnp.int32)[None, :]

    sum_c = vec3.splat(0.0, irr0.x)
    sum_w = jnp.zeros_like(irr0.x)
    for ky in range(5):
        for kx in range(5):
            dy = (ky - 2) * step
            dx = (kx - 2) * step
            c = tap3(irr, dy, dx)
            a = tap3(ap, dy, dx)
            n = tap3(normal, dy, dx)
            p = tap3(pp, dy, dx)
            ok = ((ys + dy >= 0) & (ys + dy < h)
                  & (xs + dx >= 0) & (xs + dx < w))

            w_k = _B3[ky] * _B3[kx]
            da = a - ap0
            w_a = jnp.exp(-vec3.dot(da, da) / (2 * SIGMA_ALBEDO ** 2))
            w_n = jnp.maximum(vec3.dot(n, n0), 0.0) ** SIGMA_NORMAL
            dp = p - pp0
            w_p = jnp.exp(-vec3.dot(dp, dp) / (2 * SIGMA_POS ** 2))

            wgt = w_k * w_a * w_n * w_p * ok
            sum_c = sum_c + c * wgt
            sum_w = sum_w + wgt
    return vec3.where(sum_w > 1e-6,
                      sum_c / jnp.maximum(sum_w, 1e-6), irr0)


def _prep(hdr, albedo, oct_normal, pos):
    hp = V3(*_to_planes(hdr))
    ap = V3(*_to_planes(albedo))
    ox, oy = _to_planes(oct_normal)
    normal = vec3.oct_decode(ox, oy)
    pp = V3(*_to_planes(pos))
    # demodulate albedo so texture detail is untouched (OIDN-style)
    alb_safe = V3(jnp.maximum(ap.x, 1e-3), jnp.maximum(ap.y, 1e-3),
                  jnp.maximum(ap.z, 1e-3))
    return hp / alb_safe, ap, normal, pp, alb_safe


def _restack(out, h, w):
    return jnp.stack([out.x, out.y, out.z], axis=0
                     ).reshape(3, h * w).T.reshape(h, w, 3)


def atrous_denoise(hdr, albedo, oct_normal, pos, iterations: int = 4):
    """Denoise an HDR frame guided by its G-buffer.

    Args:
      hdr: [H, W, 3] linear radiance.
      albedo: [H, W, 3]; oct_normal: [H, W, 2]; pos: [H, W, 3].
      iterations: a-trous levels (dilation 1, 2, 4, ...).

    Returns [H, W, 3] denoised radiance.
    """
    h, w = hdr.shape[0], hdr.shape[1]
    irr, ap, normal, pp, alb_safe = _prep(hdr, albedo, oct_normal, pos)
    for level in range(iterations):
        irr = _filter_level(irr, ap, normal, pp, 1 << level, h, w,
                            halo=0, band_h=h, gy0=0)
    return _restack(irr * alb_safe, h, w)


# --- sequential row-band form for frames past the band budget ------------
# Frames that render_frame splits into bands (pipeline.auto_bands) are
# denoised the same way: each level runs as n_bands sequential band
# programs; the halo is the level's exact tap reach (2*step), reads come
# from zero-padded
# full-res planes, and _filter_level makes banded == whole-frame
# bit-exact (see its docstring).

_prep_jit = jax.jit(_prep)


@partial(jax.jit, static_argnames=("step", "h", "w", "halo", "band_h"))
def _level_band_jit(irr, ap, normal, pp, y0, step: int, h: int, w: int,
                    halo: int, band_h: int):
    def sl3(v):
        def sl(p):
            padded = jnp.pad(p, ((halo, halo), (0, 0)))
            return jax.lax.dynamic_slice_in_dim(padded, y0,
                                                band_h + 2 * halo, axis=0)
        return V3(sl(v.x), sl(v.y), sl(v.z))

    return _filter_level(sl3(irr), sl3(ap), sl3(normal), sl3(pp),
                         step, h, w, halo, band_h, y0)


@partial(jax.jit, static_argnames=("h", "w"))
def _finish_jit(irr, alb_safe, h: int, w: int):
    return _restack(irr * alb_safe, h, w)


def atrous_denoise_banded(hdr, albedo, oct_normal, pos,
                          iterations: int = 4, n_bands: int = 4):
    """atrous_denoise as sequential row-band programs (ULP-identical)."""
    h, w = hdr.shape[0], hdr.shape[1]
    assert h % n_bands == 0, (h, n_bands)
    band_h = h // n_bands
    irr, ap, normal, pp, alb_safe = _prep_jit(hdr, albedo, oct_normal, pos)
    for level in range(iterations):
        step = 1 << level
        outs = [_level_band_jit(irr, ap, normal, pp,
                                jnp.int32(b * band_h), step=step, h=h, w=w,
                                halo=2 * step, band_h=band_h)
                for b in range(n_bands)]
        irr = V3(jnp.concatenate([o.x for o in outs], axis=0),
                 jnp.concatenate([o.y for o in outs], axis=0),
                 jnp.concatenate([o.z for o in outs], axis=0))
    return _finish_jit(irr, alb_safe, h, w)
