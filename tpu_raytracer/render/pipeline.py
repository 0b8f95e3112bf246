"""Full ReSTIR frame pipeline: the flagship render path.

JAX re-architecture of the reference's five-pass frame
(src/renderer.rs:399-515):

    G-buffer -> ReSTIR temporal -> ReSTIR spatial(+shade) -> post -> LDR

The whole frame is ONE jitted, donated function over a functional
`FrameState`; the reference's parity-indexed ping-pong bind groups
(gbuffer.rs:299, post.rs:209-224, restir.rs:362-378) become plain dataflow.
The blit/letterbox raster pass (blit.wgsl) is display plumbing; its
aspect-correct scaling lives in app/display helpers instead.

Single-device here; the row-band device-mesh version with ppermute halo
exchange shares every pass implementation via BandViews - see
parallel/tiles.py.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..ops import gbuffer as gbuffer_ops
from ..ops import post as post_ops
from ..ops import restir as restir_ops
from ..parallel import views as views_mod


def init_state(width: int, height: int) -> dict:
    """Fresh FrameState: packed prev G-buffer + reservoirs + accumulation."""
    n = width * height
    return {
        "gb": jnp.zeros((n, gbuffer_ops.GB_COLS), jnp.float32),
        "res": restir_ops.pack_reservoirs(restir_ops.empty_reservoirs(n)),
        "accum": jnp.zeros((n, 3), jnp.float32),
    }


def _gb_for_band(scene, camera, prev_gb_rows, ctx, static_ok):
    """G-buffer for one band: compute, or (opt-in) reuse last frame's rows.

    prev_gb_rows: the PREVIOUS frame's packed G-buffer rows for exactly
    this band. Returns (gb dict, gb_traced) where gb_traced is None when
    the compute path is unconditional (reuse gate off / static_ok is a
    compile-time False) and otherwise the traced reuse predicate.
    """
    def _gb_compute(_):
        return gbuffer_ops.render_gbuffer(
            scene, camera, ctx["width"], ctx["height"],
            y0=ctx["y0"], band_h=ctx["band_h"])

    def _gb_reuse(_):
        # static_ok asserts camera AND scene unchanged, so the G-buffer
        # is bit-identical to last frame's (render_gbuffer is
        # deterministic in (scene, camera) - no RNG); pack_gb/unpack_gb
        # roundtrip exactly. Same determinism argument as replay dedup.
        return gbuffer_ops.unpack_gb(prev_gb_rows)

    # OPT-IN (TPU_RT_GB_REUSE=1, trace-time): the reuse branch replaces
    # a primary sweep + hit-attribute fetch with an unpack - net win not
    # measured on the GPU, so the default stays compute-always.
    import os
    if os.environ.get("TPU_RT_GB_REUSE", "0") != "1" \
            or (isinstance(static_ok, bool) and not static_ok):
        return _gb_compute(None), None
    gb_traced = jnp.asarray(static_ok, jnp.bool_)
    return jax.lax.cond(gb_traced, _gb_reuse, _gb_compute, None), gb_traced


def render_band(scene, camera, frame_count, state, ctx, make_view,
                static_ok=False, make_view2=None):
    """One frame over one band; `make_view` lifts band-local flat arrays to
    neighbor-readable BandViews (trivial on one device, halo-exchanged on
    a mesh). Shared by the single-device and sharded pipelines.

    static_ok: traced bool - caller asserts the world (camera + scene) is
    unchanged since the previous frame, enabling temporal replay dedup
    (ops/restir.py). False is always safe.

    make_view2: optional (a, b) -> lazily-concatenating view. Used for
    bands past _LAZY_VIEW_RAYS, where the combined G-buffer+reservoir
    arrays (~6 GB at 4K) are not materialized; costs one extra gather
    per tap.
    """
    width, height = ctx["width"], ctx["height"]
    n_primary = ctx["band_h"] * width
    big = n_primary > _LAZY_VIEW_RAYS

    gb, gb_traced = _gb_for_band(scene, camera, state["gb"], ctx, static_ok)
    # gb + reservoir rows ride ONE BandView so every neighbor tap is a
    # single wide-row gather (temporal reprojection, spatial disk taps)
    if make_view2 is not None and big:
        prev_view = make_view2(state["gb"], state["res"])
    else:
        prev_view = make_view(
            jnp.concatenate([state["gb"], state["res"]], axis=-1))
    reservoirs_t, rays_t = restir_ops.restir_temporal(
        scene, gb, prev_view,
        camera, frame_count, ctx, static_ok=static_ok)

    gb_packed = gbuffer_ops.pack_gb(gb)
    gb_view = make_view(gb_packed)
    res_t_packed = restir_ops.pack_reservoirs(reservoirs_t)
    if make_view2 is not None and big:
        comb_view = make_view2(gb_packed, res_t_packed)
    else:
        comb_view = make_view(
            jnp.concatenate([gb_packed, res_t_packed], axis=-1))
    reservoirs_s, hdr, rays_s, diag = restir_ops.restir_spatial(
        scene, gb, comb_view, reservoirs_t, camera,
        frame_count, ctx)

    ldr, accum = post_ops.post_process(
        make_view(hdr), gb, gb_view, make_view(state["accum"]), frame_count,
        ctx)
    new_state = {"gb": gb_packed,
                 "res": restir_ops.pack_reservoirs(reservoirs_s),
                 "accum": accum}
    # honest query count: reused-G-buffer frames trace no primary rays
    primary_rays = (jnp.float32(n_primary) if gb_traced is None
                    else jnp.where(gb_traced, 0.0, jnp.float32(n_primary)))
    aux = {"rays": primary_rays + rays_t + rays_s, **diag}
    return ldr, hdr, new_state, aux


@partial(jax.jit, static_argnames=("width", "height"), donate_argnums=(3,))
def render_frame(scene, camera, frame_count, state, width: int, height: int,
                 static_ok=False):
    """One complete ReSTIR frame on a single device.

    Args:
      scene: CompiledScene.
      camera: device camera uniform (see render/camera.py).
      frame_count: uint32 scalar; the accumulation/SPP counter that resets
        on camera movement (state.rs:151-152 semantics - caller resets).
      state: FrameState pytree (donated).
      static_ok: bool - nothing (camera/scene) changed since last frame;
        enables temporal replay dedup. False is always safe.

    Returns (ldr [n,3] gamma-encoded, hdr [n,3], new_state, aux) where
    aux["rays"] is the exact number of traversal queries this frame.
    """
    ctx = restir_ops.make_ctx(width, height)

    def make_view(flat):
        return views_mod.trivial_view(flat, width, height)

    def make_view2(a, b):
        return views_mod.trivial_pair_view(a, b, width, height)

    return render_band(scene, camera, frame_count, state, ctx, make_view,
                       static_ok=static_ok, make_view2=make_view2)


# ---------------------------------------------------------------------------
# Sequential row-band rendering for frames past one program's budget
# ---------------------------------------------------------------------------
#
# A frame past _BAND_RAY_BUDGET pixels renders as n_bands sequential
# programs per phase. Unlike the mesh path there is NO halo policy:
# every neighbor-dependent pass reads through FULL-resolution views, so
# the result is BIT-IDENTICAL to render_frame (all RNG streams key on
# band-invariant global pixel indices). Three phases with full-frame
# barriers mirror the pass structure of render_band:
#   T: G-buffer + ReSTIR temporal   (reads only PREV-frame state)
#   S: ReSTIR spatial + shade       (reads ALL bands' temporal reservoirs)
#   P: post/TAA/accum               (reads ALL bands' hdr)

# Pixels per program before a frame is split into row bands. Measured on
# an H100 (80 GB, 400 W limit): a 3840x2160 Cornell ReSTIR frame runs as
# one program at 2.40 s/frame with an 8.75 GB peak, against 2.44 s as 4
# row bands - so one program up to 4x that frame (~35 GB by linear
# scaling, inside the 60 GB a JAX process holds by default).
_BAND_RAY_BUDGET = 4 * 3840 * 2160
# Past this many pixels per band, render_band reads the G-buffer and the
# reservoirs through lazily concatenated views instead of materializing
# their concatenation (~6 GB at 4K). The 4K measurement above ran with
# them; the materialized form at 4K is not measured.
_LAZY_VIEW_RAYS = 4 * 1024 * 1024


def auto_bands(width: int, height: int) -> int:
    """Smallest band count (dividing height) whose bands fit the budget."""
    n = width * height
    if n <= _BAND_RAY_BUDGET:
        return 1
    k = -(-n // _BAND_RAY_BUDGET)
    while height % k:
        k += 1
    return k


def frame_renderer(width: int, height: int):
    """f(scene, camera, frame_count, state, static_ok=False) for one
    device: render_frame, or render_frame_banded when auto_bands > 1."""
    bands = auto_bands(width, height)
    if bands > 1:
        return partial(render_frame_banded, width=width, height=height,
                       n_bands=bands)
    return partial(render_frame, width=width, height=height)


@partial(jax.jit, static_argnames=("width", "height", "band_h"))
def _banded_temporal(scene, camera, frame_count, y0, prev_gb, prev_res,
                     static_ok, width: int, height: int, band_h: int):
    ctx = restir_ops.make_ctx(width, height, y0=y0, band_h=band_h)
    prev_view = views_mod.trivial_pair_view(prev_gb, prev_res, width, height)
    prev_gb_rows = jax.lax.dynamic_slice_in_dim(
        prev_gb, y0 * width, band_h * width)
    gb, gb_traced = _gb_for_band(scene, camera, prev_gb_rows, ctx, static_ok)
    reservoirs_t, rays_t = restir_ops.restir_temporal(
        scene, gb, prev_view, camera, frame_count, ctx, static_ok=static_ok)
    n_primary = band_h * width
    primary_rays = (jnp.float32(n_primary) if gb_traced is None
                    else jnp.where(gb_traced, 0.0, jnp.float32(n_primary)))
    return (gb, gbuffer_ops.pack_gb(gb), reservoirs_t,
            restir_ops.pack_reservoirs(reservoirs_t), primary_rays + rays_t)


@partial(jax.jit, static_argnames=("width", "height", "band_h"))
def _banded_spatial(scene, camera, frame_count, y0, gb, reservoirs_t,
                    gb_full, res_t_full, width: int, height: int,
                    band_h: int):
    ctx = restir_ops.make_ctx(width, height, y0=y0, band_h=band_h)
    comb_view = views_mod.trivial_pair_view(gb_full, res_t_full,
                                            width, height)
    reservoirs_s, hdr, rays_s, diag = restir_ops.restir_spatial(
        scene, gb, comb_view, reservoirs_t, camera, frame_count, ctx)
    return restir_ops.pack_reservoirs(reservoirs_s), hdr, rays_s, diag


_POST_HALO = 2   # post stencil reach: 5x5 bilateral (KERNEL_RADIUS=2)


def _sliced_band_view(flat, y0, width: int, height: int, band_h: int):
    """Band-local BandView with a _POST_HALO halo cut from a FULL-res flat
    array: the sequential-band analogue of halo_exchange (same data
    layout - top halo rows first; out-of-image halo rows are zeros that
    the coverage masks drop, exactly like ppermute edge devices)."""
    trailing = flat.shape[1:]
    pad = [(width * _POST_HALO, width * _POST_HALO)] + [(0, 0)] * len(trailing)
    padded = jnp.pad(flat, pad)          # halo rows above row 0 / below end
    ext = jax.lax.dynamic_slice_in_dim(
        padded, y0 * width, (band_h + 2 * _POST_HALO) * width)
    return views_mod.BandView(data=ext, y0=y0, width=width, height=height,
                              band_h=band_h, halo=_POST_HALO)


@partial(jax.jit, static_argnames=("width", "height", "band_h"))
def _banded_post(frame_count, y0, gb, gb_full, hdr_full, accum_full,
                 width: int, height: int, band_h: int):
    ctx = restir_ops.make_ctx(width, height, y0=y0, band_h=band_h)
    # hdr/gb feed _PlaneStencil, which requires a view covering EXACTLY
    # band_h + 2*halo rows (its taps slice [halo : halo+band_h]); the
    # history view is only read via global-coord gathers, so it stays
    # full-res - reprojection reach is unbounded and must not be halo-
    # clamped if banded is to stay bit-identical to render_frame.
    ldr, accum = post_ops.post_process(
        _sliced_band_view(hdr_full, y0, width, height, band_h), gb,
        _sliced_band_view(gb_full, y0, width, height, band_h),
        views_mod.trivial_view(accum_full, width, height), frame_count, ctx)
    return ldr, accum


def render_frame_banded(scene, camera, frame_count, state, width: int,
                        height: int, n_bands: int, static_ok=False):
    """One ReSTIR frame as n_bands sequential row-band programs, one device.

    Same signature/returns as render_frame and bit-identical output (see
    module note above); use for frames too large to schedule as one XLA
    program. `state` is NOT donated (band programs read full-res prev
    arrays while writing band outputs).
    """
    assert height % n_bands == 0, (height, n_bands)
    band_h = height // n_bands
    frame_count = jnp.uint32(frame_count)
    static_ok = jnp.asarray(static_ok, jnp.bool_)

    gb_bands, gbp_bands, rt_bands, rtp_bands, rays = [], [], [], [], []
    for b in range(n_bands):
        gb, gbp, rt, rtp, r = _banded_temporal(
            scene, camera, frame_count, jnp.int32(b * band_h),
            state["gb"], state["res"], static_ok,
            width=width, height=height, band_h=band_h)
        gb_bands.append(gb); gbp_bands.append(gbp)
        rt_bands.append(rt); rtp_bands.append(rtp)
        rays.append(r)
    gb_full = jnp.concatenate(gbp_bands, axis=0)
    res_t_full = jnp.concatenate(rtp_bands, axis=0)

    resp_bands, hdr_bands, diags = [], [], []
    for b in range(n_bands):
        resp, hdr, rays_s, diag = _banded_spatial(
            scene, camera, frame_count, jnp.int32(b * band_h),
            gb_bands[b], rt_bands[b], gb_full, res_t_full,
            width=width, height=height, band_h=band_h)
        resp_bands.append(resp); hdr_bands.append(hdr)
        rays.append(rays_s); diags.append(diag)
    hdr_full = jnp.concatenate(hdr_bands, axis=0)

    ldr_bands, accum_bands = [], []
    for b in range(n_bands):
        ldr, accum = _banded_post(
            frame_count, jnp.int32(b * band_h), gb_bands[b], gb_full,
            hdr_full, state["accum"], width=width, height=height,
            band_h=band_h)
        ldr_bands.append(ldr); accum_bands.append(accum)

    new_state = {"gb": gb_full,
                 "res": jnp.concatenate(resp_bands, axis=0),
                 "accum": jnp.concatenate(accum_bands, axis=0)}
    aux = {"rays": _sum_list(rays)}
    for k in diags[0]:
        aux[k] = _sum_list([d[k] for d in diags])
    return (jnp.concatenate(ldr_bands, axis=0), hdr_full, new_state, aux)


def _sum_list(xs):
    """Pairwise device-scalar sum (no host sync - stays async)."""
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out
