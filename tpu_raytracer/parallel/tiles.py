"""Screen-tile data parallelism: the device-mesh render pipeline.

The pixel grid is sharded across devices as horizontal row bands over a
1-D `jax.sharding.Mesh` axis ("tiles"), the multi-device extension of
the reference's single-GPU thread grid (SURVEY.md §2.3). The mesh follows
the algorithm alone: on GPUs joined all to all by NVLink it needs no
shape beyond a line of devices.

  * scene data (BVH/triangles, materials, lights, textures) is REPLICATED -
    scenes are tiny next to device memory;
  * per-pixel state (G-buffer, reservoirs, accumulation) lives sharded on
    its owning device for the whole frame - zero cross-device traffic
    except:
  * neighbor-dependent passes (temporal reprojection, spatial ReSTIR disk
    taps, post stencils, history bilinear) read through ppermute-halo
    BandViews (parallel/views.py) - the ring-exchange analogue of
    sequence/context parallelism;
  * the final LDR frame is gathered with an all_gather only for
    display/PNG (the reference's swapchain present / readback,
    state.rs:226-268).

Reprojection/tap reach beyond the halo is dropped (reuse disabled for that
lane) - bounded, documented degradation under fast camera motion.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import restir as restir_ops
from ..render import pipeline as pipeline_mod
from . import views as views_mod

AXIS = "tiles"
# Halo must cover the spatial-ReSTIR disk radius (10 px) and post stencils
# (2 px); bands shorter than the halo clamp it, which silently drops
# long-range taps - use images with height >= 16 * n_devices in production.
DEFAULT_HALO = 16


def make_mesh(devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    import numpy as np

    return Mesh(np.asarray(devices), (AXIS,))


def shard_state(state: dict, mesh: Mesh) -> dict:
    """Place FrameState row-band-sharded on the mesh (leading axis split)."""
    sharding = NamedSharding(mesh, P(AXIS))
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, sharding), state)


def replicate(tree, mesh: Mesh):
    sharding = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sharding), tree)


def make_render_frame_tiled(mesh: Mesh, width: int, height: int,
                            halo: int = DEFAULT_HALO):
    """Build the jitted multi-device frame function for a fixed resolution.

    Returns f(scene, camera, frame_count, state, static_ok=False) ->
    (ldr_full, hdr_full, new_state, aux) - the same shape as
    pipeline.render_frame so the app can swap pipelines freely: `state`
    stays band-sharded across frames; ldr/hdr are replicated (all_gather)
    for display/screenshots; aux["rays"] is the mesh-wide
    traversal-query count (psum).
    """
    n_dev = mesh.devices.size
    assert height % n_dev == 0, "height must divide evenly into row bands"
    band_h = height // n_dev
    if band_h < halo:
        import warnings

        warnings.warn(
            f"row bands of {band_h} px are shorter than the {halo} px halo "
            f"({n_dev} devices x {height} px): spatial-ReSTIR taps and post "
            "stencils beyond the band drop their reuse for those lanes. "
            f"Use height >= {halo * n_dev} for full-quality output.",
            stacklevel=2)
    halo = min(halo, band_h)

    def per_band(scene, camera, frame_count, state, static_ok):
        d = jax.lax.axis_index(AXIS)
        y0 = d.astype(jnp.int32) * band_h
        ctx = restir_ops.make_ctx(width, height, y0=y0, band_h=band_h)

        def make_view(flat):
            return views_mod.halo_exchange(flat, width, band_h, halo, AXIS, y0)

        ldr, hdr, new_state, aux = pipeline_mod.render_band(
            scene, camera, frame_count, state, ctx, make_view,
            static_ok=static_ok)
        # display gather (only LDR + HDR leave the owning device)
        ldr_full = jax.lax.all_gather(ldr, AXIS, axis=0).reshape(-1, 3)
        hdr_full = jax.lax.all_gather(hdr, AXIS, axis=0).reshape(-1, 3)
        aux = {"rays": jax.lax.psum(aux["rays"], AXIS)}
        return ldr_full, hdr_full, new_state, aux

    shard_p = P(AXIS)
    state_specs = jax.tree_util.tree_map(lambda _: shard_p,
                                         pipeline_mod.init_state(8, 8))

    fn = jax.shard_map(
        per_band, mesh=mesh,
        in_specs=(P(), P(), P(), state_specs, P()),
        out_specs=(P(), P(), state_specs, P()),
        check_vma=False,
    )
    jitted = jax.jit(fn, donate_argnums=(3,))

    def call(scene, camera, frame_count, state, static_ok=False):
        return jitted(scene, camera, frame_count, state,
                      jnp.asarray(static_ok, jnp.bool_))

    return call
