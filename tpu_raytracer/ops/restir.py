"""ReSTIR: seed-replay reservoir resampling (temporal + spatial).

Vectorized port of restir.wgsl:788-918 (temporal) and
restir_spatial.wgsl:857-1016 (spatial). Reservoirs are SoA arrays; each
stores only the winning path SEED `y` plus cached p_hat and the first-bounce
vertex `s_path` for the reconnection-shift Jacobian - paths are re-traced
from the seed at shade time exactly like the reference (restir.wgsl:28-35).

The reference's ping-pong reservoir buffers (restir.rs:362-378 fixed
read/write flow) become pure dataflow: temporal consumes last frame's
spatial output and returns a fresh reservoir set.

All neighbor-pixel reads (temporal reprojection, spatial disk taps) go
through `BandView`s (parallel/views.py), so the same code runs on one device
and row-band-sharded across a device mesh with ppermute halo exchange;
reads beyond the halo simply drop reuse for that lane.

Vector fields (s_path, rad) live as component-major V3s inside the pass
(utils/vec3 - no [R, 3] row-major intermediates); the packed
[N, 12] reservoir rows remain the storage/gather format.

RNG streams: candidate seeds come from `pcg_hash(pixel + frame * 927163)`
(restir.wgsl:797); reuse logic draws from the separate raw-LCG stream
(restir.wgsl:781-786, rand_lcg) - both reproduced bit-exactly with GLOBAL
pixel indices (band-invariant: sharding does not change the image).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils import rng, vec3
from ..utils.vec3 import V3
from . import path_trace

MAX_M_TEMPORAL = 16   # restir.wgsl:851
MAX_M_SPATIAL = 20    # restir_spatial.wgsl:893,989
MAX_W = 20.0          # restir_spatial.wgsl:1005
RES_COLS = 12         # packed reservoir row width (pack_reservoirs)


def _gb_head(comb_c):
    """Decode the G-buffer head of a packed [GB_COLS + RES_COLS] column
    list (BandView.read_cols output). Column offsets derive from the
    gbuffer layout slices so pack_gb has a single owner - a reorder or
    widening there cannot silently desync these neighbor reads (the
    reservoir tail stays `unpack_reservoir_cols(comb_c[GB_COLS:])`)."""
    from .gbuffer import GB_ALBEDO, GB_MAT, GB_OCT, GB_POS, GB_VALID

    p, o, a = GB_POS.start, GB_OCT.start, GB_ALBEDO.start
    return dict(
        pos=V3(comb_c[p], comb_c[p + 1], comb_c[p + 2]),
        norm=vec3.oct_decode(comb_c[o], comb_c[o + 1]),
        albedo=V3(comb_c[a], comb_c[a + 1], comb_c[a + 2]),
        mat=comb_c[GB_MAT].astype(jnp.int32),
        valid=comb_c[GB_VALID] > 0.5,
    )


def make_ctx(width: int, height: int, y0=0, band_h=None) -> dict:
    """Per-band frame context: band origin row and static frame size."""
    return {
        "y0": jnp.asarray(y0, jnp.int32),
        "width": width,
        "height": height,
        "band_h": height if band_h is None else band_h,
    }


def _global_coords(ctx):
    """Per-lane global pixel coords + flat index for the band."""
    n = ctx["band_h"] * ctx["width"]
    local = jnp.arange(n, dtype=jnp.int32)
    gx = local % ctx["width"]
    gy = ctx["y0"] + local // ctx["width"]
    gidx = (gy * ctx["width"] + gx).astype(jnp.uint32)
    return gx, gy, gidx


def empty_reservoirs(n: int) -> dict:
    z = jnp.zeros((n,), jnp.float32)
    return {
        "y": jnp.zeros((n,), jnp.uint32),
        "w_sum": z,
        "M": jnp.zeros((n,), jnp.int32),
        "W": z,
        "p_hat": z,
        "s_path": V3(z, z, z),
        # Replay-dedup cache (not in the reference; radiance semantics
        # unchanged):
        # `rad` is the full RGB radiance of seed `y` as traced from THIS
        # pixel's surface; `rad_ok` marks it valid for the current frame's
        # final replay (restir_spatial.wgsl:996) - tracing is skipped for
        # those lanes since the replay is deterministic in (gb, seed).
        "rad": V3(z, z, z),
        "rad_ok": jnp.zeros((n,), jnp.bool_),
    }


def pack_reservoirs(res: dict):
    """SoA -> one [N, 12] row table for single-gather neighbor reads.

    The seed `y` is a raw uint32 bit pattern - it rides bitcast to f32
    (XLA gathers are byte-preserving; never do arithmetic on column 0).
    """
    return jnp.stack([
        jax.lax.bitcast_convert_type(res["y"], jnp.float32),
        res["w_sum"],
        res["M"].astype(jnp.float32),
        res["W"],
        res["p_hat"],
        res["s_path"].x, res["s_path"].y, res["s_path"].z,
        res["rad"].x, res["rad"].y, res["rad"].z,
        res["rad_ok"].astype(jnp.float32),
    ], axis=-1)


def unpack_reservoirs(rows):
    return unpack_reservoir_cols([rows[..., k] for k in range(12)])


def unpack_reservoir_cols(c):
    """12 dense [R] columns (pack_reservoirs order) -> reservoir dict."""
    return {
        "y": jax.lax.bitcast_convert_type(c[0], jnp.uint32),
        "w_sum": c[1],
        "M": c[2].astype(jnp.int32),
        "W": c[3],
        "p_hat": c[4],
        "s_path": V3(c[5], c[6], c[7]),
        "rad": V3(c[8], c[9], c[10]),
        "rad_ok": c[11] > 0.5,
    }


def _update_reservoir(res, mask, y_new, w, rnd, cnt, p_hat_new, s_path_new,
                      rad_new, rad_ok_new):
    """Vectorized update_reservoir (restir.wgsl:746-756) on masked lanes.

    rad_new/rad_ok_new: replay-dedup cache riding with the candidate sample
    (see empty_reservoirs) - adopted only when the sample wins (`take`).
    s_path_new/rad_new are V3s (or scalar 0.0).
    """
    w_sum = res["w_sum"] + jnp.where(mask, w, 0.0)
    m = res["M"] + jnp.where(mask, cnt, 0)
    take = mask & (rnd * w_sum < w)
    return {
        "y": jnp.where(take, y_new, res["y"]),
        "w_sum": w_sum,
        "M": m,
        "W": res["W"],
        "p_hat": jnp.where(take, p_hat_new, res["p_hat"]),
        "s_path": vec3.where(take, s_path_new, res["s_path"]),
        "rad": vec3.where(take, rad_new, res["rad"]),
        "rad_ok": jnp.where(take, rad_ok_new, res["rad_ok"]),
    }


def _is_valid_neighbor_temporal(curr_pos, curr_normal, curr_mat,
                                prev_pos, prev_normal, prev_mat, camera_pos):
    """restir.wgsl:758-778. Positions/normals are V3s; camera_pos a V3 of
    scalars."""
    ok = curr_mat == prev_mat
    ok &= vec3.dot(curr_normal, prev_normal) >= 0.99
    dd = curr_pos - prev_pos
    dist_diff_sq = vec3.dot(dd, dd)
    dc = curr_pos - camera_pos
    threshold = jnp.maximum(1e-5, vec3.dot(dc, dc) * 1e-3)
    ok &= dist_diff_sq <= threshold
    return ok


def _mat_rmt(scene, mid):
    """[R] material ids -> (roughness, metallic, transmission) dense [R]s
    in ONE fetch instead of three per-field gathers (the spatial tap scan
    used to re-fetch them on every tap). Routed through hit.fetch_cols,
    which picks the exact one-hot matmul for small tables and falls back
    to a single native row gather past the one-hot memory budget (huge
    material counts)."""
    from .hit import fetch_cols

    table = jnp.stack([scene.materials["roughness"],
                       scene.materials["metallic"],
                       scene.materials["transmission"]], axis=1)
    return fetch_cols(table, mid)


def _is_valid_neighbor_spatial(curr_specular, curr_pos, curr_normal,
                               curr_mat, n_pos, n_normal, n_mat,
                               camera_pos):
    """restir_spatial.wgsl:783-814 (specular-aware thresholds).

    curr_specular: [R] bool at the (0.2, 0.8, 0.01) validity thresholds,
    computed ONCE by the caller (this runs inside the 5-tap scan; the
    per-tap material re-fetch was 15 runtime gathers per frame)."""
    is_specular = curr_specular

    ok = curr_mat == n_mat
    ndot = vec3.dot(curr_normal, n_normal)
    dd = curr_pos - n_pos
    dist_diff_sq = vec3.dot(dd, dd)
    dc = curr_pos - camera_pos
    threshold = jnp.maximum(1e-5, vec3.dot(dc, dc) * 1e-3)

    spec_ok = (ndot >= 0.998) & (jnp.sqrt(dist_diff_sq) <= 0.01)
    diff_ok = (ndot >= 0.995) & (dist_diff_sq <= threshold)
    return ok & jnp.where(is_specular, spec_ok, diff_ok)


def _cam_v3(camera_pos, r):
    return V3(jnp.broadcast_to(camera_pos[0], (r,)),
              jnp.broadcast_to(camera_pos[1], (r,)),
              jnp.broadcast_to(camera_pos[2], (r,)))


def restir_temporal(scene, gb, prev_view, camera,
                    frame_count, ctx, static_ok=False):
    """Candidate generation + temporal reuse.

    Returns (reservoirs, ray_count).

    prev_view: BandView over last frame's CONCATENATED packed G-buffer +
    spatial reservoirs [.., GB_COLS + RES_COLS] - the reprojection tap
    reads both with ONE wide-row gather.

    static_ok: traced bool - caller asserts NOTHING changed since last
    frame (camera, scene geometry, materials, lights). Enables carrying
    the previous frame's replayed radiance as a dedup cache for temporal
    winners (a belt-and-braces identity-reprojection check is applied on
    top). Safe default False; a wrong True renders stale radiance.
    """
    width, height = ctx["width"], ctx["height"]
    gx, gy, gidx = _global_coords(ctx)
    frame = jnp.asarray(frame_count, jnp.uint32)
    seed_base = gidx + frame * jnp.uint32(927163)
    seed_candidate = rng.pcg_hash(seed_base)
    local_seed = seed_base

    n = gx.shape[0]
    valid = gb["valid"]
    res = empty_reservoirs(n)

    # Phase 1: candidate path (restir.wgsl:826-841)
    pr = path_trace.trace_path(scene, gb, camera["view_pos"][:3],
                               seed_candidate)
    pr_rad = vec3.of(pr["radiance"])
    p_hat = vec3.luminance(pr_rad)
    # candidate cache is valid unconditionally: the final replay traces
    # (gb, seed_candidate) - exactly what was just traced.
    res = _update_reservoir(res, valid, seed_candidate, p_hat,
                            jnp.float32(0.5), 1, p_hat,
                            vec3.of(pr["v1_pos"]), pr_rad, jnp.bool_(True))
    res["W"] = jnp.where(valid & (p_hat > 0.0), 1.0, 0.0)

    # Phase 2: temporal reuse (restir.wgsl:846-899)
    u_scr = (gx.astype(jnp.float32) + 0.5) / width
    v_scr = (gy.astype(jnp.float32) + 0.5) / height
    prev_u = u_scr + gb["motion"][:, 0]
    prev_v = v_scr + gb["motion"][:, 1]
    in_screen = ((prev_u >= 0.0) & (prev_u <= 1.0)
                 & (prev_v >= 0.0) & (prev_v <= 1.0))
    prev_x = (prev_u * width).astype(jnp.int32)
    prev_y = (prev_v * height).astype(jnp.int32)

    from .gbuffer import GB_COLS

    comb_c, cov = prev_view.read_cols(prev_y, prev_x)
    ph = _gb_head(comb_c)
    p_pos, p_norm, p_albedo = ph["pos"], ph["norm"], ph["albedo"]
    p_mat, p_valid = ph["mat"], ph["valid"]
    c_norm = vec3.oct_decode(gb["oct_normal"][:, 0], gb["oct_normal"][:, 1])

    mid = jnp.maximum(gb["mat_id"], 0)
    rough, metal, trans = _mat_rmt(scene, mid)
    is_specular = (rough < 0.2) | (metal > 0.8) | (trans > 0.01)

    cam3 = _cam_v3(camera["view_pos"][:3], n)
    pos = vec3.of(gb["pos"])
    geo_ok = _is_valid_neighbor_temporal(
        pos, c_norm, gb["mat_id"], p_pos, p_norm, p_mat, cam3)
    reuse = valid & in_screen & cov & p_valid & geo_ok & ~is_specular

    # albedo-luminance correction (restir.wgsl:879-898)
    albedo = vec3.of(gb["albedo"])
    l_curr = vec3.luminance(albedo) + 1e-3
    l_prev = vec3.luminance(p_albedo) + 1e-3
    albedo_ratio = l_curr / l_prev
    reuse &= (albedo_ratio < 3.0) & (albedo_ratio > 0.33)

    prev_res = unpack_reservoir_cols(comb_c[GB_COLS:])
    prev_y_seed = prev_res["y"]
    prev_w = prev_res["W"]
    prev_m = prev_res["M"]
    prev_phat = prev_res["p_hat"]
    prev_spath = prev_res["s_path"]

    p_hat_new = prev_phat * albedo_ratio
    reuse &= p_hat_new > 0.0
    clamped_m = jnp.minimum(prev_m, MAX_M_TEMPORAL)
    w_prev = p_hat_new * prev_w * clamped_m.astype(jnp.float32)

    # Temporal dedup cache: the previous frame's replay of prev_y_seed at
    # the reprojected pixel equals this frame's replay here ONLY if the
    # world is static and the reprojection is the identity - guard both
    # (prev pixel == this pixel, and the albedo ratio is exactly neutral).
    rad_carry_ok = (jnp.asarray(static_ok, jnp.bool_)
                    & prev_res["rad_ok"]
                    & (prev_x == gx) & (prev_y == gy)
                    & (jnp.abs(albedo_ratio - 1.0) < 1e-6))

    local_seed, rnd = rng.rand_lcg_if(local_seed, reuse)
    res = _update_reservoir(res, reuse, prev_y_seed, w_prev, rnd, clamped_m,
                            p_hat_new, prev_spath, prev_res["rad"],
                            rad_carry_ok)

    # Phase 3: finalize W (restir.wgsl:904-916)
    p_final = res["p_hat"]
    m_f = jnp.maximum(res["M"].astype(jnp.float32), 1.0)
    w_ok = valid & (p_final > 0.0)
    res["W"] = jnp.where(w_ok, (1.0 / jnp.maximum(p_final, 1e-20))
                         * (res["w_sum"] / m_f), 0.0)
    res["p_hat"] = jnp.where(w_ok, res["p_hat"], 0.0)
    # background lanes cleared (restir.wgsl:805-811)
    res["y"] = jnp.where(valid, res["y"], 0)
    for k in ("w_sum", "W", "p_hat"):
        res[k] = jnp.where(valid, res[k], 0.0)
    res["M"] = jnp.where(valid, res["M"], 0)
    res["s_path"] = vec3.where(valid, res["s_path"], 0.0)
    res["rad"] = vec3.where(valid, res["rad"], 0.0)
    res["rad_ok"] = valid & res["rad_ok"]
    return res, pr["rays"]


def _calculate_jacobian(curr_pos, curr_normal, curr_albedo,
                        neighbor_v1, n_pos, n_normal, n_albedo):
    """Reconnection-shift Jacobian (restir_spatial.wgsl:822-854). V3 args."""
    dir_curr = neighbor_v1 - curr_pos
    cos_curr = jnp.maximum(vec3.dot(curr_normal, vec3.normalize(dir_curr)),
                           0.0)
    dir_neigh = neighbor_v1 - n_pos
    cos_neigh = jnp.maximum(vec3.dot(n_normal, vec3.normalize(dir_neigh)),
                            0.0)

    jac = cos_curr / jnp.maximum(cos_neigh, 1e-12)
    lum_curr = vec3.luminance(curr_albedo) + 1e-3
    lum_neigh = vec3.luminance(n_albedo) + 1e-3
    jac = jac * (lum_curr / lum_neigh)
    jac = jnp.clip(jac, 0.1, 10.0)
    return jnp.where(cos_neigh <= 1e-3, 0.0, jac)


def restir_spatial(scene, gb, comb_view, in_reservoirs, camera,
                   frame_count, ctx):
    """Spatial reuse + final seed replay + shade.

    comb_view: BandView over the CURRENT frame's CONCATENATED packed
    G-buffer + temporal reservoirs - each disk tap (up to 10 px,
    restir_spatial.wgsl:903) reads both with one wide-row gather.

    Returns (out_reservoirs, hdr_radiance [n,3], ray_count, diag).
    """
    from .gbuffer import GB_COLS
    from .trace_api import scene_occluded

    width, height = ctx["width"], ctx["height"]
    gx, gy, gidx = _global_coords(ctx)
    frame = jnp.asarray(frame_count, jnp.uint32)
    seed_init = gidx + frame * jnp.uint32(0x12345678)
    local_seed = seed_init

    valid = gb["valid"]
    pos = vec3.of(gb["pos"])
    normal = vec3.oct_decode(gb["oct_normal"][:, 0], gb["oct_normal"][:, 1])
    mat_id = gb["mat_id"]
    albedo = vec3.of(gb["albedo"])
    camera_pos = camera["view_pos"][:3]
    cam3 = _cam_v3(camera_pos, gx.shape[0])

    mid = jnp.maximum(mat_id, 0)
    rough, metal, trans = _mat_rmt(scene, mid)
    is_specular = (rough < 0.1) | (metal > 0.9) | (trans > 0.1)
    # neighbor-validity specular flag (different thresholds,
    # restir_spatial.wgsl:783-814) - fetched once, used by every tap
    valid_spec = (rough < 0.2) | (metal > 0.8) | (trans > 0.01)
    num_neighbors = jnp.where(is_specular, 3, 5)   # restir_spatial.wgsl:901-910
    radius = jnp.where(is_specular, 4.0, 10.0)

    # own reservoir, M-clamped with w_sum rescale (restir_spatial.wgsl:892-896)
    res = {k: v for k, v in in_reservoirs.items()}
    over = res["M"] > MAX_M_SPATIAL
    res["w_sum"] = jnp.where(
        over, res["w_sum"] * MAX_M_SPATIAL / jnp.maximum(res["M"], 1), res["w_sum"])
    res["M"] = jnp.minimum(res["M"], MAX_M_SPATIAL)

    # Tap batching (opt-in): all 5 disk taps' neighbor reads, Jacobians
    # and shadow rays are prepared up front and their visibility
    # re-checks ride ONE any-hit traversal (5R rays, pixel-interleaved)
    # instead of 5 separate traversal calls inside the scan.
    #
    # RNG NOTE: the reference draws the reservoir-update rnd only AFTER
    # the tap passes its visibility trace (restir_spatial.wgsl:993 -
    # `update_reservoir(.., rand_lcg(..))` sits below `if !visible {
    # continue; }`), so tap i+1's position draws depend on tap i's trace
    # result. The batched path advances that one draw when the tap
    # REACHES the visibility test (shadow_active) instead, discarding it
    # if blocked - every draw is an independent uniform either way, so
    # the resampling distribution and the converged image are unchanged
    # (tests/test_render.py::test_tap_batch_converges_same); only the
    # per-sample noise realization differs from the reference stream.
    # ctx["tap_batch"]=False keeps the reference-exact sequential order.
    #
    # DEFAULT OFF: one 5R-wide call against five R-wide ones, with a
    # stacked [5, R, ...] tap materialization on top; not measured on the
    # GPU yet (ROADMAP D4).
    import os

    tap_batch = ctx.get(
        "tap_batch",
        os.environ.get("TPU_RT_TAP_BATCH", "0") != "0"
        and gx.shape[0] <= 4 * 1024 * 1024)

    def tap_prep(carry, i):
        """Draws + neighbor read + full pre-visibility gauntlet for tap i
        (everything except the trace). Returns the tap's merge operands
        and its shadow ray."""
        local_seed = carry
        it_active = valid & (i < num_neighbors)
        local_seed, r1 = rng.rand_lcg_if(local_seed, it_active)
        local_seed, r2 = rng.rand_lcg_if(local_seed, it_active)
        angle = 2.0 * jnp.pi * r1
        rad = jnp.sqrt(r2) * radius
        ox = (jnp.cos(angle) * rad).astype(jnp.int32)
        oy = (jnp.sin(angle) * rad).astype(jnp.int32)
        nx = gx + ox
        ny = gy + oy

        comb_c, cov = comb_view.read_cols(ny, nx)
        nh = _gb_head(comb_c)
        n_valid = nh["valid"]
        ok = it_active & cov & n_valid
        n_pos = nh["pos"]
        n_norm = nh["norm"]
        ok &= _is_valid_neighbor_spatial(
            valid_spec, pos, normal, mat_id, n_pos, n_norm, nh["mat"], cam3)

        nbres = unpack_reservoir_cols(comb_c[GB_COLS:])
        ok &= nbres["p_hat"] > 0.0
        jac = _calculate_jacobian(pos, normal, albedo, nbres["s_path"],
                                  n_pos, n_norm, nh["albedo"])
        ok &= ~(is_specular & ((jac < 0.5) | (jac > 2.0)))

        dir_to_v1 = nbres["s_path"] - pos
        dist_to_v1 = vec3.length(dir_to_v1)
        facing = vec3.dot(normal, dir_to_v1) > 0.0
        shadow_active = ok & facing & (dist_to_v1 > 1e-3)
        local_seed, rnd = rng.rand_lcg_if(local_seed, shadow_active)
        tap = {
            "nb_y": nbres["y"],
            "m_new": jnp.minimum(nbres["M"], MAX_M_SPATIAL),
            "p_hat_corr": nbres["p_hat"] * jac,
            "nb_w": nbres["W"],
            "nb_spath": nbres["s_path"],
            "shadow_active": shadow_active,
            "dir": dir_to_v1 / jnp.maximum(dist_to_v1, 1e-12),
            "t_max": jnp.maximum(dist_to_v1 * 0.999, 0.0),
            "rnd": rnd,
        }
        return local_seed, tap

    if tap_batch:
        local_seed, taps = jax.lax.scan(
            tap_prep, local_seed, jnp.arange(5, dtype=jnp.int32))
        r_lanes = gx.shape[0]

        # pixel-interleaved [5R] stream: pixel p's 5 taps are adjacent
        def inter(a):                                   # [5, R] -> [5R]
            return jnp.swapaxes(a, 0, 1).reshape(-1)

        def bcast(a):                                   # [R] -> [5R]
            return jnp.broadcast_to(a[:, None], (r_lanes, 5)).reshape(-1)

        act5 = inter(taps["shadow_active"])
        o5 = V3(bcast(pos.x), bcast(pos.y), bcast(pos.z))
        d5 = V3(inter(taps["dir"].x), inter(taps["dir"].y),
                inter(taps["dir"].z))
        blocked5 = scene_occluded(
            scene, o5, d5, 1e-3, inter(taps["t_max"]),
            active=act5)
        blocked = jnp.swapaxes(blocked5.reshape(r_lanes, 5), 0, 1)  # [5, R]
        ray_count = jnp.sum(act5.astype(jnp.float32))

        def merge(res, x):
            tap, blk = x
            ok = tap["shadow_active"] & ~blk
            weight = (tap["p_hat_corr"] * tap["nb_w"]
                      * tap["m_new"].astype(jnp.float32))
            res = _update_reservoir(res, ok, tap["nb_y"], weight,
                                    tap["rnd"], tap["m_new"],
                                    tap["p_hat_corr"], tap["nb_spath"],
                                    0.0, jnp.bool_(False))
            return res, None

        res, _ = jax.lax.scan(merge, res, (taps, blocked))
        return _spatial_finalize(scene, gb, res, camera_pos, valid,
                                 ray_count, ctx)

    def tap(carry, i):
        res, local_seed, ray_count = carry
        it_active = valid & (i < num_neighbors)
        local_seed, r1 = rng.rand_lcg_if(local_seed, it_active)
        local_seed, r2 = rng.rand_lcg_if(local_seed, it_active)
        angle = 2.0 * jnp.pi * r1
        rad = jnp.sqrt(r2) * radius
        ox = (jnp.cos(angle) * rad).astype(jnp.int32)
        oy = (jnp.sin(angle) * rad).astype(jnp.int32)
        nx = gx + ox
        ny = gy + oy

        comb_c, cov = comb_view.read_cols(ny, nx)
        nh = _gb_head(comb_c)
        n_valid = nh["valid"]
        n_pos = nh["pos"]
        n_norm = nh["norm"]
        n_mat = nh["mat"]
        n_alb = nh["albedo"]

        ok = it_active & cov & n_valid
        ok &= _is_valid_neighbor_spatial(
            valid_spec, pos, normal, mat_id, n_pos, n_norm, n_mat, cam3)

        nbres = unpack_reservoir_cols(comb_c[GB_COLS:])
        nb_y = nbres["y"]
        nb_w = nbres["W"]
        nb_m = nbres["M"]
        nb_phat = nbres["p_hat"]
        nb_spath = nbres["s_path"]
        ok &= nb_phat > 0.0

        jac = _calculate_jacobian(pos, normal, albedo, nb_spath, n_pos,
                                  n_norm, n_alb)
        ok &= ~(is_specular & ((jac < 0.5) | (jac > 2.0)))

        # visibility re-check to the neighbor's v1 (restir_spatial.wgsl:965-984)
        dir_to_v1 = nb_spath - pos
        dist_to_v1 = vec3.length(dir_to_v1)
        facing = vec3.dot(normal, dir_to_v1) > 0.0
        far_enough = dist_to_v1 > 1e-3
        shadow_active = ok & facing & far_enough
        ray_count = ray_count + jnp.sum(shadow_active.astype(jnp.float32))
        blocked = scene_occluded(
            scene, pos, dir_to_v1 / jnp.maximum(dist_to_v1, 1e-12),
            1e-3, jnp.maximum(dist_to_v1 * 0.999, 0.0), active=shadow_active)
        ok = shadow_active & ~blocked

        p_hat_corr = nb_phat * jac
        m_new = jnp.minimum(nb_m, MAX_M_SPATIAL)
        weight = p_hat_corr * nb_w * m_new.astype(jnp.float32)
        local_seed, rnd = rng.rand_lcg_if(local_seed, ok)
        # a neighbor's cached radiance was traced from the NEIGHBOR's
        # surface; the shift-mapped replay from this pixel differs, so
        # adopting a neighbor seed always invalidates the dedup cache.
        res = _update_reservoir(res, ok, nb_y, weight, rnd, m_new,
                                p_hat_corr, nb_spath, 0.0,
                                jnp.bool_(False))
        return (res, local_seed, ray_count), None

    (res, local_seed, ray_count), _ = jax.lax.scan(
        tap, (res, local_seed, jnp.float32(0.0)),
        jnp.arange(5, dtype=jnp.int32))
    return _spatial_finalize(scene, gb, res, camera_pos, valid, ray_count,
                             ctx)


def _spatial_finalize(scene, gb, res, camera_pos, valid, ray_count, ctx):
    """Replay winning seed + shade (restir_spatial.wgsl:996-1015).

    Replay dedup: the replay is deterministic in (gb, seed), so lanes
    whose winner carries a valid cache (own candidate, or a temporal
    winner under a static frame) skip the trace entirely - the masked
    lanes cost ~nothing in the blocked intersector (dead-block skip)."""
    cached = res["rad_ok"]
    final = path_trace.trace_path(scene, gb, camera_pos, res["y"],
                                  active=~cached)
    radiance = vec3.where(cached, res["rad"], vec3.of(final["radiance"]))
    p_hat_final = vec3.luminance(radiance)
    res["s_path"] = vec3.where(cached, res["s_path"],
                               vec3.of(final["v1_pos"]))
    m_f = jnp.maximum(res["M"].astype(jnp.float32), 1.0)
    has_energy = valid & (p_hat_final > 0.0)
    w_unclamped = (1.0 / jnp.maximum(p_hat_final, 1e-20)) * (res["w_sum"] / m_f)
    res["W"] = jnp.where(has_energy, jnp.clip(w_unclamped, 0.0, MAX_W), 0.0)
    res["p_hat"] = jnp.where(has_energy, p_hat_final, 0.0)
    hdr = vec3.arr(vec3.where(has_energy, radiance * res["W"], 0.0))

    # next-frame cache: `rad` now holds the true replay radiance of `y` at
    # this pixel (traced or equal-by-determinism).
    res["rad"] = vec3.where(valid, radiance, 0.0)
    res["rad_ok"] = valid

    for k in ("w_sum", "W", "p_hat"):
        res[k] = jnp.where(valid, res[k], 0.0)
    res["M"] = jnp.where(valid, res["M"], 0)
    res["y"] = jnp.where(valid, res["y"], 0)
    res["s_path"] = vec3.where(valid, res["s_path"], 0.0)
    diag = {"cached": jnp.sum((cached & valid).astype(jnp.float32)),
            "lanes": jnp.sum(valid.astype(jnp.float32))}
    return res, hdr, ray_count + final["rays"], diag
