"""Wavefront path tracer: the JAX replacement for the per-thread megakernel.

Faithful vectorized port of `trace_path` (restir.wgsl:460-737 /
restir_spatial.wgsl:480-762): starts from the G-buffer hit (depth 0),
performs NEE+MIS direct lighting at every diffuse vertex, BSDF-samples the
next direction, Russian roulette from depth 3, MAX_DEPTH 8. The per-lane RNG
consumption order matches the reference exactly so that seed-replay ReSTIR
(reservoirs storing only the winning seed) reproduces identical paths.

Divergent control flow ("break") becomes an active-lane mask; terminated
lanes skip traversal via the traversal kernel's `active` fast path. The
bounce loop is a single `lax.while_loop` body (compiled once).

The wavefront is COMPONENT-MAJOR (utils/vec3): positions, directions,
colors and throughput are V3s of dense [R] arrays, never a row-major
[R, 3] intermediate with a minor dim of 3. [R, 3] arrays appear only at
the module boundary (the G-buffer dict in, radiance/v1 out).

Reference quirks intentionally preserved (they define the target radiance):
  * the bounce loop's `is_specular` reuses the *primary* surface's glass
    flag (restir.wgsl:705 uses `is_glass` from :554), not the current hit's;
  * the emissive-hit MIS cosine uses `dot(ffnormal, -wo)` (restir.wgsl:690)
    which is <= 0 on front hits, so BSDF-sampled light hits after a diffuse
    vertex get MIS weight 0 (NEE carries direct lighting there);
  * non-light materials in the bounce loop emit only their emissive TEXTURE
    (restir.wgsl:675-678), the emissive factor alone contributes at depth 0.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..scene.material import NO_TEXTURE
from ..utils import rng, vec3
from ..utils.vec3 import V3
from . import bsdf as bsdf_ops
from . import lights as light_ops
from . import textures
from .hit import (apply_normal_map, gather_light, gather_material,
                  reconstruct_hit)
from .trace_api import scene_trace

MAX_DEPTH = 8          # restir.wgsl:5
RR_START_DEPTH = 3     # restir.wgsl:593
T_MIN = 1e-3
T_MAX = 100.0          # restir.wgsl:605


def _nee_draw(scene, state, active, pos, ffnormal, wo, mat, base_color,
              num_lights):
    """NEE sampling with MIS, WITHOUT the shadow trace
    (restir.wgsl:554-575 / 702-724): consumes up to 3 draws per active
    lane (light pick + 2 area sample) and returns the shadow ray + the
    untested contribution, so the caller can BATCH the shadow trace with
    the next bounce trace in one traversal call (half the trace calls
    per depth; each call carries a fixed cost).

    Returns (state, ray, pre): ray = dict(origin V3, dir V3, t_max [R],
    active [R]); pre = dict(contrib V3, shadow_active [R], n_rays).
    """
    r = state.shape[0]
    if num_lights == 0:
        z = jnp.zeros((r,), jnp.float32)
        z3 = V3(z, z, z)
        ray = dict(origin=pos, dir=z3, t_max=z,
                   active=jnp.zeros((r,), jnp.bool_))
        return state, ray, dict(contrib=z3,
                                shadow_active=ray["active"],
                                n_rays=jnp.float32(0.0))

    state, r_pick = rng.rand_if(state, active)
    light_idx = jnp.floor(r_pick * num_lights).astype(jnp.int32)
    idx_ok = light_idx < num_lights
    smp_mask = active & idx_ok
    state, r1 = rng.rand_if(state, smp_mask)
    state, r2 = rng.rand_if(state, smp_mask)

    light_rows = gather_light(scene, light_idx)
    ls = light_ops.sample_light(light_rows, r1, r2)

    pdf_nee = ls["pdf"] * (1.0 / num_lights)
    to_light = vec3.normalize(ls["pos"] - pos)
    p_bsdf = bsdf_ops.eval_pdf(ffnormal, to_light, wo, mat, base_color)
    mis_weight = pdf_nee / jnp.maximum(pdf_nee + p_bsdf, 1e-20)
    weight = mis_weight / jnp.maximum(pdf_nee, 1e-20)

    # eval_direct_lighting (restir.wgsl:443-459)
    offset_pos = pos + ffnormal * 1e-3
    delta = ls["pos"] - offset_pos
    dist = vec3.length(delta)
    l_dir = delta / jnp.maximum(dist, 1e-12)
    n_dot_l = jnp.maximum(vec3.dot(ffnormal, l_dir), 0.0)
    l_dot_n = jnp.maximum(vec3.dot(-l_dir, ls["normal"]), 0.0)
    geo_ok = (n_dot_l > 0.0) & (l_dot_n > 0.0)
    shadow_active = smp_mask & geo_ok

    f = bsdf_ops.eval_bsdf(ffnormal, l_dir, wo, mat, base_color)
    g = (n_dot_l * l_dot_n) / jnp.maximum(dist * dist, 1e-12)
    contrib = ls["emission"] * ls["emission_w"] * f * (g * weight)
    ray = dict(origin=offset_pos, dir=l_dir,
               t_max=jnp.maximum(dist * 0.999, 0.0), active=shadow_active)
    return state, ray, dict(
        contrib=contrib, shadow_active=shadow_active,
        n_rays=jnp.sum(shadow_active.astype(jnp.float32)))


def _nee_apply(pre, blocked):
    visible = pre["shadow_active"] & ~blocked
    return vec3.where(visible, pre["contrib"], 0.0)


def _cat(a, b):
    return jnp.concatenate([a, b], axis=0)


def _cat3(a: V3, b: V3) -> V3:
    return V3(_cat(a.x, b.x), _cat(a.y, b.y), _cat(a.z, b.z))


def _dual_trace(scene, s_ray, b_origin, b_dir, b_active, num_lights):
    """ONE traversal call for [this depth's NEE shadow rays | the next
    depth's bounce rays] - closest-hit for both (a windowed closest hit
    answers occlusion exactly). Origins/dirs are V3 component tuples all
    the way into the traversal (the kernel builds its [8, R] ray block
    from the components directly - no [R, 3] round trip).
    Returns (blocked [R], bounce res)."""
    r = b_active.shape[0]
    if num_lights == 0:
        res = scene_trace(scene, b_origin, b_dir, T_MIN, T_MAX,
                          active=b_active)
        return jnp.zeros((r,), jnp.bool_), res
    o = _cat3(s_ray["origin"], b_origin)
    d = _cat3(s_ray["dir"], b_dir)
    t_max = _cat(s_ray["t_max"], jnp.full((r,), T_MAX, jnp.float32))
    act = _cat(s_ray["active"], b_active)
    res = scene_trace(scene, o, d, T_MIN, t_max, active=act)
    blocked = res["tri"][:r] >= 0
    return blocked, {k: v[r:] for k, v in res.items()}


def trace_path(scene, gb, view_pos, seed, active=None):
    """Trace one candidate path per lane from the G-buffer surface.

    Args:
      scene: CompiledScene.
      gb: flat G-buffer dict: valid [R] bool, pos [R,3], oct_normal [R,2],
          uv [R,2], albedo [R,3], mat_id [R] i32.
      view_pos: [3] camera world position.
      seed: [R] uint32 path seeds (ReSTIR reservoir `y`).
      active: optional [R] bool - lanes to trace (ANDed with gb validity);
        masked lanes return zeros (replay-dedup lanes skip the trace).

    Returns dict: radiance [R,3], valid_v1 [R] bool, v1_pos [R,3],
    v1_normal [R,3] (the reconnection vertex for shift mapping,
    restir.wgsl:624-629).
    """
    r = gb["pos"].shape[0]
    num_lights = scene.num_lights
    state = jnp.asarray(seed, jnp.uint32)

    active = gb["valid"] if active is None else gb["valid"] & active
    pos = vec3.of(gb["pos"])
    normal = vec3.oct_decode(gb["oct_normal"][:, 0], gb["oct_normal"][:, 1])
    ffnormal = normal
    uv = (gb["uv"][:, 0], gb["uv"][:, 1])
    mat_id = gb["mat_id"]
    front_face = jnp.ones((r,), jnp.bool_)

    mat = gather_material(scene, mat_id)
    base_color = vec3.of(gb["albedo"])
    mat = dict(mat)
    mat["base_color"] = base_color

    # --- metallic-roughness map at depth 0 (restir.wgsl:503-511) ---
    # sampling is compiled out when no material in the scene has the channel
    if "metallic_roughness" in scene.tex_channels:
        mr = textures.sample_bilinear(
            scene.data_tex, mat["metallic_roughness_tex_id"], uv[0], uv[1])
        has_mr = mat["metallic_roughness_tex_id"] != NO_TEXTURE
        mat["metallic"] = jnp.where(has_mr, mr.z * mat["metallic"],
                                    mat["metallic"])
        mat["roughness"] = jnp.where(has_mr, mr.y * mat["roughness"],
                                     mat["roughness"])

    zeros = jnp.zeros((r,), jnp.float32)
    accumulated = V3(zeros, zeros, zeros)
    throughput = V3(jnp.ones((r,), jnp.float32),
                    jnp.ones((r,), jnp.float32),
                    jnp.ones((r,), jnp.float32))
    view = V3(jnp.broadcast_to(view_pos[0], (r,)),
              jnp.broadcast_to(view_pos[1], (r,)),
              jnp.broadcast_to(view_pos[2], (r,)))
    wo = vec3.normalize(view - pos)

    # --- primary emission, light-source pixels terminate (restir.wgsl:522-552)
    if "emissive" in scene.tex_channels:
        em_tex = textures.sample_bilinear(
            scene.color_tex, mat["emissive_tex_id"], uv[0], uv[1])
        has_em_tex = mat["emissive_tex_id"] != NO_TEXTURE
        emission = mat["emissive_factor"] * vec3.where(has_em_tex, em_tex,
                                                       1.0)
    else:
        emission = mat["emissive_factor"]
    accumulated = accumulated + vec3.where(active, emission, 0.0)
    is_light_px = active & (mat["light_index"] >= 0)
    active = active & ~is_light_px

    # --- primary NEE draws (restir.wgsl:554-575; trace batched below) ---
    is_glass_primary = mat["transmission"] > 0.01
    is_specular0 = is_glass_primary | (mat["roughness"] < 0.05)
    nee_mask = active & ~is_specular0
    state, s_ray, s_pre = _nee_draw(scene, state, nee_mask, pos, ffnormal,
                                    wo, mat, base_color, num_lights)
    ray_count = s_pre["n_rays"]
    previous_was_diffuse = nee_mask
    thr_pre = throughput

    # --- primary BSDF sample (restir.wgsl:577-584) ---
    state, sc = bsdf_ops.sample_bsdf(
        state, wo, pos, ffnormal, front_face, mat, base_color, active=active
    )
    dead = vec3.all_leq_zero(sc["weight"])
    active = active & ~dead
    last_bsdf_pdf = sc["pdf"]
    throughput = throughput * sc["weight"]
    next_dir = sc["wi"]

    # ONE batched traversal: primary shadow rays + first bounce rays
    # (the bounce count rides the loop's post-RR accounting, matching
    # the unbatched formulation exactly)
    offset_dir0 = ffnormal * jnp.sign(vec3.dot(ffnormal, next_dir))
    origin_b = pos + offset_dir0 * 1e-3
    blocked0, res_pending = _dual_trace(
        scene, s_ray, origin_b, next_dir, active, num_lights)
    accumulated = accumulated + vec3.where(
        nee_mask, _nee_apply(s_pre, blocked0), 0.0) * thr_pre

    valid_v1 = jnp.zeros((r,), jnp.bool_)
    v1_pos = V3(zeros, zeros, zeros)
    v1_normal = V3(zeros, zeros, zeros)

    # ------------------------------------------------------------------
    # Bounce loop, depth 1..MAX_DEPTH-1 (restir.wgsl:590-733)
    # ------------------------------------------------------------------
    import jax

    carry = dict(
        state=state, active=active, accumulated=accumulated,
        throughput=throughput, origin=origin_b,
        next_dir=next_dir, last_bsdf_pdf=last_bsdf_pdf,
        previous_was_diffuse=previous_was_diffuse,
        valid_v1=valid_v1, v1_pos=v1_pos, v1_normal=v1_normal,
        ray_count=ray_count, depth=jnp.int32(1),
        res_t=res_pending["t"], res_tri=res_pending["tri"],
    )
    if scene.instanced:
        carry["res_inst"] = res_pending["inst"]

    def body(c):
        depth = c["depth"]
        state = c["state"]
        active = c["active"]
        throughput = c["throughput"]
        accumulated = c["accumulated"]

        # Russian roulette (restir.wgsl:593-598) - drawn BEFORE the hit
        # mask applies, exactly like the unbatched order (the bounce was
        # already traced at the END of the previous iteration, but its
        # result is consumed only after this draw)
        rr_mask = active & (depth >= RR_START_DEPTH)
        state, r_rr = rng.rand_if(state, rr_mask)
        p = vec3.vmax(throughput)
        survival = jnp.clip(p, 0.05, 0.95)
        die = rr_mask & (r_rr > survival)
        active = active & ~die
        throughput = vec3.where(
            rr_mask & active, throughput / survival, throughput
        )

        # pending bounce hit (restir.wgsl:601-607; post-RR count matches
        # the unbatched formulation's per-bounce ray accounting)
        next_dir = c["next_dir"]
        origin = c["origin"]
        res = {"t": c["res_t"], "tri": c["res_tri"]}
        ray_count = c["ray_count"] + jnp.sum(active.astype(jnp.float32))
        active = active & (res["tri"] >= 0)

        h = reconstruct_hit(scene, res["tri"], origin, next_dir, res["t"],
                            inst_id=c.get("res_inst"))

        # reconnection vertex (restir.wgsl:624-629)
        first = active & (depth == 1)
        valid_v1 = c["valid_v1"] | first
        v1_pos = vec3.where(first, h["pos"], c["v1_pos"])
        v1_normal = vec3.where(first, h["normal"], c["v1_normal"])

        wo = -next_dir
        mat = gather_material(scene, h["mat_id"])
        base_color = mat["base_color"]
        uv_u, uv_v = h["uv"]
        if "color" in scene.tex_channels:
            tex_color = textures.sample_bilinear(
                scene.color_tex, mat["tex_id"], uv_u, uv_v)
            base_color = base_color * tex_color
        if "occlusion" in scene.tex_channels:
            occ = textures.sample_bilinear(
                scene.data_tex, mat["occlusion_tex_id"], uv_u, uv_v).x
            base_color = base_color * occ

        ffnormal = h["ffnormal"]
        if "normal" in scene.tex_channels:
            nmap = textures.sample_bilinear(
                scene.data_tex, mat["normal_tex_id"], uv_u, uv_v)
            ffnormal = apply_normal_map(
                ffnormal, h["tangent"], h["tangent_w"], nmap,
                mat["normal_tex_id"] != NO_TEXTURE)

        # emissive texture of non-light materials (restir.wgsl:675-678)
        if "emissive" in scene.tex_channels:
            em_tex = textures.sample_bilinear(
                scene.color_tex, mat["emissive_tex_id"], uv_u, uv_v)
            em_mask = active & (mat["light_index"] == -1) & (
                mat["emissive_tex_id"] != NO_TEXTURE)
            accumulated = accumulated + vec3.where(
                em_mask, em_tex, 0.0) * throughput

        # emissive light hit with MIS (restir.wgsl:683-699)
        light_hit = active & (mat["light_index"] >= 0)
        lrow = gather_light(scene, jnp.maximum(mat["light_index"], 0))
        le = lrow["emission"] * lrow["emission_w"]
        dist_sq = h["t"] * h["t"]
        light_cos = jnp.maximum(vec3.dot(ffnormal, -wo), 0.0)  # quirk, see module docstring
        p_bsdf = c["last_bsdf_pdf"]
        p_nee = (1.0 / jnp.maximum(lrow["area"], 1e-12)) * (
            dist_sq / jnp.maximum(light_cos, 1e-12)
        ) * (1.0 / max(num_lights, 1))
        mis_light = jnp.where(
            light_cos > 1e-3, p_bsdf / jnp.maximum(p_bsdf + p_nee, 1e-20), 0.0
        )
        mis_light = jnp.where(c["previous_was_diffuse"], mis_light, 1.0)
        add_light = light_hit & h["front"]
        accumulated = accumulated + vec3.where(
            add_light, le * mis_light, 0.0
        ) * throughput
        active = active & ~light_hit

        # NEE draws (restir.wgsl:702-724) - note primary glass flag quirk
        is_specular_b = is_glass_primary | (mat["roughness"] < 0.05)
        nee_mask = active & ~is_specular_b
        state, s_ray, s_pre = _nee_draw(scene, state, nee_mask, h["pos"],
                                        ffnormal, wo, mat, base_color,
                                        num_lights)
        ray_count = ray_count + s_pre["n_rays"]
        previous_was_diffuse = jnp.where(active, nee_mask, c["previous_was_diffuse"])
        thr_pre = throughput

        # next BSDF sample (restir.wgsl:727-732)
        state, sc = bsdf_ops.sample_bsdf(
            state, wo, h["pos"], ffnormal, h["front"], mat, base_color, active=active
        )
        dead = vec3.all_leq_zero(sc["weight"])
        active = active & ~dead
        throughput = vec3.where(active, throughput * sc["weight"], throughput)

        # ONE batched traversal: this depth's shadow rays + the next
        # depth's bounce rays (halves the sweep-call count per depth).
        # The bounce half is consumed by the NEXT iteration; when this is
        # the last one (depth+1 == MAX_DEPTH, or every lane just died) a
        # scalar lax.cond routes the call to an R-wide any-hit occlusion
        # query instead of the 2R-wide dual sweep - the blocked flags are
        # identical (a windowed closest hit and an any-hit agree on "is
        # anything in (t_min, t_max)") and the unused bounce result
        # becomes a dummy miss the exited loop never reads. Saves one
        # R-wide sweep per trace_path call (restir.wgsl's per-thread
        # loop simply `break`s past its final ray_query; the wavefront's
        # batched formulation otherwise cannot).
        offset_dir = ffnormal * jnp.sign(vec3.dot(ffnormal, sc["wi"]))
        origin_n = h["pos"] + offset_dir * 1e-3

        def _trace_dual(_):
            blocked, res = _dual_trace(scene, s_ray, origin_n, sc["wi"],
                                       active, num_lights)
            out = {"t": res["t"], "tri": res["tri"]}
            if scene.instanced:
                out["inst"] = res["inst"]
            return blocked, out

        def _trace_shadow_only(_):
            if num_lights == 0:
                blocked = jnp.zeros((r,), jnp.bool_)
            else:
                from .trace_api import scene_occluded

                blocked = scene_occluded(
                    scene, s_ray["origin"], s_ray["dir"], T_MIN,
                    s_ray["t_max"], active=s_ray["active"])
            res = {"t": jnp.zeros((r,), jnp.float32),
                   "tri": jnp.full((r,), -1, jnp.int32)}
            if scene.instanced:
                res["inst"] = jnp.full((r,), -1, jnp.int32)
            return blocked, res

        import os
        if os.environ.get("TPU_RT_LAST_SKIP", "1") != "0":
            last = (depth + 1 >= MAX_DEPTH) | ~jnp.any(active)
            blocked, res_n = jax.lax.cond(last, _trace_shadow_only,
                                          _trace_dual, None)
        else:       # A/B: always-dual (pre-routing behavior)
            blocked, res_n = _trace_dual(None)
        accumulated = accumulated + vec3.where(
            nee_mask, _nee_apply(s_pre, blocked), 0.0) * thr_pre

        out = dict(
            state=state, active=active, accumulated=accumulated,
            throughput=throughput, origin=origin_n,
            next_dir=sc["wi"], last_bsdf_pdf=sc["pdf"],
            previous_was_diffuse=previous_was_diffuse,
            valid_v1=valid_v1, v1_pos=v1_pos, v1_normal=v1_normal,
            ray_count=ray_count, depth=depth + 1,
            res_t=res_n["t"], res_tri=res_n["tri"],
        )
        if scene.instanced:
            out["res_inst"] = res_n["inst"]
        return out

    # while_loop so a wavefront whose lanes have ALL terminated skips the
    # remaining depths entirely (per-lane results identical to a full
    # unrolled loop: dead lanes consume no RNG and contribute nothing).
    carry = jax.lax.while_loop(
        lambda c: (c["depth"] < MAX_DEPTH) & jnp.any(c["active"]),
        body, carry)

    return {
        "radiance": vec3.arr(carry["accumulated"]),
        "valid_v1": carry["valid_v1"],
        "v1_pos": vec3.arr(carry["v1_pos"]),
        "v1_normal": vec3.arr(carry["v1_normal"]),
        # exact traversal-query count (bounce + shadow rays), for Mrays/s
        "rays": carry["ray_count"],
    }
