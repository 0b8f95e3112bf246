"""BSDF library: GGX specular (VNDF-sampled), Lambert diffuse, glass delta.

Vectorized port of the reference's shading model (restir.wgsl:160-371):
  - GGX NDF (:182-187), exact height-uncorrelated Smith G1/G (:189-199)
  - VNDF sampling (:202-216)
  - Schlick Fresnel (:170-172) and dielectric reflectance (:175-180)
  - stochastic lobe selection by Fresnel-vs-diffuse luminance (:327-348)
  - glass as a delta lobe: Schlick-probability reflect/refract (:311-325)
  - combined eval_bsdf (:278-305) / eval_pdf (:249-276)

RNG consumption per lane mirrors the reference exactly (see utils/rng.py):
glass consumes 1 draw, non-glass consumes 3 (lobe + 2 for VNDF/unit-vector).

Vectors/colors are component-major V3s (utils/vec3): the wavefront never
materializes [R, 3] arrays.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..utils import rng, vec3
from ..utils.vec3 import V3

PI = np.float32(np.pi)


def fresnel_schlick(f0, v_dot_h):
    """f0: V3; v_dot_h: [R]. Returns V3."""
    c = jnp.clip(1.0 - v_dot_h, 0.0, 1.0)
    c5 = c ** 5
    return f0 + (1.0 - f0) * c5


def reflectance(cosine, ref_idx):
    """Schlick dielectric reflectance (restir.wgsl:175-180)."""
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * (1.0 - cosine) ** 5


def ndf_ggx(n_dot_h, roughness):
    a = roughness * roughness
    a2 = a * a
    d = n_dot_h * n_dot_h * (a2 - 1.0) + 1.0
    # a2=0 & d=0 (delta lobe at grazing NDF peak) must yield 0, not 0/0
    return a2 / jnp.maximum(PI * d * d, 1e-20)


def g1_ggx(n_dot_v, roughness):
    a2 = roughness * roughness
    return 2.0 * n_dot_v / jnp.maximum(
        n_dot_v + jnp.sqrt(a2 + (1.0 - a2) * n_dot_v * n_dot_v), 1e-12
    )


def geometry_smith(n_dot_l, n_dot_v, roughness):
    return g1_ggx(n_dot_l, roughness) * g1_ggx(n_dot_v, roughness)


def sample_ggx_vndf(wo_local, roughness, u1, u2):
    """Visible-NDF sampling in local (z-up) space (restir.wgsl:202-216).

    wo_local: V3. Returns V3.
    """
    alpha = roughness * roughness
    vh = vec3.normalize(V3(alpha * wo_local.x, alpha * wo_local.y,
                           wo_local.z))
    lensq = vh.x ** 2 + vh.y ** 2
    pos_len = lensq > 0.0
    inv_len = jnp.where(pos_len,
                        1.0 / jnp.sqrt(jnp.maximum(lensq, 1e-20)), 0.0)
    t1 = V3(jnp.where(pos_len, -vh.y * inv_len, 1.0),
            jnp.where(pos_len, vh.x * inv_len, 0.0),
            jnp.zeros_like(inv_len))
    t2 = vec3.cross(vh, t1)
    r = jnp.sqrt(u1)
    phi = 2.0 * PI * u2
    p1 = r * jnp.cos(phi)
    p2 = r * jnp.sin(phi)
    s = 0.5 * (1.0 + vh.z)
    p2_lerp = (1.0 - s) * jnp.sqrt(jnp.maximum(1.0 - p1 * p1, 0.0)) + s * p2
    nh = (t1 * p1 + t2 * p2_lerp
          + vh * jnp.sqrt(jnp.maximum(0.0, 1.0 - p1 * p1
                                      - p2_lerp * p2_lerp)))
    return vec3.normalize(V3(alpha * nh.x, alpha * nh.y,
                             jnp.maximum(nh.z, 0.0)))


def _spec_diff_probability(base_color, metallic, ffnormal, wo):
    """Fresnel-luminance lobe probability (restir.wgsl:328-334)."""
    f0 = _mix_f0(base_color, metallic)
    f_view = fresnel_schlick(f0, jnp.maximum(vec3.dot(ffnormal, wo), 0.0))
    lum_spec = vec3.luminance(f_view)
    lum_diff = vec3.luminance(base_color * (1.0 - metallic))
    return jnp.clip(lum_spec / (lum_spec + lum_diff + 1e-4), 0.001, 0.999)


def _mix_f0(base_color, metallic):
    return 0.04 + (base_color - 0.04) * metallic


def eval_pdf(normal, wi, wo, mat, base_color):
    """restir.wgsl:249-276. Returns 0 for glass (delta) and invalid configs."""
    n_dot_l = vec3.dot(normal, wi)
    n_dot_v = vec3.dot(normal, wo)
    prob_spec = _spec_diff_probability(base_color, mat["metallic"], normal, wo)

    h = vec3.normalize(wi + wo)
    n_dot_h = jnp.maximum(vec3.dot(normal, h), 0.0)
    d = ndf_ggx(n_dot_h, mat["roughness"])
    g1 = g1_ggx(jnp.maximum(n_dot_v, 1e-6), mat["roughness"])
    pdf_spec = (d * g1) / jnp.maximum(4.0 * n_dot_v, 1e-6)
    pdf_diff = jnp.maximum(n_dot_l, 0.0) / PI

    pdf = prob_spec * pdf_spec + (1.0 - prob_spec) * pdf_diff
    invalid = (mat["transmission"] > 0.01) | (n_dot_l <= 0.0) | (n_dot_v <= 0.0)
    return jnp.where(invalid, 0.0, pdf)


def eval_bsdf(normal, wi, wo, mat, base_color):
    """restir.wgsl:278-305. Returns V3; 0 for glass/invalid configs."""
    n_dot_l = vec3.dot(normal, wi)
    n_dot_v = vec3.dot(normal, wo)
    h = vec3.normalize(wi + wo)
    n_dot_h = jnp.maximum(vec3.dot(normal, h), 0.0)
    h_dot_v = jnp.maximum(vec3.dot(h, wo), 0.0)
    f0 = _mix_f0(base_color, mat["metallic"])

    d = ndf_ggx(n_dot_h, mat["roughness"])
    g = geometry_smith(jnp.maximum(n_dot_l, 1e-6), jnp.maximum(n_dot_v, 1e-6),
                       mat["roughness"])
    f = fresnel_schlick(f0, h_dot_v)
    specular = (f * (d * g)) / jnp.maximum(4.0 * n_dot_l * n_dot_v, 1e-3)

    kd = (1.0 - f) * (1.0 - mat["metallic"])
    diffuse = kd * base_color / PI

    invalid = (mat["transmission"] > 0.01) | (n_dot_l <= 0.0) | (n_dot_v <= 0.0)
    return vec3.where(invalid, 0.0, diffuse + specular)


def sample_bsdf(state, wo, hit_pos, ffnormal, front_face, mat, base_color,
                active=None):
    """restir.wgsl:307-371. Returns (state, dict(wi, pdf, weight, is_delta)).

    wo/ffnormal/base_color are V3s; wi/weight in the result are V3s.

    Per-lane RNG draws match the reference order exactly:
      glass lane:      1 draw  (reflect-vs-refract)
      non-glass lane:  3 draws (lobe select, then u1, u2)
    Lanes with ``active`` False draw nothing (dead paths in the wavefront).
    """
    is_glass = mat["transmission"] > 0.01
    if active is None:
        active = jnp.ones_like(is_glass)

    # --- glass delta lobe ---
    state, r_glass = rng.rand_if(state, is_glass & active)
    refraction_ratio = jnp.where(front_face, 1.0 / mat["ior"], mat["ior"])
    cos_theta = jnp.minimum(vec3.dot(wo, ffnormal), 1.0)
    sin_theta = jnp.sqrt(jnp.maximum(1.0 - cos_theta * cos_theta, 0.0))
    cannot_refract = refraction_ratio * sin_theta > 1.0
    do_reflect = cannot_refract | (reflectance(cos_theta, refraction_ratio) > r_glass)
    wi_reflect = vec3.reflect(-wo, ffnormal)
    wi_refract = vec3.refract(-wo, ffnormal, refraction_ratio)
    wi_glass = vec3.where(do_reflect, wi_reflect, wi_refract)

    # --- unified PBR stochastic lobe ---
    prob_spec = _spec_diff_probability(base_color, mat["metallic"], ffnormal, wo)
    not_glass = ~is_glass & active
    state, r_lobe = rng.rand_if(state, not_glass)
    state, r1 = rng.rand_if(state, not_glass)
    state, r2 = rng.rand_if(state, not_glass)
    pick_spec = r_lobe < prob_spec

    tangent, bitangent = vec3.orthonormal_basis(ffnormal)
    wo_local = vec3.to_local(tangent, bitangent, ffnormal, wo)
    wm_local = sample_ggx_vndf(wo_local, mat["roughness"], r1, r2)
    wm = vec3.to_world(tangent, bitangent, ffnormal, wm_local)
    wi_spec = vec3.reflect(-wo, wm)

    # diffuse: ffnormal + unit sphere sample (consumes the same r1, r2)
    z = r1 * 2.0 - 1.0
    a = r2 * (2.0 * PI)
    rxy = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    unit = V3(rxy * jnp.cos(a), rxy * jnp.sin(a), z)
    wi_diff = vec3.normalize(ffnormal + unit)

    wi_pbr = vec3.where(pick_spec, wi_spec, wi_diff)
    n_dot_l = vec3.dot(ffnormal, wi_pbr)
    n_dot_v = vec3.dot(ffnormal, wo)
    valid = (n_dot_l > 0.0) & (n_dot_v > 0.0)

    bsdf_val = eval_bsdf(ffnormal, wi_pbr, wo, mat, base_color)
    pdf = eval_pdf(ffnormal, wi_pbr, wo, mat, base_color)
    weight_pbr = vec3.where(
        valid & (pdf > 0.0),
        (bsdf_val * n_dot_l) / jnp.maximum(pdf, 1e-20),
        0.0,
    )

    wi = vec3.where(is_glass, wi_glass, wi_pbr)
    weight = vec3.where(is_glass, base_color, weight_pbr)
    out_pdf = jnp.where(is_glass, 0.0, jnp.where(valid, pdf, 0.0))
    return state, {
        "wi": wi,
        "pdf": out_pdf,
        "weight": weight,
        "is_delta": is_glass,
    }
