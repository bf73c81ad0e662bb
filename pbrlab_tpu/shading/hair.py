"""Principled (energy-conserving) Hair BSDF, vectorized over lanes.

Semantics from /root/reference/src/closure/energy‐conserving-hair-bsdf.h
(pbrt-v3/Cycles lineage with the "improved robe evaluation" of Path Tracing
in Production 2018: USE_IMPROVED_ROBE_EVALUATION SafeLogI0 Horner
polynomials, :92-170) and /root/reference/src/shader/hair-shader.cc
(BetamToV roughness mapping :19-27, CalcS azimuthal logistic scale :29-33,
sigma_a from RGB :35-46 or melanin :48-64, 4-lobe tints, shift in degrees).

Hair frame convention (hair-shader.cc:164-173): ex = curve tangent,
omega[0] = sin(theta) along the hair, phi = atan2(omega[2], omega[1]).
`EnergyConservingHairBsdfCosPdf` returns f*cos; callers divide by
|omega_in[0]| for NEE (hair-shader.cc:196-198) and use f_cos/pdf directly
for the throughput update (:225).

The reference evaluates the transcendental-heavy lobes with scalar
fast_math polynomials; the accelerator's native transcendentals (jnp ops)
are accurate and vectorize, so we use them directly.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import jax.numpy as jnp

from ..core.math import PI, rgb_to_y, safe_sqrt, saturate, sqr

_V_MIN, _V_MAX = 1e-5, 1e4


class HairBsdf(NamedTuple):
    sigma_a: jnp.ndarray  # [N,3]
    h: jnp.ndarray  # [N] azimuthal offset in [-1,1]
    v: jnp.ndarray  # [N,4] longitudinal variances per lobe
    s: jnp.ndarray  # [N] azimuthal logistic scale
    eta: jnp.ndarray  # [N]
    alpha: jnp.ndarray  # [N] scale tilt (radians)
    tints: jnp.ndarray  # [N,4,3]


def betam_to_v(beta_m):
    """Roughness -> longitudinal variance for the 4 lobes
    (hair-shader.cc:19-27)."""
    v0 = sqr(0.726 * beta_m + 0.812 * sqr(beta_m) + 3.7 * beta_m ** 20)
    return jnp.stack([v0, 0.25 * v0, 4.0 * v0, 4.0 * v0], axis=-1)


def calc_s(beta_n):
    """Azimuthal roughness -> trimmed-logistic scale (hair-shader.cc:29-33)."""
    b2 = sqr(beta_n)
    return jnp.sqrt(PI / 8.0) * (0.265 * beta_n + 1.194 * b2
                                 + 5.372 * b2 ** 11)


def sigma_a_from_rgb(c, beta_n):
    """Absorption from RGB color (hair-shader.cc:35-46)."""
    denom = (5.969 - 0.215 * beta_n + 2.532 * sqr(beta_n)
             - 10.73 * beta_n ** 3 + 5.574 * beta_n ** 4
             + 0.245 * beta_n ** 5)
    return sqr(jnp.log(jnp.maximum(c, 1e-6)) / denom[..., None])


def sigma_a_from_melanin(melanin, melanin_redness, random_value=0.5):
    """Absorption from eumelanin/pheomelanin (hair-shader.cc:48-64)."""
    factor = 1.0 + 2.0 * (random_value - 0.5)
    m = saturate(melanin) * factor
    redness = saturate(melanin_redness)
    m = -jnp.log(jnp.maximum(1.0 - m, 1e-4))
    eu = m * (1.0 - redness)
    pheo = m * redness
    return jnp.stack([
        jnp.maximum(0.0, eu * 0.506 + pheo * 0.343),
        jnp.maximum(0.0, eu * 0.841 + pheo * 0.733),
        jnp.maximum(0.0, eu * 1.653 + pheo * 1.924)], axis=-1)


def param_to_bsdf(mat: Dict[str, jnp.ndarray], geom_v) -> HairBsdf:
    """HairBsdfParameter -> closure (hair-shader.cc ParamToBsdf:103-153).
    geom_v is the curve hit's ribbon parameter (the reference uses
    TraceResult.v as h, hair-shader.cc:183)."""
    rgb = sigma_a_from_rgb(mat["hair_base_color"], mat["azimuthal_roughness"])
    mel = sigma_a_from_melanin(mat["melanin"], mat["melanin_redness"])
    sigma_a = jnp.where((mat["hair_coloring"] == 0)[..., None], rgb, mel)
    tints = jnp.stack([mat["hair_specular_tint"], mat["transmission_tint"],
                       mat["second_specular_tint"],
                       jnp.ones_like(mat["hair_specular_tint"])], axis=-2)
    return HairBsdf(
        sigma_a=sigma_a,
        h=geom_v,
        v=betam_to_v(mat["hair_roughness"]),
        s=calc_s(mat["azimuthal_roughness"]),
        eta=mat["hair_ior"],
        alpha=mat["shift"] * (PI / 180.0),
        tints=tints)


def _safe_log_i0(x):
    """SafeLogI0 with the improved-robe Horner evaluation (:141-170)."""
    x = jnp.abs(x)
    p_small = jnp.asarray([
        1.00000003928615375e+00, 2.49999576572179639e-01,
        2.77785268558399407e-02, 1.73560257755821695e-03,
        6.96166518788906424e-05, 1.89645733877137904e-06,
        4.29455004657565361e-08, 3.90565476357034480e-10,
        1.48095934745267240e-11])
    p_large = jnp.asarray([
        3.98942651588301770e-01, 4.98327234176892844e-02,
        2.91866904423115499e-02, 1.35614940793742178e-02,
        1.31409251787866793e-01])
    x22 = x * x / 4.0
    small = jnp.log(jnp.maximum(x22 * jnp.polyval(p_small[::-1], x22),
                                1e-38)) + 1.0
    inv_x = 1.0 / jnp.maximum(x, 7.5)
    px = jnp.polyval(p_large[::-1], inv_x)
    large = x + 0.5 * jnp.log(jnp.maximum(px * px * inv_x, 1e-38))
    return jnp.where(x < 7.5, small, large)


def _mp(sin_i, cos_i, sin_o, cos_o, v):
    """Longitudinal lobe Mp (:172-202, improved-robe branch)."""
    v = jnp.clip(v, _V_MIN, _V_MAX)
    ccv = cos_i * cos_o / v
    ssv = sin_i * sin_o / v
    return jnp.exp(_safe_log_i0(ccv) - ssv - 1.0 / v + jnp.log(1.0 / v)
                   - jnp.log(jnp.maximum(1.0 - jnp.exp(-2.0 / v), 1e-38)))


def _fr_dielectric(cos_i, eta_i, eta_t):
    """pbrt dielectric Fresnel (:205-229)."""
    cos_i = jnp.clip(cos_i, -1.0, 1.0)
    entering = cos_i > 0.0
    ei = jnp.where(entering, eta_i, eta_t)
    et = jnp.where(entering, eta_t, eta_i)
    ci = jnp.abs(cos_i)
    si = safe_sqrt(1.0 - ci * ci)
    st = ei / et * si
    tir = st >= 1.0
    ct = safe_sqrt(1.0 - st * st)
    r_parl = (et * ci - ei * ct) / jnp.maximum(et * ci + ei * ct, 1e-12)
    r_perp = (ei * ci - et * ct) / jnp.maximum(ei * ci + et * ct, 1e-12)
    return jnp.where(tir, 1.0, 0.5 * (r_parl * r_parl + r_perp * r_perp))


def _ap(cos_theta_o, eta, h, T):
    """Lobe attenuations (R, TT, TRT, residual) (:231-255) -> [N,4,3]."""
    cos_gamma_o = safe_sqrt(1.0 - h * h)
    cos_theta = cos_theta_o * cos_gamma_o
    f = _fr_dielectric(cos_theta, jnp.ones_like(eta), eta)[..., None]
    ap0 = jnp.broadcast_to(f, T.shape)
    ap1 = sqr(1.0 - f) * T
    ap2 = ap1 * T * f
    ap3 = ap2 * f * T / jnp.maximum(1.0 - T * f, 1e-12)
    ap3 = jnp.where(jnp.isfinite(ap3), ap3, 0.0)
    return jnp.stack([ap0, ap1, ap2, ap3], axis=-2)


def _logistic(x, s):
    x = jnp.abs(x)
    num = jnp.exp(-x / s)
    return num / jnp.maximum(s * sqr(1.0 + num), 1e-38)


def _logistic_cdf(x, s):
    return 1.0 / (1.0 + jnp.exp(-x / s))


def _trimmed_logistic(x, s, a, b):
    return _logistic(x, s) / jnp.maximum(
        _logistic_cdf(b, s) - _logistic_cdf(a, s), 1e-12)


def _phi_lobe(p, gamma_o, gamma_t):
    return 2.0 * p * gamma_t - 2.0 * gamma_o + p * PI


def _np_lobe(phi, p, s, gamma_o, gamma_t):
    dphi = phi - _phi_lobe(p, gamma_o, gamma_t)
    dphi = dphi - jnp.floor(dphi / (2.0 * PI)) * (2.0 * PI)
    dphi = jnp.where(dphi >= PI, dphi - 2.0 * PI, dphi)
    return _trimmed_logistic(dphi, s, -PI, PI)


def _tilted_angles(sin_o, cos_o, alpha):
    """Scale-tilt 2k-angle recurrences (:309-339) -> sin/cos per lobe [N,4]."""
    s1 = jnp.sin(alpha)
    c1 = jnp.cos(alpha)
    s2 = 2.0 * s1 * c1
    c2 = c1 * c1 - s1 * s1
    s4 = 2.0 * s2 * c2
    c4 = c2 * c2 - s2 * s2
    sin_crt = jnp.stack([
        sin_o * c2 - cos_o * s2,   # R: rotate by -2 alpha
        sin_o * c1 + cos_o * s1,   # TT: rotate by alpha
        sin_o * c4 + cos_o * s4,   # TRT: rotate by 4 alpha
        sin_o], axis=-1)
    cos_crt = jnp.stack([
        cos_o * c2 + sin_o * s2,
        cos_o * c1 - sin_o * s1,
        cos_o * c4 - sin_o * s4,
        cos_o], axis=-1)
    return sin_crt, cos_crt


def _common_terms(omega_out, bsdf: HairBsdf):
    sin_o = omega_out[..., 0]
    cos_o = safe_sqrt(1.0 - sqr(sin_o))
    sin_crt, cos_crt = _tilted_angles(sin_o, cos_o, bsdf.alpha)
    phi_o = jnp.arctan2(omega_out[..., 2], omega_out[..., 1])
    sin_theta_t = sin_o / bsdf.eta
    cos_theta_t = safe_sqrt(1.0 - sqr(sin_theta_t))
    etap = jnp.sqrt(jnp.maximum(bsdf.eta * bsdf.eta - sqr(sin_o), 1e-12)) \
        / jnp.maximum(cos_o, 1e-12)
    sin_gamma_t = bsdf.h / etap
    cos_gamma_t = safe_sqrt(1.0 - sqr(sin_gamma_t))
    gamma_t = jnp.arcsin(jnp.clip(sin_gamma_t, -1.0, 1.0))
    l = 2.0 * cos_gamma_t / jnp.maximum(cos_theta_t, 1e-12)
    T = jnp.exp(-bsdf.sigma_a * l[..., None])
    gamma_o = jnp.arcsin(jnp.clip(bsdf.h, -1.0, 1.0))
    ap = _ap(cos_o, bsdf.eta, bsdf.h, T)  # [N,4,3]
    ap_y = rgb_to_y(ap)  # [N,4]
    ap_pdf = ap_y / jnp.maximum(jnp.sum(ap_y, axis=-1, keepdims=True), 1e-12)
    return (sin_o, cos_o, sin_crt, cos_crt, phi_o, gamma_o, gamma_t, ap,
            ap_pdf)


def _eval_lobes(sin_i, cos_i, phi, sin_crt, cos_crt, bsdf, gamma_o, gamma_t,
                ap, ap_pdf):
    """Sum the 4 lobes -> (f_cos [N,3], pdf [N]) (:377-405)."""
    f = jnp.zeros_like(bsdf.sigma_a)
    pdf = jnp.zeros_like(sin_i)
    for p in range(3):
        mpnp = _mp(sin_i, cos_i, sin_crt[..., p], cos_crt[..., p],
                   bsdf.v[..., p]) * _np_lobe(phi, float(p), bsdf.s, gamma_o,
                                              gamma_t)
        pdf = pdf + mpnp * ap_pdf[..., p]
        f = f + mpnp[..., None] * ap[..., p, :] * bsdf.tints[..., p, :]
    mpnp = _mp(sin_i, cos_i, sin_crt[..., 3], cos_crt[..., 3],
               bsdf.v[..., 3]) * (1.0 / (2.0 * PI))
    pdf = pdf + mpnp * ap_pdf[..., 3]
    f = f + mpnp[..., None] * ap[..., 3, :] * bsdf.tints[..., 3, :]
    bad = ~jnp.isfinite(f).all(-1) | ~jnp.isfinite(pdf)
    return (jnp.where(bad[..., None], 0.0, f), jnp.where(bad, 0.0, pdf))


def eval_cos_pdf(omega_in, omega_out, bsdf: HairBsdf):
    """EnergyConservingHairBsdfCosPdf (:295-405) -> (f*cos [N,3], pdf [N])."""
    (sin_o, cos_o, sin_crt, cos_crt, phi_o, gamma_o, gamma_t, ap,
     ap_pdf) = _common_terms(omega_out, bsdf)
    sin_i = omega_in[..., 0]
    cos_i = safe_sqrt(1.0 - sqr(sin_i))
    phi_i = jnp.arctan2(omega_in[..., 2], omega_in[..., 1])
    phi = phi_i - phi_o
    return _eval_lobes(sin_i, cos_i, phi, sin_crt, cos_crt, bsdf, gamma_o,
                       gamma_t, ap, ap_pdf)


def _sample_trimmed_logistic(s, a, b, u):
    T = _logistic_cdf(b, s) - _logistic_cdf(a, s)
    inner = 1.0 / jnp.maximum(
        u * T + 1.0 / (1.0 + jnp.exp(-a / s)), 1e-12) - 1.0
    ret = -s * jnp.log(jnp.maximum(inner, 1e-38))
    return jnp.clip(ret, a, b)


def sample(omega_out, bsdf: HairBsdf, u0, u1, u2, u3):
    """EnergyConservingHairSample (:419-572).

    Returns (omega_in [N,3], f_cos [N,3], pdf [N]).
    """
    (sin_o, cos_o, sin_crt, cos_crt, phi_o, gamma_o, gamma_t, ap,
     ap_pdf) = _common_terms(omega_out, bsdf)

    # lobe selection by the ap luminance CDF (:484-497)
    cdf = jnp.cumsum(ap_pdf, axis=-1)
    p = jnp.where(u0 < cdf[..., 0], 0,
                  jnp.where(u0 < cdf[..., 1], 1,
                            jnp.where(u0 < cdf[..., 2], 2, 3)))
    vp = jnp.take_along_axis(bsdf.v, p[..., None], axis=-1)[..., 0]
    vp = jnp.clip(vp, _V_MIN, _V_MAX)
    sin_oc = jnp.take_along_axis(sin_crt, p[..., None], axis=-1)[..., 0]
    cos_oc = jnp.take_along_axis(cos_crt, p[..., None], axis=-1)[..., 0]

    # theta via lobe-variance inversion (:499-511)
    u = 1.0 + vp * jnp.log(jnp.maximum(
        u1 + (1.0 - u1) * jnp.exp(-2.0 / vp), 1e-38))
    sin_i = -u * sin_oc + safe_sqrt(1.0 - sqr(u)) \
        * jnp.cos(2.0 * PI * u2) * cos_oc
    cos_i = safe_sqrt(1.0 - sqr(sin_i))

    # phi (:513-519)
    dphi_lobe = (_phi_lobe(p.astype(jnp.float32), gamma_o, gamma_t)
                 + _sample_trimmed_logistic(bsdf.s, -PI, PI, u3))
    dphi = jnp.where(p < 3, dphi_lobe, 2.0 * PI * u3)
    phi_i = phi_o + dphi
    omega_in = jnp.stack([sin_i, cos_i * jnp.cos(phi_i),
                          cos_i * jnp.sin(phi_i)], axis=-1)

    f, pdf = _eval_lobes(sin_i, cos_i, dphi, sin_crt, cos_crt, bsdf, gamma_o,
                         gamma_t, ap, ap_pdf)
    return omega_in, f, pdf
