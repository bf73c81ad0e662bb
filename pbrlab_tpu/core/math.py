"""Vector math on JAX arrays with a trailing xyz axis.

Vectorized replacement for the reference scalar float3 kit
(/root/reference/src/type.h:8-83, /root/reference/src/pbrlab_math.h:20-55,
/root/reference/src/pbrlab-util.h). All functions are shape-polymorphic: they
operate on arrays of shape [..., 3] (or scalars broadcast against them), so a
whole wavefront of lanes is processed per call.
"""
from __future__ import annotations

import jax.numpy as jnp

# Constants mirroring /root/reference/src/pbrlab_math.h:9-13.
PI = 3.141592653589793
INV_PI = 1.0 / PI
EPS = 1e-3
# Embree-safe "infinity" (reference kInf, pbrlab_math.h:11).
INF = 1.844e18


def vdot(a, b):
    """Dot product over the trailing xyz axis -> [...]."""
    return jnp.sum(a * b, axis=-1)


def vcross(a, b):
    return jnp.cross(a, b)


def vlength(a):
    return jnp.sqrt(jnp.maximum(vdot(a, a), 0.0))


def vnormalize(a):
    """Normalize like the reference (no zero-guard: 1/sqrt)."""
    inv = 1.0 / jnp.sqrt(jnp.maximum(vdot(a, a), 1e-20))
    return a * inv[..., None]


def splat(x, like=None):
    """Broadcast a scalar/[...]-shaped value to an xyz vector [..., 3]."""
    x = jnp.asarray(x)
    return jnp.broadcast_to(x[..., None], x.shape + (3,))


def saturate(x):
    return jnp.clip(x, 0.0, 1.0)


def lerp(a, b, t):
    return a + (b - a) * t


def sqr(x):
    return x * x


def safe_sqrt(x):
    """SafeSqrtf (reference pbrlab_math.h): sqrt(max(x, 0))."""
    return jnp.sqrt(jnp.maximum(x, 0.0))


def grad_safe_sqrt(x, eps=1e-12):
    """sqrt with a floor that also keeps the BACKWARD pass finite.

    d(sqrt)/dx -> inf as x -> 0+; when such a sqrt sits inside the untaken
    operand of a jnp.where, the where-backward's masked gradient (0) meets
    that inf as 0 * inf = NaN (the "where trap"). The eps floor (primal
    shift <= 1e-6, below every use's working range) bounds the derivative
    at 5e5 so masking zeroes it cleanly.
    """
    return jnp.sqrt(jnp.maximum(x, eps))


def average(c):
    """(r+g+b)/3 — reference pbrlab-util.h Average."""
    return jnp.mean(c, axis=-1)


def spectrum_norm(c):
    """max(r,g,b) — reference pbrlab-util.h SpectrumNorm."""
    return jnp.max(c, axis=-1)


def rgb_to_y(c):
    """Luminance — reference pbrlab-util.h RgbToY."""
    return 0.212671 * c[..., 0] + 0.715160 * c[..., 1] + 0.072169 * c[..., 2]


def safe_divide_spectrum(a, b):
    """Component-wise a/b with 0 where |b| < float eps (pbrlab-util.h)."""
    tiny = jnp.finfo(jnp.float32).eps
    return jnp.where(jnp.abs(b) < tiny, 0.0, a / jnp.where(jnp.abs(b) < tiny, 1.0, b))


def is_black(c):
    """|r|+|g|+|b| < eps — reference pbrlab-util.h IsBlack."""
    return jnp.sum(jnp.abs(c), axis=-1) < jnp.finfo(jnp.float32).eps


def finite3(c):
    return jnp.all(jnp.isfinite(c), axis=-1)


def fresnel_dielectric_cos(cos_i, eta):
    """Dielectric Fresnel without computing the refracted direction.

    Vectorized port of the reference FresnelDielectricCos
    (/root/reference/src/closure/closure-util.h:10-31): eta==0 -> 1,
    cos<0 flips eta, g<=0 -> TIR -> 1.
    """
    eta = jnp.asarray(eta, jnp.float32)
    cos_i = jnp.asarray(cos_i, jnp.float32)
    eta_eff = jnp.where(cos_i < 0.0, 1.0 / jnp.where(eta == 0.0, 1.0, eta), eta)
    c = jnp.abs(cos_i)
    g2 = eta_eff * eta_eff - 1.0 + c * c
    g = jnp.sqrt(jnp.maximum(g2, 1e-20))
    a = (g - c) / (g + c)
    b = (c * (g + c) - 1.0) / (c * (g - c) + 1.0)
    refl = 0.5 * a * a * (1.0 + b * b)
    refl = jnp.where(g2 > 0.0, refl, 1.0)
    return jnp.where(jnp.abs(eta) < jnp.finfo(jnp.float32).eps, 1.0, refl)


def small_table_fetch(table, idx, max_rows: int = 32):
    """Per-lane row fetch [R, C][idx] that sidesteps XLA's gather.

    For the small id-indexed tables of a scene (materials, emissive faces)
    a masked select over the R rows is R*C elementwise ops per lane and no
    gather. Falls back to a real gather past max_rows. idx is assumed
    pre-clipped to [0, R).
    """
    r = table.shape[0]
    if r == 0 or r > max_rows:
        return table[idx]
    out = jnp.broadcast_to(table[0], idx.shape + (table.shape[1],))
    for k in range(1, r):
        out = jnp.where((idx == k)[..., None], table[k], out)
    return out
