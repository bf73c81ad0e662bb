"""Bilinear texture fetch from the padded atlas stack.

Reference: /root/reference/src/texture.{h,cc} FetchFloatN with clamp
addressing and the bilinear filter in image-utils.cc:99-167. Textures are
stacked into one [T, Hmax, Wmax, 3] atlas (scene.build).

The 4-corner bilinear fetch is restructured to gather once per lane: `build_quad_atlas` bakes each texel's 2x2
clamped neighborhood into a fat [T, H, W, 12] table (inside jit, so
texture gradients still flow to the original atlas leaf), and
`fetch_float3_quad` does ONE 12-float gather + lerp per lane — 4x fewer
gathers than the naive corner fetches.
"""
from __future__ import annotations

import jax.numpy as jnp


def fetch_float_n(atlas, sizes, tex_id, u, v):
    """Per-lane bilinear fetch of ALL atlas channels (FetchFloatN,
    /root/reference/src/texture.h:28-34 — channel-count generic).

    atlas [T, H, W, C], sizes [T, 2] (h, w), tex_id [N] (>=0), u/v [N].
    Clamp addressing; pixel centers at integer+0.5 like stb/reference.
    """
    tid = jnp.maximum(tex_id, 0)
    h = sizes[tid, 0].astype(jnp.float32)
    w = sizes[tid, 1].astype(jnp.float32)
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0

    def at(xi, yi):
        xi = jnp.clip(xi, 0, (w - 1).astype(jnp.int32))
        yi = jnp.clip(yi, 0, (h - 1).astype(jnp.int32))
        return atlas[tid, yi, xi]

    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)
    c00 = at(x0i, y0i)
    c10 = at(x0i + 1, y0i)
    c01 = at(x0i, y0i + 1)
    c11 = at(x0i + 1, y0i + 1)
    fx = fx[..., None]
    fy = fy[..., None]
    return (c00 * (1 - fx) * (1 - fy) + c10 * fx * (1 - fy)
            + c01 * (1 - fx) * fy + c11 * fx * fy)


def fetch_float3(atlas, sizes, tex_id, u, v):
    """Per-lane bilinear RGB fetch (first 3 channels of the atlas)."""
    return fetch_float_n(atlas, sizes, tex_id, u, v)[..., :3]


def build_quad_atlas(atlas, sizes):
    """Bake each texel's clamped 2x2 neighborhood: [T,H,W,C] -> [T,H,W,4C]
    (c00 c10 c01 c11). Runs inside jit (build_fat_tables) so gradients
    flow through the bake to the atlas leaf."""
    t, h, w, _ = atlas.shape
    ti = jnp.arange(t)[:, None, None]
    yi = jnp.arange(h)[None, :, None]
    xi = jnp.arange(w)[None, None, :]
    # clamp at each texture's OWN extent (textures are padded to Hmax/Wmax)
    x1 = jnp.minimum(xi + 1, sizes[:, 1][:, None, None] - 1)
    y1 = jnp.minimum(yi + 1, sizes[:, 0][:, None, None] - 1)
    c00 = atlas
    c10 = atlas[ti, yi, x1]
    c01 = atlas[ti, y1, xi]
    c11 = atlas[ti, y1, x1]
    return jnp.concatenate([c00, c10, c01, c11], axis=-1)


def fetch_float3_quad(quad, sizes, tex_id, u, v):
    """Per-lane bilinear RGB fetch from the quad-texel atlas: one gather.

    Matches fetch_float3 exactly, including clamp addressing: when x0 < 0
    both x-corners clamp to texel 0 in the naive fetch, which equals the
    quad fetch at x0=0 with fx forced to 0 (same for y)."""
    tid = jnp.maximum(tex_id, 0)
    h = sizes[tid, 0].astype(jnp.float32)
    w = sizes[tid, 1].astype(jnp.float32)
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = jnp.where(x0 < 0.0, 0.0, x - x0)
    fy = jnp.where(y0 < 0.0, 0.0, y - y0)
    x0i = jnp.clip(x0.astype(jnp.int32), 0, (w - 1).astype(jnp.int32))
    y0i = jnp.clip(y0.astype(jnp.int32), 0, (h - 1).astype(jnp.int32))
    row = quad[tid, y0i, x0i]  # [N, 4C]
    c = quad.shape[-1] // 4
    fx = fx[..., None]
    fy = fy[..., None]
    out = (row[:, 0:c] * (1 - fx) * (1 - fy)
           + row[:, c:2 * c] * fx * (1 - fy)
           + row[:, 2 * c:3 * c] * (1 - fx) * fy
           + row[:, 3 * c:4 * c] * fx * fy)
    return out[..., :3]
