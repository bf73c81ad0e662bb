"""Ray vs cubic-Bezier hair curve intersection (flat/ribbon approximation).

Replaces Embree's RTC_GEOMETRY_TYPE_FLAT_BEZIER_CURVE
(/root/reference/src/raytracer/raytracer_impl.cc:154-197). Each Bezier
segment is flattened at scene-commit time into CURVE_SUBDIV linear
sub-segments with lerped radii (host, numpy); on device a ray hits a
sub-segment when its ray-perpendicular projection passes within the local
radius — the ray-facing-ribbon model of Embree flat curves. The hit reports:

* t       — depth along the ray of the closest axis point;
* u       — curve parameter (sub-segment lerp of the segment's [0,1] span);
* v       — SIGNED ribbon offset in [-1, 1]: the azimuthal h that the hair
            BSDF consumes (TraceResult.v -> hair-shader.cc:183);
* tangent — sub-segment direction; the reference delivers the tangent
            through the geometric-normal slot (scene.cc:222-224).

Sub-segments are traversed through their own threaded BVH (same layout as
the triangle one) with the same stackless pointer walk; `curve_trace_bruteforce`
tests every sub-segment and is the plain reference for it.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import lax

from ..core.math import INF

CURVE_SUBDIV = 8


def flatten_curves(curve_pts: np.ndarray):
    """[S,4,4] Bezier control points -> sub-segment arrays (host).

    Returns dict of numpy arrays: p0,p1 [C,3], r0,r1 [C], seg [C] (source
    segment id), u0,u1 [C].
    """
    S = curve_pts.shape[0]
    if S == 0:
        return {
            "curve_p0": np.zeros((0, 3), np.float32),
            "curve_p1": np.zeros((0, 3), np.float32),
            "curve_r0": np.zeros((0,), np.float32),
            "curve_r1": np.zeros((0,), np.float32),
            "curve_seg": np.zeros((0,), np.int32),
            "curve_u0": np.zeros((0,), np.float32),
            "curve_u1": np.zeros((0,), np.float32),
        }
    t = np.linspace(0.0, 1.0, CURVE_SUBDIV + 1, dtype=np.float32)
    # cubic Bezier basis [K+1, 4]
    b = np.stack([(1 - t) ** 3, 3 * t * (1 - t) ** 2, 3 * t ** 2 * (1 - t),
                  t ** 3], axis=-1)
    pts = np.einsum("kc,scq->skq", b, curve_pts)  # [S, K+1, 4]
    p = pts[..., :3]
    r = pts[..., 3]
    out = {
        "curve_p0": p[:, :-1].reshape(-1, 3).astype(np.float32),
        "curve_p1": p[:, 1:].reshape(-1, 3).astype(np.float32),
        "curve_r0": r[:, :-1].reshape(-1).astype(np.float32),
        "curve_r1": r[:, 1:].reshape(-1).astype(np.float32),
        "curve_seg": np.repeat(np.arange(S, dtype=np.int32), CURVE_SUBDIV),
        "curve_u0": np.tile(t[:-1], S).astype(np.float32),
        "curve_u1": np.tile(t[1:], S).astype(np.float32),
    }
    return out


def subsegment_bounds(flat):
    bmin = np.minimum(flat["curve_p0"] - flat["curve_r0"][:, None],
                      flat["curve_p1"] - flat["curve_r1"][:, None])
    bmax = np.maximum(flat["curve_p0"] + flat["curve_r0"][:, None],
                      flat["curve_p1"] + flat["curve_r1"][:, None])
    return bmin, bmax


def _ribbon_intersect(org, direction, p0, p1, r0, r1, min_t, max_t):
    """Ray vs ray-facing ribbon around segment [p0, p1], lanes x prims.

    org/direction [..., 3]; p0/p1/r0/r1 broadcastable to [..., 3]/[...].
    Returns (hit, t, s, v_signed) with s the axis parameter in [0,1].
    """
    a = p0 - org
    b = p1 - org
    ad = jnp.sum(a * direction, axis=-1)
    bd = jnp.sum(b * direction, axis=-1)
    a_perp = a - ad[..., None] * direction
    b_perp = b - bd[..., None] * direction
    seg = b_perp - a_perp
    denom = jnp.sum(seg * seg, axis=-1)
    s = -jnp.sum(a_perp * seg, axis=-1) / jnp.maximum(denom, 1e-12)
    s = jnp.where(denom > 1e-12, jnp.clip(s, 0.0, 1.0), 0.0)
    closest = a_perp + s[..., None] * seg
    d2 = jnp.sum(closest * closest, axis=-1)
    r = r0 + (r1 - r0) * s
    t = ad + s * (bd - ad)
    hit = (d2 <= r * r) & (t >= min_t) & (t <= max_t) & (r > 0.0)
    # signed ribbon offset: sign from the (direction x tangent) bitangent
    tangent = p1 - p0
    bitangent = jnp.cross(direction, tangent)
    bit_len = jnp.sqrt(jnp.maximum(
        jnp.sum(bitangent * bitangent, axis=-1), 1e-20))
    # offset vector from the axis point to the ray line is -closest
    v_signed = -jnp.sum(closest * bitangent, axis=-1) / (
        bit_len * jnp.maximum(r, 1e-12))
    v_signed = jnp.clip(v_signed, -1.0, 1.0)
    return hit, t, s, v_signed


def curve_trace(scene, org, direction, min_t, max_t, any_hit=False):
    """Closest hit over hair sub-segments via the curve BVH.

    Returns dict(t, u, v, seg) with seg = -1 on miss; u = curve parameter,
    v = signed ribbon offset (the hair BSDF h).
    """
    n_nodes = scene["cbvh_skip"].shape[0]
    N = org.shape[0]
    leaf_size = scene["cbvh_prim_ids"].shape[0] and 4
    prim_ids = scene["cbvh_prim_ids"]
    inv_dir = 1.0 / jnp.where(jnp.abs(direction) < 1e-12,
                              jnp.where(direction < 0, -1e-12, 1e-12),
                              direction)

    def cond(state):
        return jnp.any(state[0] < n_nodes)

    def body(state):
        cur, best_t, best_u, best_v, best_seg = state
        active = cur < n_nodes
        node = jnp.minimum(cur, n_nodes - 1)
        bmin = scene["cbvh_min"][node]
        bmax = scene["cbvh_max"][node]
        skip = scene["cbvh_skip"][node]
        poff = scene["cbvh_prim_offset"][node]
        is_leaf = poff >= 0

        t0 = (bmin - org) * inv_dir
        t1 = (bmax - org) * inv_dir
        tnear = jnp.max(jnp.minimum(t0, t1), axis=-1)
        tfar = jnp.min(jnp.maximum(t0, t1), axis=-1)
        cur_max = jnp.minimum(max_t, best_t)
        box_hit = ((tnear <= tfar * 1.00000024) & (tfar >= min_t)
                   & (tnear <= cur_max)) & active

        do_leaf = box_hit & is_leaf
        slots = jnp.maximum(poff, 0)[:, None] + jnp.arange(
            4, dtype=jnp.int32)[None]
        pid = prim_ids[jnp.clip(slots, 0, prim_ids.shape[0] - 1)]
        pid = jnp.where(slots < prim_ids.shape[0], pid, -1)
        safe = jnp.maximum(pid, 0)
        hit, t, s, v = _ribbon_intersect(
            org[:, None, :], direction[:, None, :],
            scene["curve_p0"][safe], scene["curve_p1"][safe],
            scene["curve_r0"][safe], scene["curve_r1"][safe],
            min_t[:, None], cur_max[:, None])
        hit = hit & (pid >= 0) & do_leaf[:, None]
        t = jnp.where(hit, t, INF)
        j = jnp.argmin(t, axis=1)
        rows = jnp.arange(N)
        tj = t[rows, j]
        better = tj < best_t
        pj = safe[rows, j]
        u_param = (scene["curve_u0"][pj]
                   + (scene["curve_u1"][pj] - scene["curve_u0"][pj])
                   * s[rows, j])
        best_u = jnp.where(better, u_param, best_u)
        best_v = jnp.where(better, v[rows, j], best_v)
        best_seg = jnp.where(better, pj, best_seg)
        best_t = jnp.where(better, tj, best_t)

        nxt = jnp.where(box_hit & ~is_leaf, node + 1, skip)
        if any_hit:
            nxt = jnp.where(best_seg >= 0, n_nodes, nxt)
        cur = jnp.where(active, nxt, cur)
        return cur, best_t, best_u, best_v, best_seg

    init = (
        jnp.zeros((N,), jnp.int32),
        jnp.full((N,), INF, jnp.float32),
        jnp.zeros((N,), jnp.float32),
        jnp.zeros((N,), jnp.float32),
        jnp.full((N,), -1, jnp.int32),
    )
    _, t, u, v, sub = lax.while_loop(cond, body, init)
    return _curve_hit(scene, t, u, v, sub)


def _curve_hit(scene, t, u, v, sub):
    """Map the hit sub-segment to its source Bezier segment + tangent."""
    safe_sub = jnp.maximum(sub, 0)
    seg = jnp.where(sub >= 0, scene["curve_seg"][safe_sub], -1)
    tangent = scene["curve_p1"][safe_sub] - scene["curve_p0"][safe_sub]
    tlen = jnp.sqrt(jnp.maximum(jnp.sum(tangent * tangent, axis=-1), 1e-20))
    tangent = tangent / tlen[..., None]
    return {"t": t, "u": u, "v": v, "seg": seg, "tangent": tangent}


def curve_trace_bruteforce(scene, org, direction, min_t, max_t, chunk=256):
    """Closest hit over every hair sub-segment (chunked scan): the plain
    reference for `curve_trace`. Same return dict."""
    C = scene["curve_p0"].shape[0]
    N = org.shape[0]
    pad = (-C) % chunk
    n_chunks = (C + pad) // chunk

    def padded(key):
        a = scene[key]
        a = jnp.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1))
        return a.reshape((n_chunks, chunk) + a.shape[1:])

    # padding rows have r0 = r1 = 0, which never hit (r > 0 is required)
    xs = (padded("curve_p0"), padded("curve_p1"), padded("curve_r0"),
          padded("curve_r1"), padded("curve_u0"), padded("curve_u1"),
          jnp.arange(n_chunks, dtype=jnp.int32) * chunk)

    def body(best, x):
        best_t, best_u, best_v, best_sub = best
        p0, p1, r0, r1, u0, u1, base = x
        hit, t, s, v = _ribbon_intersect(
            org[:, None, :], direction[:, None, :], p0[None], p1[None],
            r0[None], r1[None], min_t[:, None],
            jnp.minimum(max_t, best_t)[:, None])
        t = jnp.where(hit, t, INF)
        j = jnp.argmin(t, axis=1)
        rows = jnp.arange(N)
        tj = t[rows, j]
        better = tj < best_t
        u_param = u0[j] + (u1[j] - u0[j]) * s[rows, j]
        return (jnp.where(better, tj, best_t),
                jnp.where(better, u_param, best_u),
                jnp.where(better, v[rows, j], best_v),
                jnp.where(better, base + j.astype(jnp.int32), best_sub)), None

    init = (jnp.full((N,), INF, jnp.float32), jnp.zeros((N,), jnp.float32),
            jnp.zeros((N,), jnp.float32), jnp.full((N,), -1, jnp.int32))
    (t, u, v, sub), _ = lax.scan(body, init, xs)
    return _curve_hit(scene, t, u, v, sub)
