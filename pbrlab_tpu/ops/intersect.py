"""Ray-scene intersection on device: brute force and threaded-BVH wavefront.

Replaces the Embree calls in the reference
(/root/reference/src/raytracer/raytracer_impl.cc:268-287 rtcIntersect1 /
rtcOccluded1) with plain JAX that XLA compiles for any backend. Rays are SoA
lanes [N, ...]; all control flow is masked so the whole wavefront advances
in lock-step:

* `intersect_bruteforce` — O(N * F) chunked Moller-Trumbore min-reduction;
  the correctness oracle for BVH tests and fine for tiny scenes.
* `intersect_bvh` / `occluded_bvh` — single-pointer traversal of the threaded
  BVH from pbrlab_tpu.geometry.bvh: per `lax.while_loop` step each lane
  gathers one node, slab-tests it against [min_t, best_t], and either steps
  to node+1 (internal hit), tests a fixed LEAF_SIZE window of triangles
  (leaf), or jumps to skip[node] (miss). No per-lane stack -> no divergence
  beyond the shared loop trip count.
* `intersect_instanced` — the same walk over a two-level structure
  (scene.instanced): a world-space TLAS whose leaves enter an instance's
  local-space BLAS with the ray mapped through the world->local affine.

Hit results mirror the reference TraceResult (raytracer.h:9-17): t, u, v,
prim (global face id; -1 for miss) with Embree's barycentric convention
P = (1-u-v)v0 + u*v1 + v*v2.

Traversal is wrapped in stop_gradients by callers: geometry is not a
differentiable leaf (gradients target material/light/texture parameters).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from ..core.math import INF
from .curves import curve_trace

TRI_EPS = 1e-9


def _mt_intersect(org, direction, v0, e1, e2, min_t, max_t):
    """Moller-Trumbore for lanes [..., 3] vs per-lane triangles [..., 3].

    Returns (hit, t, u, v). No backface culling (the reference shades both
    faces and classifies front/back afterwards).
    """
    pvec = jnp.cross(direction, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    inv_det = jnp.where(jnp.abs(det) > TRI_EPS, 1.0 / det, 0.0)
    tvec = org - v0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(direction * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    hit = (
        (jnp.abs(det) > TRI_EPS)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t >= min_t)
        & (t <= max_t)
    )
    return hit, t, u, v


def _miss(n):
    return {"t": jnp.full((n,), INF, jnp.float32),
            "u": jnp.zeros((n,), jnp.float32),
            "v": jnp.zeros((n,), jnp.float32),
            "prim": jnp.full((n,), -1, jnp.int32)}


@partial(jax.jit, static_argnames=("chunk",))
def intersect_bruteforce(scene, org, direction, min_t, max_t, chunk=512):
    """Closest hit over all triangles; returns dict(t, u, v, prim)."""
    F = scene["tri_v0"].shape[0]
    N = org.shape[0]
    if F == 0:
        return _miss(N)
    pad = (-F) % chunk
    v0 = jnp.pad(scene["tri_v0"], ((0, pad), (0, 0)))
    e1 = jnp.pad(scene["tri_e1"], ((0, pad), (0, 0)))
    e2 = jnp.pad(scene["tri_e2"], ((0, pad), (0, 0)))
    valid = jnp.pad(jnp.ones((F,), bool), (0, pad))
    n_chunks = (F + pad) // chunk
    v0 = v0.reshape(n_chunks, chunk, 3)
    e1 = e1.reshape(n_chunks, chunk, 3)
    e2 = e2.reshape(n_chunks, chunk, 3)
    valid = valid.reshape(n_chunks, chunk)
    base = jnp.arange(n_chunks, dtype=jnp.int32) * chunk

    def body(carry, tri_chunk):
        best_t, best_u, best_v, best_p = carry
        cv0, ce1, ce2, cvalid, cbase = tri_chunk
        hit, t, u, v = _mt_intersect(
            org[:, None, :], direction[:, None, :], cv0[None], ce1[None],
            ce2[None], min_t[:, None], jnp.minimum(max_t, best_t)[:, None])
        hit = hit & cvalid[None]
        t = jnp.where(hit, t, INF)
        j = jnp.argmin(t, axis=1)
        rows = jnp.arange(t.shape[0])
        tj = t[rows, j]
        better = tj < best_t
        best_u = jnp.where(better, u[rows, j], best_u)
        best_v = jnp.where(better, v[rows, j], best_v)
        best_p = jnp.where(better, cbase + j.astype(jnp.int32), best_p)
        best_t = jnp.where(better, tj, best_t)
        return (best_t, best_u, best_v, best_p), None

    init = (
        jnp.full((N,), INF, jnp.float32),
        jnp.zeros((N,), jnp.float32),
        jnp.zeros((N,), jnp.float32),
        jnp.full((N,), -1, jnp.int32),
    )
    (best_t, best_u, best_v, best_p), _ = lax.scan(
        body, init, (v0, e1, e2, valid, base))
    return {"t": best_t, "u": best_u, "v": best_v, "prim": best_p}


def _gather_leaf_tris(prim_ids, tri_v0, tri_e1, tri_e2, prim_offset,
                      leaf_size):
    """Gather LEAF_SIZE triangle slots per lane. prim_offset [N]."""
    slots = prim_offset[:, None] + jnp.arange(leaf_size, dtype=jnp.int32)[None]
    pid = prim_ids[jnp.clip(slots, 0, prim_ids.shape[0] - 1)]
    pid = jnp.where(slots < prim_ids.shape[0], pid, -1)
    safe = jnp.maximum(pid, 0)
    return pid, tri_v0[safe], tri_e1[safe], tri_e2[safe]


def _safe_inv(direction):
    return 1.0 / jnp.where(jnp.abs(direction) < 1e-20,
                           jnp.where(direction < 0, -1e-20, 1e-20), direction)


def _slab_test(bmin, bmax, org, inv_dir, min_t, max_t):
    t0 = (bmin - org) * inv_dir
    t1 = (bmax - org) * inv_dir
    tnear = jnp.max(jnp.minimum(t0, t1), axis=-1)
    tfar = jnp.min(jnp.maximum(t0, t1), axis=-1)
    return (tnear <= tfar * 1.00000024) & (tfar >= min_t) & (tnear <= max_t)


def _leaf_closest(org, direction, v0, e1, e2, pid, do_leaf, min_t, cur_max,
                  best):
    """Fold one leaf window's Moller-Trumbore hits into best (t, u, v, p)."""
    best_t, best_u, best_v, best_p = best
    hit, t, u, v = _mt_intersect(
        org[:, None, :], direction[:, None, :], v0, e1, e2,
        min_t[:, None], cur_max[:, None])
    hit = hit & (pid >= 0) & do_leaf[:, None]
    t = jnp.where(hit, t, INF)
    j = jnp.argmin(t, axis=1)
    rows = jnp.arange(t.shape[0])
    tj = t[rows, j]
    better = tj < best_t
    return (jnp.where(better, tj, best_t),
            jnp.where(better, u[rows, j], best_u),
            jnp.where(better, v[rows, j], best_v),
            jnp.where(better, pid[rows, j], best_p))


def _init_best(n):
    return (jnp.full((n,), INF, jnp.float32), jnp.zeros((n,), jnp.float32),
            jnp.zeros((n,), jnp.float32), jnp.full((n,), -1, jnp.int32))


@partial(jax.jit, static_argnames=("any_hit", "leaf_size"))
def _bvh_trace(bvh_min, bvh_max, bvh_skip, bvh_prim_offset, bvh_prim_ids,
               scene_tris, org, direction, min_t, max_t, any_hit=False,
               leaf_size=4):
    n_nodes = bvh_skip.shape[0]
    N = org.shape[0]
    inv_dir = _safe_inv(direction)

    def cond(state):
        cur = state[0]
        return jnp.any(cur < n_nodes)

    def body(state):
        cur, best = state[0], state[1:]
        active = cur < n_nodes
        node = jnp.minimum(cur, n_nodes - 1)
        poff = bvh_prim_offset[node]
        is_leaf = poff >= 0
        cur_max = jnp.minimum(max_t, best[0])
        box_hit = _slab_test(bvh_min[node], bvh_max[node], org, inv_dir,
                             min_t, cur_max) & active

        # Leaf: test the fixed window of triangles.
        pid, v0, e1, e2 = _gather_leaf_tris(
            bvh_prim_ids, scene_tris["tri_v0"], scene_tris["tri_e1"],
            scene_tris["tri_e2"], jnp.maximum(poff, 0), leaf_size)
        best = _leaf_closest(org, direction, v0, e1, e2, pid,
                             box_hit & is_leaf, min_t, cur_max, best)

        # Advance: internal hit -> depth-first next; otherwise skip link.
        nxt = jnp.where(box_hit & ~is_leaf, node + 1, bvh_skip[node])
        if any_hit:
            nxt = jnp.where(best[3] >= 0, n_nodes, nxt)
        return (jnp.where(active, nxt, cur),) + best

    init = (jnp.zeros((N,), jnp.int32),) + _init_best(N)
    _, best_t, best_u, best_v, best_p = lax.while_loop(cond, body, init)
    return {"t": best_t, "u": best_u, "v": best_v, "prim": best_p}


def intersect_bvh(scene, org, direction, min_t, max_t, any_hit=False):
    """Closest hit via the scene's threaded BVH (commit() must have run).
    any_hit=True stops each lane at its first hit (shadow queries)."""
    if scene["tri_v0"].shape[0] == 0:  # hair-only scene: nothing to walk
        return _miss(org.shape[0])
    tris = {k: scene[k] for k in ("tri_v0", "tri_e1", "tri_e2")}
    return _bvh_trace(scene["bvh_min"], scene["bvh_max"], scene["bvh_skip"],
                      scene["bvh_prim_offset"], scene["bvh_prim_ids"], tris,
                      org, direction, min_t, max_t, any_hit=any_hit)


def occluded_bvh(scene, org, direction, min_t, max_t):
    """Any-hit shadow query -> bool per lane (reference AnyHit1)."""
    return intersect_bvh(scene, org, direction, min_t, max_t,
                         any_hit=True)["prim"] >= 0


def _to_local(m, p, w):
    """The 3x4 affines m [N, 12] applied to p [N, 3] (w = 1 for points, 0
    for directions). Elementwise products and sums: no contraction, so no
    reduced-precision matrix unit enters."""
    m = m.reshape(-1, 3, 4)
    return jnp.sum(m[:, :, :3] * p[:, None, :], axis=-1) + w * m[:, :, 3]


@partial(jax.jit, static_argnames=("any_hit", "leaf_size"))
def _instanced_trace(tlas, blas, inst_inv, inst_meta, org, direction, min_t,
                     max_t, any_hit=False, leaf_size=4):
    """Two-level threaded walk (scene.instanced tables). Each lane is in
    the TLAS (tcur < nt) or inside an instance's BLAS (bcur < bend).
    Entering a TLAS leaf maps the ray into the instance's local space (t
    is preserved: the direction is not renormalised), records the
    instance's BLAS range and face-id delta, and leaves tcur at the leaf's
    skip link, where the walk resumes once the BLAS is exhausted."""
    nt = tlas["skip"].shape[0]
    nb = blas["skip"].shape[0]
    N = org.shape[0]
    inv_dir = _safe_inv(direction)

    def cond(state):
        tcur, bcur, bend = state[:3]
        return jnp.any((tcur < nt) | (bcur < bend))

    def body(state):
        tcur, bcur, bend, delta, lorg, ldir, linv = state[:7]
        best = state[7:]
        in_blas = bcur < bend
        active = in_blas | (tcur < nt)
        tn = jnp.minimum(tcur, nt - 1)
        bn = jnp.clip(bcur, 0, nb - 1)
        sel = in_blas[:, None]
        bmin = jnp.where(sel, blas["min"][bn], tlas["min"][tn])
        bmax = jnp.where(sel, blas["max"][bn], tlas["max"][tn])
        poff = jnp.where(in_blas, blas["prim_offset"][bn],
                         tlas["prim_offset"][tn])
        is_leaf = poff >= 0
        cur_max = jnp.minimum(max_t, best[0])
        box_hit = _slab_test(bmin, bmax, jnp.where(sel, lorg, org),
                             jnp.where(sel, linv, inv_dir), min_t,
                             cur_max) & active

        # BLAS leaf: local-space triangle window; prim -> iface row
        pid, v0, e1, e2 = _gather_leaf_tris(
            blas["prim_ids"], blas["v0"], blas["e1"], blas["e2"],
            jnp.maximum(poff, 0), leaf_size)
        pid = jnp.where(pid >= 0, pid + delta[:, None], -1)
        best = _leaf_closest(lorg, ldir, v0, e1, e2, pid,
                             box_hit & is_leaf & in_blas, min_t, cur_max,
                             best)

        # TLAS leaf: enter the instance
        enter = box_hit & is_leaf & ~in_blas
        k = tlas["prim_ids"][jnp.clip(poff, 0, tlas["prim_ids"].shape[0] - 1)]
        m = inst_inv[k]
        meta = inst_meta[k]
        ldir_k = _to_local(m, direction, 0.0)
        e = enter[:, None]
        lorg = jnp.where(e, _to_local(m, org, 1.0), lorg)
        ldir = jnp.where(e, ldir_k, ldir)
        linv = jnp.where(e, _safe_inv(ldir_k), linv)
        delta = jnp.where(enter, meta[:, 2], delta)
        bend = jnp.where(enter, meta[:, 1], bend)

        # Advance the level the lane is on: internal hit -> node + 1,
        # otherwise the skip link.
        descend = box_hit & ~is_leaf
        bcur = jnp.where(enter, meta[:, 0], jnp.where(
            in_blas, jnp.where(descend, bn + 1, blas["skip"][bn]), bcur))
        tcur = jnp.where(active & ~in_blas, jnp.where(
            descend, tn + 1, tlas["skip"][tn]), tcur)
        if any_hit:
            found = best[3] >= 0
            tcur = jnp.where(found, nt, tcur)
            bcur = jnp.where(found, bend, bcur)
        return (tcur, bcur, bend, delta, lorg, ldir, linv) + best

    zi = jnp.zeros((N,), jnp.int32)
    init = (zi, zi, zi, zi, org, direction, inv_dir) + _init_best(N)
    out = lax.while_loop(cond, body, init)
    best_t, best_u, best_v, best_p = out[7:]
    return {"t": best_t, "u": best_u, "v": best_v, "prim": best_p}


def intersect_instanced(scene, org, direction, min_t, max_t, any_hit=False):
    """Closest (or any) hit over an instanced scene (build_instanced);
    prim is the per-(instance, face) row of the iface_* tables."""
    levels = [{k: scene[p + k] for k in ("min", "max", "skip", "prim_offset",
                                         "prim_ids")}
              for p in ("tlas_", "blas_")]
    levels[1].update({k: scene["blas_" + k] for k in ("v0", "e1", "e2")})
    return _instanced_trace(levels[0], levels[1], scene["inst_inv"],
                            scene["inst_meta"], org, direction, min_t, max_t,
                            any_hit=any_hit)


def has_curves(scene) -> bool:
    """Static (trace-time) check whether the scene contains hair."""
    return int(scene["curve_pts"].shape[0]) > 0


def _closest_tri(scene, org, direction, min_t, max_t, any_hit=False):
    if "tlas_skip" in scene:
        return intersect_instanced(scene, org, direction, min_t, max_t,
                                   any_hit=any_hit)
    return intersect_bvh(scene, org, direction, min_t, max_t,
                         any_hit=any_hit)


def trace_scene(scene, org, direction, min_t, max_t):
    """Closest hit over triangles AND hair curves (rtcIntersect1 equivalent
    over the two-geometry global scene, raytracer_impl.cc:268-278).

    Returns dict(t, u, v, prim, seg, is_curve, tangent): prim is the
    triangle id (-1 otherwise), seg the curve segment id (-1 otherwise).
    """
    tri = _closest_tri(scene, org, direction, min_t, max_t)
    n = org.shape[0]
    if not has_curves(scene):
        return {**tri, "seg": jnp.full((n,), -1, jnp.int32),
                "is_curve": jnp.zeros((n,), bool),
                "tangent": jnp.zeros((n, 3), jnp.float32)}
    cur = curve_trace(scene, org, direction, min_t, max_t)
    curve_closer = (cur["seg"] >= 0) & (cur["t"] < tri["t"])
    return {
        "t": jnp.where(curve_closer, cur["t"], tri["t"]),
        "u": jnp.where(curve_closer, cur["u"], tri["u"]),
        "v": jnp.where(curve_closer, cur["v"], tri["v"]),
        "prim": jnp.where(curve_closer, -1, tri["prim"]),
        "seg": jnp.where(curve_closer, cur["seg"], -1),
        "is_curve": curve_closer,
        "tangent": cur["tangent"],
    }


def occluded_scene(scene, org, direction, min_t, max_t):
    """Shadow any-hit over triangles AND curves (rtcOccluded1 equivalent)."""
    occ = _closest_tri(scene, org, direction, min_t, max_t,
                       any_hit=True)["prim"] >= 0
    if has_curves(scene):
        occ = occ | (curve_trace(scene, org, direction, min_t, max_t,
                                 any_hit=True)["seg"] >= 0)
    return occ


def trace_scene_dual(scene, org, direction, min_t, max_t,
                     sdir, smin_t, smax_t):
    """Closest hit + shadow any-hit where both queries share the origin
    (the deferred-NEE step: one rtcIntersect1 + one rtcOccluded1 per
    bounce, raytracer_impl.cc:268-287). Returns (trace_scene dict,
    occluded bool)."""
    return (trace_scene(scene, org, direction, min_t, max_t),
            occluded_scene(scene, org, sdir, smin_t, smax_t))
