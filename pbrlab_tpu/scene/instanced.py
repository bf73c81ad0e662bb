"""Trace-time instancing: shared local scenes + per-instance transforms.

The reference builds one Embree BLAS per local scene and instantiates it
into the global scene with a 4x4 transform
(/root/reference/src/raytracer/raytracer_impl.cc:49-84, Scene::
CreateLocalScene / CreateInstanceFromLocalScene, scene.cc:106-160);
per-instance id tables resolve materials and light params at hit time
(mesh-instance.h:23-36). The device layout here:

* ONE local-space triangle table + threaded BLAS per local scene (shared
  group), shared by every instance — K instances never copy geometry;
* a threaded TLAS over instance world AABBs; each instance carries its
  world->local affine, BLAS node range and face-id offset
  (ops.intersect.intersect_instanced walks both levels);
* per-(instance, face) NARROW columns (material id, light pdf, emission,
  instance, local slot — the reference's id tables, ~32 B/face) while the
  fat geometric attributes (normals, uvs, ~80 B/face) stay per-LOCAL-face
  and are rotated into world space per lane at shade time with the
  instance's normal matrix (scene.inst_shade);
* light sampling uses world-space copies of EMISSIVE faces only;
* curve (hair) meshes in a group are baked to world space per instance
  (reference traces them in local space, raytracer_impl.cc:154-197; an
  affine image of Bezier control points IS the transformed curve, so the
  render is identical) — the shared structure is the triangle BLAS, which
  dominates a local scene's memory; curve instance ids join the TLAS id
  space so the SSS same-instance test spans both geometries.

Memory: K instances of an F-face local scene cost K*F*32 B + F*(fat+BVH)
instead of the baked path's K*F*(fat + geometry + BVH) — the
100-instance test asserts >5x total reduction.

Trace tables: tlas_* (threaded BVH, one instance per leaf) and blas_*
(every group's threaded BVH, concatenated; prim ids are local slots).
inst_meta [K, 3] int32 = (BLAS root node, BLAS end node, face-id delta):
a hit on local slot s of instance k is iface row s + delta_k.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ..geometry.mesh import TriangleMesh


@dataclasses.dataclass
class SharedGroup:
    meshes: List[TriangleMesh]
    transforms: np.ndarray  # [K, 4, 4]
    light_ids: List[Optional[np.ndarray]]  # per mesh, shared by instances
    curves: List = dataclasses.field(default_factory=list)


def _affine(m):
    m = np.asarray(m, np.float64)
    if m.shape == (4, 4):
        return m
    out = np.eye(4)
    out[:3, :4] = m
    return out


def build_instanced(builder) -> Dict[str, np.ndarray]:
    """Builder (with _shared groups and/or plain _instances) -> committed
    instanced scene dict. Plain instances become K=1 groups."""
    from ..geometry.bvh import build_bvh, node_arrays, triangle_bounds

    groups: List[SharedGroup] = list(getattr(builder, "_shared", []))
    for inst in builder._instances:
        t = np.eye(4) if inst.transform is None else _affine(inst.transform)
        groups.append(SharedGroup(inst.meshes, t[None], inst.light_ids,
                                  inst.curves))
    assert groups, "no geometry"
    tri_gis = [gi for gi, g in enumerate(groups)
               if sum(m.num_faces for m in g.meshes) > 0]
    assert tri_gis, ("curves-only scene: use the baked path (commit(b."
                     "build())) — there is no triangle BLAS to share")

    scene: Dict[str, np.ndarray] = {}

    # ---- per-group local BLAS + local attributes -----------------------
    # slots = the faces of every group, concatenated; group gi owns
    # [group_slot_base[gi], + group_num_slots[gi])
    blas = []  # (gi, threaded BVH over the group's faces, local ids)
    local_fat_rows = []
    tri_rows = []
    group_slot_base = {}
    group_num_slots = {}
    group_local_mat = {}  # per slot
    group_local_light = {}  # per slot: light param id or -1
    group_root_box = {}
    s_running = 0
    for gi in tri_gis:
        g = groups[gi]
        v_list, ns_list, has_ns_list, uv_list, has_uv_list = [], [], [], [], []
        mat_list, light_list = [], []
        for mi, mesh in enumerate(g.meshes):
            f = mesh.faces
            nf = f.shape[0]
            v_list.append(mesh.vertices[f])
            if mesh.normals is not None and mesh.normal_idx is not None:
                ns_list.append(mesh.normals[np.maximum(mesh.normal_idx, 0)])
                has_ns_list.append(np.all(mesh.normal_idx >= 0, axis=-1))
            else:
                ns_list.append(np.zeros((nf, 3, 3), np.float32))
                has_ns_list.append(np.zeros((nf,), bool))
            if mesh.texcoords is not None and mesh.texcoord_idx is not None:
                uv_list.append(
                    mesh.texcoords[np.maximum(mesh.texcoord_idx, 0)])
                has_uv_list.append(np.all(mesh.texcoord_idx >= 0, axis=-1))
            else:
                uv_list.append(np.zeros((nf, 3, 2), np.float32))
                has_uv_list.append(np.zeros((nf,), bool))
            mat_list.append(np.asarray(mesh.material_ids, np.int32))
            lid = (g.light_ids[mi] if g.light_ids is not None
                   and mi < len(g.light_ids) else None)
            light_list.append(np.full((nf,), -1, np.int32) if lid is None
                              else np.asarray(lid, np.int32))
        V = np.concatenate(v_list).astype(np.float32)  # [F, 3, 3] local
        v0 = V[:, 0]
        e1 = V[:, 1] - V[:, 0]
        e2 = V[:, 2] - V[:, 0]
        s = v0.shape[0]
        bvh = build_bvh(*triangle_bounds(v0, e1, e2))
        blas.append((gi, bvh))

        ng = np.cross(e1, e2)
        ng = ng / np.maximum(np.linalg.norm(ng, axis=-1, keepdims=True),
                             1e-30)
        local_fat_rows.append(np.concatenate([
            ng, np.concatenate(ns_list).reshape(-1, 9),
            np.concatenate(uv_list).reshape(-1, 6),
            np.concatenate(has_ns_list).astype(np.float32)[:, None],
            np.concatenate(has_uv_list).astype(np.float32)[:, None],
        ], axis=1).astype(np.float32))
        tri_rows.append(np.stack([v0, e1, e2], axis=1))  # [S, 3, 3]
        group_slot_base[gi] = s_running
        group_num_slots[gi] = s
        group_local_mat[gi] = np.concatenate(mat_list)
        group_local_light[gi] = np.concatenate(light_list)
        group_root_box[gi] = (bvh.aabb_min[0], bvh.aabb_max[0])
        s_running += s
    local_tris = np.concatenate(tri_rows).astype(np.float32)

    # ---- instances ------------------------------------------------------
    inst_inv_rows = []
    inst_shade_rows = []
    inst_group = []
    inst_fid_delta = []
    inst_bmin, inst_bmax = [], []
    iface_mat, iface_light, iface_inst, iface_slot = [], [], [], []
    curve_jobs = []  # (curves, 4x4, instance id) — baked after the TLAS
    f_running = 0
    for gi in tri_gis:
        g = groups[gi]
        s_base = group_slot_base[gi]
        s = group_num_slots[gi]
        for m4 in np.asarray(g.transforms, np.float64).reshape(-1, 4, 4):
            k = len(inst_group)
            a = m4[:3, :4]
            a_inv = np.linalg.inv(m4)[:3, :4]
            nrm = np.linalg.inv(m4[:3, :3]).T
            inst_inv_rows.append(a_inv.reshape(12))
            inst_shade_rows.append(
                np.concatenate([a.reshape(12), nrm.reshape(9),
                                np.zeros(3)]))
            inst_group.append(gi)
            inst_fid_delta.append(f_running - s_base)
            lo, hi = group_root_box[gi]
            corners = np.stack(np.meshgrid(*zip(lo, hi),
                                           indexing="ij")).reshape(3, 8).T
            wc = corners @ a[:, :3].T + a[:, 3]
            inst_bmin.append(wc.min(axis=0))
            inst_bmax.append(wc.max(axis=0))
            iface_mat.append(group_local_mat[gi])
            iface_light.append(group_local_light[gi])
            iface_inst.append(np.full((s,), k, np.int32))
            iface_slot.append(
                np.arange(s_base, s_base + s, dtype=np.int32))
            if g.curves:
                curve_jobs.append((g.curves, m4, k))
            f_running += s

    ki = len(inst_group)
    # curve-only groups: instance ids continue past the TLAS ids (they feed
    # only the SSS same-instance check; they never index an id table)
    k_next = ki
    for gi, g in enumerate(groups):
        if gi in group_slot_base or not g.curves:
            continue
        for m4 in np.asarray(g.transforms, np.float64).reshape(-1, 4, 4):
            curve_jobs.append((g.curves, m4, k_next))
            k_next += 1
    inst_shade = np.stack(inst_shade_rows).astype(np.float32)  # [K, 24]
    iface_mat = np.concatenate(iface_mat)
    iface_light = np.concatenate(iface_light)
    iface_inst = np.concatenate(iface_inst)
    iface_slot = np.concatenate(iface_slot)

    # ---- TLAS over instance world boxes + the groups' BLASes -----------
    tlas = build_bvh(np.stack(inst_bmin).astype(np.float32),
                     np.stack(inst_bmax).astype(np.float32), leaf_size=1,
                     use_native=False)
    for key, val in (("min", tlas.aabb_min), ("max", tlas.aabb_max),
                     ("skip", tlas.skip), ("prim_offset", tlas.prim_offset),
                     ("prim_ids", tlas.prim_ids)):
        scene["tlas_" + key] = val
    cols = {k: [] for k in ("min", "max", "skip", "prim_offset",
                            "prim_ids")}
    blas_range = {}
    node_off = slot_off = 0
    for gi, bvh in blas:
        blas_range[gi] = (node_off, node_off + bvh.num_nodes)
        cols["min"].append(bvh.aabb_min)
        cols["max"].append(bvh.aabb_max)
        cols["skip"].append(bvh.skip + node_off)
        cols["prim_offset"].append(np.where(bvh.prim_offset >= 0,
                                            bvh.prim_offset + slot_off, -1))
        cols["prim_ids"].append(np.where(
            bvh.prim_ids >= 0, bvh.prim_ids + group_slot_base[gi], -1))
        node_off += bvh.num_nodes
        slot_off += bvh.prim_ids.shape[0]
    for key, parts in cols.items():
        scene["blas_" + key] = np.concatenate(parts)
    scene["blas_prim_ids"] = scene["blas_prim_ids"].astype(np.int32)
    scene["blas_prim_offset"] = scene["blas_prim_offset"].astype(np.int32)
    scene["blas_v0"] = local_tris[:, 0]
    scene["blas_e1"] = local_tris[:, 1]
    scene["blas_e2"] = local_tris[:, 2]
    scene["inst_inv"] = np.stack(inst_inv_rows).astype(np.float32)  # [K,12]
    scene["inst_meta"] = np.stack([
        np.asarray([blas_range[g][0] for g in inst_group], np.int32),
        np.asarray([blas_range[g][1] for g in inst_group], np.int32),
        np.asarray(inst_fid_delta, np.int32)], axis=1)
    scene["inst_shade"] = inst_shade
    scene["local_fat"] = np.concatenate(local_fat_rows).astype(np.float32)
    scene["iface_material"] = iface_mat
    scene["iface_instance"] = iface_inst
    scene["iface_local_slot"] = iface_slot

    # ---- lights: world-space emissive faces only ------------------------
    light_emission = (np.stack(builder._light_params)
                      if builder._light_params
                      else np.zeros((0, 3), np.float32))
    n_faces = iface_mat.shape[0]
    emissive = np.nonzero(iface_light >= 0)[0].astype(np.int32)
    iface_emission = np.zeros((n_faces, 3), np.float32)
    iface_pdf = np.zeros((n_faces,), np.float32)
    if emissive.size:
        em = light_emission[iface_light[emissive]]
        iface_emission[emissive] = em
        lslots = iface_slot[emissive]
        ltris = local_tris[lslots]  # [LF, 3, 3]
        a_rows = inst_shade[iface_inst[emissive], :12].reshape(-1, 3, 4)
        v0w = np.einsum("lij,lj->li", a_rows[:, :, :3],
                        ltris[:, 0]) + a_rows[:, :, 3]
        e1w = np.einsum("lij,lj->li", a_rows[:, :, :3], ltris[:, 1])
        e2w = np.einsum("lij,lj->li", a_rows[:, :, :3], ltris[:, 2])
        ngw = np.cross(e1w, e2w)
        area2 = np.linalg.norm(ngw, axis=-1)
        ngw = ngw / np.maximum(area2, 1e-30)[:, None]
        area = 0.5 * area2
        power = em.max(axis=-1) * area
        total = max(power.sum(), 1e-30)
        p_choose = power / total
        iface_pdf[emissive] = p_choose / np.maximum(area, 1e-30)
        scene["light_cdf"] = np.cumsum(p_choose).astype(np.float32)
        scene["light_v0"] = v0w.astype(np.float32)
        scene["light_e1"] = e1w.astype(np.float32)
        scene["light_e2"] = e2w.astype(np.float32)
        scene["light_ng"] = ngw.astype(np.float32)
    else:
        scene["light_cdf"] = np.zeros((0,), np.float32)
        for k in ("light_v0", "light_e1", "light_e2", "light_ng"):
            scene[k] = np.zeros((0, 3), np.float32)
    scene["iface_emission"] = iface_emission
    scene["iface_light_pdf"] = iface_pdf
    scene["emissive_faces"] = emissive
    scene["light_emission"] = light_emission

    # ---- shared with the baked path -------------------------------------
    scene["materials"] = builder.materials.build()
    if builder._textures:
        hmax = max(t.shape[0] for t in builder._textures)
        wmax = max(t.shape[1] for t in builder._textures)
        atlas = np.zeros((len(builder._textures), hmax, wmax, 3), np.float32)
        sizes = np.zeros((len(builder._textures), 2), np.int32)
        for i, t in enumerate(builder._textures):
            atlas[i, : t.shape[0], : t.shape[1]] = t
            sizes[i] = (t.shape[0], t.shape[1])
        scene["texture_atlas"] = atlas
        scene["texture_sizes"] = sizes
    else:
        scene["texture_atlas"] = np.zeros((1, 1, 1, 3), np.float32)
        scene["texture_sizes"] = np.ones((1, 2), np.int32)
    # ---- curves: baked to world space per instance -----------------------
    # The reference traces curve geometry inside local scenes under the
    # instance transform like any other geometry (raytracer_impl.cc:154-197
    # + :49-84); here the SHARED structure is the triangle BLAS — curve
    # control points (4 floats/point, a small fraction of a local scene's
    # fat+BVH bytes) are baked per instance, keeping one curve BVH and
    # exact world-space radiometry.
    from .scene import commit_curves, transform_curve_points

    curve_pts, curve_mat, curve_inst, curve_col = [], [], [], []
    any_colors = False
    for curves, m4, k in curve_jobs:
        for cm in curves:
            from ..geometry.mesh import CubicBezierCurveMesh

            vt = transform_curve_points(cm.vertices_thickness, m4)
            baked = CubicBezierCurveMesh(vt, cm.indices,
                                         material_id=cm.material_id,
                                         name=cm.name,
                                         segment_colors=cm.segment_colors)
            curve_pts.append(baked.segment_points())
            curve_mat.append(np.full((baked.num_segments,), cm.material_id,
                                     np.int32))
            curve_inst.append(np.full((baked.num_segments,), k, np.int32))
            if cm.segment_colors is not None:
                any_colors = True
                curve_col.append(cm.segment_colors)
            else:
                curve_col.append(np.full((baked.num_segments, 3), -1.0,
                                         np.float32))
    scene["curve_pts"] = (np.concatenate(curve_pts).astype(np.float32)
                          if curve_pts else np.zeros((0, 4, 4), np.float32))
    scene["curve_material"] = (np.concatenate(curve_mat) if curve_mat
                               else np.zeros((0,), np.int32))
    scene["curve_instance"] = (np.concatenate(curve_inst) if curve_inst
                               else np.zeros((0,), np.int32))
    if any_colors:  # see scene.py: per-strand hair base-color override
        scene["curve_color"] = np.concatenate(curve_col).astype(np.float32)
    scene["aabb_min"] = tlas.aabb_min[0].copy()
    scene["aabb_max"] = tlas.aabb_max[0].copy()
    if scene["curve_pts"].size:
        cp = scene["curve_pts"].reshape(-1, 4)
        scene["aabb_min"] = np.minimum(
            scene["aabb_min"], (cp[:, :3] - cp[:, 3:4]).min(axis=0))
        scene["aabb_max"] = np.maximum(
            scene["aabb_max"], (cp[:, :3] + cp[:, 3:4]).max(axis=0))

    from .scene import _signature_cut

    # compaction signature over the world-space level only
    scene["sig_aabb"] = _signature_cut(*node_arrays(tlas), max_nodes=29)
    return commit_curves(scene)
