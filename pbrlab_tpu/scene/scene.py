"""Scene assembly: host-side builder -> flat device-array scene.

Reference layer L3 (/root/reference/src/scene.{h,cc}, light-manager.{h,cc},
mesh-instance.h). The reference keeps pointer-rich structures (local scenes,
instances, variants) and resolves attributes through id tables at hit time.
The device layout flattens everything at commit:

* every instanced triangle is baked to world space into global SoA arrays
  (the reference only ever uses identity instance transforms —
  pc/pc-common.cc:163-167 — so baking is behavior-preserving, but we apply
  the 4x4 here so transforms work);
* per-face columns carry material id, light pdf/emission, instance id — the
  direct analogue of the reference's id tables (mesh-instance.h:23-36);
* the two-level light CDF (light-manager.cc:29-77,79-184) is flattened into
  a single CDF over emissive faces: p(face) = p(light) * p(prim | light)
  chained draws ≡ one draw over the product distribution, and the per-face
  area pdf column reproduces ImplicitAreaLight (light-manager.h:37-74).

`DeviceScene` is a plain dict pytree of jnp arrays: jit-friendly, shardable,
and the material/light/texture columns are differentiable leaves.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..geometry.mesh import CubicBezierCurveMesh, TriangleMesh
from .materials import MaterialBuilder


def _apply_transform(verts: np.ndarray, m: Optional[np.ndarray]) -> np.ndarray:
    if m is None:
        return verts
    m = np.asarray(m, np.float32)
    return verts @ m[:3, :3].T + m[:3, 3]


def _apply_normal_transform(normals: np.ndarray, m: Optional[np.ndarray]):
    if m is None:
        return normals
    m = np.asarray(m, np.float32)
    nm = np.linalg.inv(m[:3, :3]).T
    n = normals @ nm.T
    return n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-30)


@dataclasses.dataclass
class _Instance:
    meshes: List[TriangleMesh]
    curves: List[CubicBezierCurveMesh]
    light_ids: List[Optional[np.ndarray]]  # per mesh: per-face light param id or None
    transform: Optional[np.ndarray]


class SceneBuilder:
    """Accumulates meshes/materials/lights, then `build()`s device arrays.

    Mirrors the reference Scene API surface (scene.h:14-111): Add*/Create*/
    Commit. Local scenes exist implicitly: `add_instance` takes a list of
    meshes (the local scene) plus an optional transform.
    """

    def __init__(self):
        self.materials = MaterialBuilder()
        self._instances: List[_Instance] = []
        self._shared: List = []  # SharedGroup (scene.instanced)
        self._light_params: List[np.ndarray] = []  # emission rgb per light param
        self._textures: List[np.ndarray] = []
        self._texture_names: List[str] = []

    # -- light params (reference LightManager::AddLightParam) ------------
    def add_area_light_param(self, emission) -> int:
        self._light_params.append(np.asarray(emission, np.float32))
        return len(self._light_params) - 1

    def add_texture(self, image: np.ndarray, name: str = "") -> int:
        """Register a float texture [H, W, 1|3|4] (linear space).

        Alpha channels are preserved (reference Texture::FetchFloatN is
        channel-count generic, texture.h:28-34): when any registered
        texture has 4 channels the atlas is RGBA, else RGB; color fetches
        slice the first 3 either way and textures.fetch_float_n exposes
        the full channel count."""
        img = np.ascontiguousarray(np.asarray(image, np.float32))
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        self._textures.append(img)
        self._texture_names.append(name)
        return len(self._textures) - 1

    # -- geometry ---------------------------------------------------------
    def add_instance(
        self,
        meshes: List[TriangleMesh],
        curves: Optional[List[CubicBezierCurveMesh]] = None,
        light_ids: Optional[List[Optional[np.ndarray]]] = None,
        transform: Optional[np.ndarray] = None,
    ) -> int:
        curves = curves or []
        if light_ids is None:
            light_ids = [None] * len(meshes)
        self._instances.append(_Instance(meshes, curves, light_ids, transform))
        return len(self._instances) - 1

    def add_shared_instances(self, meshes: List[TriangleMesh], transforms,
                             light_ids=None, curves=None) -> int:
        """K instances sharing ONE local scene (trace-time instancing:
        reference CreateLocalScene + K x CreateInstanceFromLocalScene,
        raytracer_impl.cc:49-84). transforms: [K, 4, 4] (or [K, 3, 4]).
        Curve meshes in the local scene are baked to world space per
        instance at build time (triangles keep the shared BLAS). Scenes
        with shared instances must be built with `build_instanced(builder)`
        (scene.instanced)."""
        from .instanced import SharedGroup

        t = np.asarray(transforms, np.float32)
        if t.shape[1:] == (3, 4):
            pad = np.broadcast_to(
                np.asarray([0, 0, 0, 1], np.float32), (t.shape[0], 1, 4))
            t = np.concatenate([t, pad], axis=1)
        self._shared.append(SharedGroup(
            meshes, t, light_ids or [None] * len(meshes), curves or []))
        return len(self._shared) - 1

    # -- commit -----------------------------------------------------------
    def build(self) -> Dict[str, np.ndarray]:
        tri_v = []  # [F,3,3] world-space corners
        tri_ns = []  # [F,3,3] per-corner shading normals
        tri_has_ns = []  # [F]
        tri_uv = []  # [F,3,2]
        tri_has_uv = []  # [F]
        tri_mat = []
        tri_light = []  # light param id or -1
        tri_inst = []
        tri_geom = []
        tri_prim = []

        for inst_id, inst in enumerate(self._instances):
            for geom_id, mesh in enumerate(inst.meshes):
                f = mesh.faces
                nf = f.shape[0]
                v = _apply_transform(mesh.vertices, inst.transform)[f]
                tri_v.append(v)
                if mesh.normals is not None and mesh.normal_idx is not None:
                    ns = _apply_normal_transform(mesh.normals, inst.transform)
                    corner_ns = ns[np.maximum(mesh.normal_idx, 0)]
                    has = np.all(mesh.normal_idx >= 0, axis=-1)
                else:
                    corner_ns = np.zeros((nf, 3, 3), np.float32)
                    has = np.zeros((nf,), bool)
                tri_ns.append(corner_ns)
                tri_has_ns.append(has)
                if mesh.texcoords is not None and mesh.texcoord_idx is not None:
                    corner_uv = mesh.texcoords[np.maximum(mesh.texcoord_idx, 0)]
                    has_uv = np.all(mesh.texcoord_idx >= 0, axis=-1)
                else:
                    corner_uv = np.zeros((nf, 3, 2), np.float32)
                    has_uv = np.zeros((nf,), bool)
                tri_uv.append(corner_uv)
                tri_has_uv.append(has_uv)
                tri_mat.append(mesh.material_ids)
                lids = inst.light_ids[geom_id]
                if lids is None:
                    tri_light.append(np.full((nf,), -1, np.int32))
                else:
                    tri_light.append(np.asarray(lids, np.int32))
                tri_inst.append(np.full((nf,), inst_id, np.int32))
                tri_geom.append(np.full((nf,), geom_id, np.int32))
                tri_prim.append(np.arange(nf, dtype=np.int32))

        if tri_v:
            V = np.concatenate(tri_v).astype(np.float32)  # [F,3,3]
        else:
            V = np.zeros((0, 3, 3), np.float32)
        scene: Dict[str, np.ndarray] = {}
        scene["tri_v0"] = V[:, 0]
        scene["tri_e1"] = V[:, 1] - V[:, 0]
        scene["tri_e2"] = V[:, 2] - V[:, 0]
        ng = np.cross(scene["tri_e1"], scene["tri_e2"])
        area2 = np.linalg.norm(ng, axis=-1)
        scene["face_ng"] = (
            ng / np.maximum(area2, 1e-30)[:, None]).astype(np.float32)
        scene["face_area"] = (0.5 * area2).astype(np.float32)
        scene["face_ns"] = (
            np.concatenate(tri_ns).astype(np.float32)
            if tri_ns else np.zeros((0, 3, 3), np.float32))
        scene["face_has_ns"] = (
            np.concatenate(tri_has_ns) if tri_has_ns else np.zeros((0,), bool))
        scene["face_uv"] = (
            np.concatenate(tri_uv).astype(np.float32)
            if tri_uv else np.zeros((0, 3, 2), np.float32))
        scene["face_has_uv"] = (
            np.concatenate(tri_has_uv) if tri_has_uv else np.zeros((0,), bool))
        scene["face_material"] = (
            np.concatenate(tri_mat).astype(np.int32)
            if tri_mat else np.zeros((0,), np.int32))
        face_light = (
            np.concatenate(tri_light).astype(np.int32)
            if tri_light else np.zeros((0,), np.int32))
        scene["face_light"] = face_light
        scene["face_instance"] = (
            np.concatenate(tri_inst).astype(np.int32)
            if tri_inst else np.zeros((0,), np.int32))
        scene["face_geom"] = (
            np.concatenate(tri_geom).astype(np.int32)
            if tri_geom else np.zeros((0,), np.int32))

        # ---- lights (flattened two-level CDF; see module docstring) ----
        light_emission = (
            np.stack(self._light_params)
            if self._light_params else np.zeros((0, 3), np.float32))
        is_light = face_light >= 0
        emissive = np.nonzero(is_light)[0].astype(np.int32)
        F = face_light.shape[0]
        face_emission = np.zeros((F, 3), np.float32)
        face_light_pdf = np.zeros((F,), np.float32)
        if emissive.size:
            em = light_emission[face_light[emissive]]
            face_emission[emissive] = em
            # power = SpectrumNorm(emission) * area (light-manager.cc:118-140)
            power = em.max(axis=-1) * scene["face_area"][emissive]
            total = power.sum()
            p_choose = power / max(total, 1e-30)
            # pdf(face, point) = p_choose * 1/area (area measure)
            face_light_pdf[emissive] = p_choose / np.maximum(
                scene["face_area"][emissive], 1e-30)
            cdf = np.cumsum(p_choose).astype(np.float32)
        else:
            cdf = np.zeros((0,), np.float32)
        scene["face_emission"] = face_emission
        scene["face_light_pdf"] = face_light_pdf
        scene["emissive_faces"] = emissive
        scene["light_cdf"] = cdf
        scene["light_emission"] = light_emission

        # ---- materials --------------------------------------------------
        scene["materials"] = self.materials.build()

        # ---- textures: padded atlas stack [T, H, W, 3|4] ---------------
        if self._textures:
            hmax = max(t.shape[0] for t in self._textures)
            wmax = max(t.shape[1] for t in self._textures)
            ch = max(t.shape[2] for t in self._textures)
            atlas = np.zeros((len(self._textures), hmax, wmax, ch),
                             np.float32)
            if ch == 4:
                atlas[..., 3] = 1.0  # opaque where unspecified
            sizes = np.zeros((len(self._textures), 2), np.int32)
            for i, t in enumerate(self._textures):
                atlas[i, : t.shape[0], : t.shape[1], : t.shape[2]] = t
                sizes[i] = (t.shape[0], t.shape[1])
            scene["texture_atlas"] = atlas
            scene["texture_sizes"] = sizes
        else:
            scene["texture_atlas"] = np.zeros((1, 1, 1, 3), np.float32)
            scene["texture_sizes"] = np.ones((1, 2), np.int32)

        # ---- curves (hair) ---------------------------------------------
        curve_pts = []
        curve_mat = []
        curve_inst = []
        curve_col = []
        any_colors = False
        for inst_id, inst in enumerate(self._instances):
            for cm in inst.curves:
                if inst.transform is not None:
                    vt = transform_curve_points(cm.vertices_thickness,
                                                inst.transform)
                    cm = CubicBezierCurveMesh(
                        vt, cm.indices, material_id=cm.material_id,
                        name=cm.name, segment_colors=cm.segment_colors)
                curve_pts.append(cm.segment_points())
                curve_mat.append(np.full((cm.num_segments,), cm.material_id,
                                         np.int32))
                curve_inst.append(np.full((cm.num_segments,), inst_id, np.int32))
                if cm.segment_colors is not None:
                    any_colors = True
                    curve_col.append(cm.segment_colors)
                else:  # -1 marks "no file color: use the material's"
                    curve_col.append(np.full((cm.num_segments, 3), -1.0,
                                             np.float32))
        scene["curve_pts"] = (
            np.concatenate(curve_pts).astype(np.float32)
            if curve_pts else np.zeros((0, 4, 4), np.float32))
        scene["curve_material"] = (
            np.concatenate(curve_mat) if curve_mat else np.zeros((0,), np.int32))
        scene["curve_instance"] = (
            np.concatenate(curve_inst) if curve_inst else np.zeros((0,), np.int32))
        if any_colors:
            # per-segment hair base-color override from CyHair color
            # blocks; key absent for color-free scenes so the hot loop
            # pays nothing (cyhair.cc:105-116 — parsed, never consumed
            # by the reference)
            scene["curve_color"] = np.concatenate(curve_col).astype(
                np.float32)

        # ---- AABB (reference Scene::FetchSceneAABB semantics) ----------
        pts = [V.reshape(-1, 3)] if V.size else []
        if scene["curve_pts"].size:
            cp = scene["curve_pts"].reshape(-1, 4)
            pts.append(cp[:, :3] - cp[:, 3:4])
            pts.append(cp[:, :3] + cp[:, 3:4])
        allp = np.concatenate(pts) if pts else np.zeros((1, 3), np.float32)
        scene["aabb_min"] = allp.min(axis=0).astype(np.float32)
        scene["aabb_max"] = allp.max(axis=0).astype(np.float32)
        return scene


def _signature_cut(node_aabb: np.ndarray, node_meta: np.ndarray,
                   max_nodes: int = 29) -> np.ndarray:
    """BFS cut of the trace BVH: <= max_nodes subtree AABBs [6, K].

    The integrator's ray-compaction key is the bitmask "which of these
    subtrees can the ray hit" — hierarchical (lex-adjacent rays share
    coarse traversal prefixes), one uint32, and ~4x cheaper to compute
    than the full leaf-cluster signature. Padding columns are empty boxes
    (lo=+inf) that never set a bit.
    """
    right = node_meta[0]
    # expand the largest-surface node first until the cut is full
    cut = [0]
    while True:
        areas = []
        for i, n in enumerate(cut):
            if right[n] < 0:
                areas.append(-1.0)  # leaf: cannot expand
            else:
                d = np.maximum(node_aabb[3:6, n] - node_aabb[0:3, n], 0.0)
                areas.append(float(d[0] * d[1] + d[1] * d[2] + d[2] * d[0]))
        j = int(np.argmax(areas))
        if areas[j] < 0.0 or len(cut) + 1 > max_nodes:
            break
        n = cut.pop(j)
        cut = [n + 1, int(right[n])] + cut
    out = np.full((6, max_nodes), np.inf, np.float32)
    out[3:6, :] = -np.inf
    for i, n in enumerate(sorted(cut)):
        out[:, i] = node_aabb[:, n]
    return out


def commit(scene: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Build acceleration structures (reference Scene::CommitScene +
    eager Embree BVH builds, scene.cc:96-104 / raytracer_impl.cc:49-152).

    Adds the flat threaded-BVH arrays consumed by ops.intersect.
    """
    from ..geometry.bvh import build_bvh, build_slot_order, triangle_bounds

    scene = dict(scene)

    # The leaf-32 SAH slot layout is the CANONICAL face order: every
    # per-face column is scattered into the padded slot array (S slots,
    # padding rows zero), so trace prim ids ARE scene face ids. The same
    # build's node arrays give the compaction signature cut.
    order, node_aabb, node_meta = build_slot_order(
        scene["tri_v0"], scene["tri_e1"], scene["tri_e2"])
    F = scene["tri_v0"].shape[0]
    S = order.shape[0]
    if F:
        valid = order >= 0
        src = np.maximum(order, 0)
        for key in ("tri_v0", "tri_e1", "tri_e2", "face_ng", "face_area",
                    "face_ns", "face_has_ns", "face_uv", "face_has_uv",
                    "face_material", "face_light", "face_instance",
                    "face_geom", "face_emission", "face_light_pdf"):
            col = scene[key][src]
            col = np.where(
                valid.reshape((S,) + (1,) * (col.ndim - 1)), col,
                np.zeros_like(col))
            scene[key] = col
        inv = np.full((F,), -1, np.int32)
        inv[order[valid]] = np.nonzero(valid)[0].astype(np.int32)
        if scene["emissive_faces"].size:
            scene["emissive_faces"] = inv[scene["emissive_faces"]]
    scene["sig_aabb"] = _signature_cut(node_aabb, node_meta, max_nodes=29)

    # threaded BVH over the valid slots, prim ids remapped to slot ids
    if F:
        vslots = np.nonzero(order >= 0)[0].astype(np.int32)
        bmin, bmax = triangle_bounds(scene["tri_v0"][vslots],
                                     scene["tri_e1"][vslots],
                                     scene["tri_e2"][vslots])
    else:
        bmin, bmax = triangle_bounds(scene["tri_v0"], scene["tri_e1"],
                                     scene["tri_e2"])
    bvh = build_bvh(bmin, bmax)
    scene["bvh_min"] = bvh.aabb_min
    scene["bvh_max"] = bvh.aabb_max
    scene["bvh_skip"] = bvh.skip
    scene["bvh_prim_offset"] = bvh.prim_offset
    scene["bvh_prim_ids"] = np.where(
        bvh.prim_ids >= 0, vslots[np.maximum(bvh.prim_ids, 0)],
        -1).astype(np.int32) if F else bvh.prim_ids

    return commit_curves(scene)


def commit_curves(scene: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Curve (hair) acceleration structures: flatten Bezier segments into
    linear sub-segments in Morton order of their midpoints, and build the
    curve BVH. Shared by the baked `commit` and `build_instanced`
    (reference: hair registered into local scenes exactly like triangles,
    raytracer_impl.cc:154-197)."""
    from ..geometry.bvh import build_bvh, morton_order
    from ..ops.curves import flatten_curves, subsegment_bounds

    scene = dict(scene)
    flat = flatten_curves(scene["curve_pts"])
    if flat["curve_p0"].shape[0]:
        seg_order = morton_order(0.5 * (flat["curve_p0"] + flat["curve_p1"]))
        for key in ("curve_p0", "curve_p1", "curve_r0", "curve_r1",
                    "curve_seg", "curve_u0", "curve_u1"):
            flat[key] = flat[key][seg_order]
    scene.update(flat)
    cmin, cmax = subsegment_bounds(flat)
    cbvh = build_bvh(cmin, cmax)
    scene["cbvh_min"] = cbvh.aabb_min
    scene["cbvh_max"] = cbvh.aabb_max
    scene["cbvh_skip"] = cbvh.skip
    scene["cbvh_prim_offset"] = cbvh.prim_offset
    scene["cbvh_prim_ids"] = cbvh.prim_ids
    return scene


def transform_curve_points(vt: np.ndarray, m: Optional[np.ndarray]):
    """Bake curve control points [P, 4] (xyz + radius) through a 4x4.

    The reference traces curves in local space under the instance transform
    (raytracer_impl.cc:154-197 + :49-84); baking the control points is the
    equivalent world-space curve (affine images of Bezier control points
    ARE the transformed curve). Radii scale by the mean singular value of
    the linear part — exact for uniform scale + rotation; non-uniform
    scale of a flat-curve radius is ill-defined in the reference too."""
    if m is None:
        return vt
    m = np.asarray(m, np.float64)
    out = np.asarray(vt, np.float32).copy()
    out[:, :3] = (out[:, :3] @ m[:3, :3].T + m[:3, 3]).astype(np.float32)
    out[:, 3] *= float(np.mean(np.linalg.svd(m[:3, :3], compute_uv=False)))
    return out


def build_fat_tables(scene: Dict) -> Dict:
    """Pack per-face / material / emissive-face data into fat row matrices.

    Runs INSIDE jit at render start (cheap concatenations) so the packed
    rows are functions of the differentiable leaves — gradients flow
    through the pack to the original material/light columns. One fat-row
    gather per lane then replaces ~40 thin gathers per wavefront step.

    face_fat [F, 26]: 0:3 ng | 3:12 corner ns | 12:18 corner uv | 18 has_ns
      | 19 has_uv | 20 mat_id | 21 light_pdf | 22:25 emission | 25 instance
    light_fat [LF, 16]: v0 e1 e2 ng emission pdf
    mat_fat [M, K]: see materials.fat_layout().
    """
    import jax.numpy as jnp

    from .materials import pack_material_fat

    scene = dict(scene)
    f32 = jnp.float32
    if "iface_material" in scene:
        # instanced scene (scene.instanced): narrow per-(instance, face)
        # rows; geometric attributes stay per-LOCAL-face in local_fat
        scene["iface_fat"] = jnp.concatenate([
            scene["iface_material"].astype(f32)[:, None],
            scene["iface_light_pdf"][:, None],
            scene["iface_emission"],
            scene["iface_instance"].astype(f32)[:, None],
            scene["iface_local_slot"].astype(f32)[:, None],
            jnp.zeros((scene["iface_material"].shape[0], 1), f32),
        ], axis=1)
        lf = scene["emissive_faces"]
        if lf.shape[0]:
            scene["light_fat"] = jnp.concatenate([
                scene["light_v0"], scene["light_e1"], scene["light_e2"],
                scene["light_ng"], scene["iface_emission"][lf],
                scene["iface_light_pdf"][lf][:, None],
            ], axis=1)
        else:
            scene["light_fat"] = jnp.zeros((0, 16), f32)
        scene["mat_fat"] = pack_material_fat(scene["materials"])
        if scene["texture_atlas"].shape[:3] != (1, 1, 1):
            from .textures import build_quad_atlas

            scene["texture_quad"] = build_quad_atlas(
                scene["texture_atlas"], scene["texture_sizes"])
        return scene
    F = scene["tri_v0"].shape[0]
    face_fat = jnp.concatenate([
        scene["face_ng"],
        scene["face_ns"].reshape(F, 9),
        scene["face_uv"].reshape(F, 6),
        scene["face_has_ns"].astype(f32)[:, None],
        scene["face_has_uv"].astype(f32)[:, None],
        scene["face_material"].astype(f32)[:, None],
        scene["face_light_pdf"][:, None],
        scene["face_emission"],
        scene["face_instance"].astype(f32)[:, None],
    ], axis=1)
    scene["face_fat"] = face_fat

    lf = scene["emissive_faces"]
    if lf.shape[0]:
        scene["light_fat"] = jnp.concatenate([
            scene["tri_v0"][lf], scene["tri_e1"][lf], scene["tri_e2"][lf],
            scene["face_ng"][lf], scene["face_emission"][lf],
            scene["face_light_pdf"][lf][:, None],
        ], axis=1)
    else:
        scene["light_fat"] = jnp.zeros((0, 16), f32)

    scene["mat_fat"] = pack_material_fat(scene["materials"])

    # quad-texel atlas: one gather per bilinear fetch (textures.py). The
    # all-dummy atlas (shape [1,1,1,3], scene.build with no textures) is
    # skipped statically — _fetch_colors then skips the fetch entirely.
    if scene["texture_atlas"].shape[:3] != (1, 1, 1):
        from .textures import build_quad_atlas

        scene["texture_quad"] = build_quad_atlas(scene["texture_atlas"],
                                                 scene["texture_sizes"])
    return scene


def scene_to_device(scene: Dict) -> Dict:
    """numpy scene dict -> jnp device arrays (pytree passed into jit)."""
    import jax.numpy as jnp

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return jnp.asarray(x)

    return conv(scene)
