"""Host-side binned-SAH BVH builder producing flat, threaded node arrays.

Replaces Embree4's BVH build (/root/reference/src/raytracer/raytracer_impl.cc)
and the bundled nanort SAH builder (/root/reference/src/nanort.h:1887) with a
numpy binned-SAH build whose output is designed for a lock-step wavefront
traversal in plain JAX (ops.intersect):

* nodes are emitted in depth-first order and THREADED: every node stores a
  `skip` index (the next depth-first node whose subtree is disjoint). The
  device traversal then needs only a single node pointer per ray lane —
  "AABB hit -> node+1, miss -> skip[node]" — no per-lane stack, which keeps
  the wavefront loop regular;
* leaves hold a fixed-size window [prim_offset, prim_offset + LEAF_SIZE) into
  a reordered primitive array (padded with -1), so leaf tests are a fixed
  vectorized gather of LEAF_SIZE triangles per lane;
* children are ordered along the split axis so depth-first order approximates
  front-to-back for coherent rays.
"""
from __future__ import annotations

import dataclasses

import numpy as np

LEAF_SIZE = 4
N_BINS = 16
SLOT_CLUSTER = 32  # faces per leaf of the slot-order build (build_slot_order)


@dataclasses.dataclass
class BVH:
    """Flat threaded BVH.

    aabb_min/aabb_max: [Nn, 3] float32 node bounds
    skip:              [Nn] int32 next node on AABB miss (== Nn on exit path)
    prim_offset:       [Nn] int32 first slot in prim_ids for leaves, -1 internal
    prim_ids:          [Np] int32 reordered primitive ids, padded with -1
    """

    aabb_min: np.ndarray
    aabb_max: np.ndarray
    skip: np.ndarray
    prim_offset: np.ndarray
    prim_ids: np.ndarray

    @property
    def num_nodes(self) -> int:
        return int(self.skip.shape[0])


def build_bvh(prim_bmin: np.ndarray, prim_bmax: np.ndarray,
              leaf_size: int = LEAF_SIZE, use_native: bool = True) -> BVH:
    """Build from per-primitive AABBs [P, 3] (works for tris and curves).

    Large builds route through the native C++ builder
    (pbrlab_tpu.geometry.native, native/builder.cpp) when it compiles;
    this numpy implementation is the reference and the fallback.
    """
    P = prim_bmin.shape[0]
    if use_native and P >= 4096:
        from .native import build_bvh_native

        built = build_bvh_native(np.asarray(prim_bmin, np.float32),
                                 np.asarray(prim_bmax, np.float32),
                                 leaf_size)
        if built is not None:
            return built
    if P == 0:
        return BVH(
            aabb_min=np.zeros((1, 3), np.float32),
            aabb_max=np.zeros((1, 3), np.float32),
            skip=np.asarray([1], np.int32),
            prim_offset=np.asarray([0], np.int32),
            prim_ids=np.full((leaf_size,), -1, np.int32),
        )
    prim_bmin = np.asarray(prim_bmin, np.float32)
    prim_bmax = np.asarray(prim_bmax, np.float32)
    centers = 0.5 * (prim_bmin + prim_bmax)

    # Recursion via explicit worklist; children emitted depth-first.
    node_bmin, node_bmax, node_skip, node_prim = [], [], [], []
    prim_ids_out = []

    def emit(ids: np.ndarray) -> int:
        """Emit subtree for primitive ids; returns node index."""
        my = len(node_skip)
        bmin = prim_bmin[ids].min(axis=0)
        bmax = prim_bmax[ids].max(axis=0)
        node_bmin.append(bmin)
        node_bmax.append(bmax)
        node_skip.append(-1)  # patched after subtree emitted
        node_prim.append(-1)

        if len(ids) <= leaf_size:
            node_prim[my] = len(prim_ids_out) * leaf_size
            slot = np.full((leaf_size,), -1, np.int64)
            slot[: len(ids)] = ids
            prim_ids_out.append(slot)
            node_skip[my] = len(node_skip)  # patched later to true skip
            return my

        # binned SAH over the widest axis; fall back to median split
        c = centers[ids]
        ext = c.max(axis=0) - c.min(axis=0)
        axis = int(np.argmax(ext))
        left_ids = right_ids = None
        if ext[axis] > 1e-12:
            lo = c[:, axis].min()
            scale = N_BINS * (1.0 - 1e-6) / ext[axis]
            bins = np.minimum(((c[:, axis] - lo) * scale).astype(np.int64),
                              N_BINS - 1)
            # per-bin counts and bounds
            counts = np.bincount(bins, minlength=N_BINS)
            binf = np.full((N_BINS, 3), np.inf, np.float32)
            bing = np.full((N_BINS, 3), -np.inf, np.float32)
            for b in range(N_BINS):
                sel = bins == b
                if counts[b]:
                    binf[b] = prim_bmin[ids[sel]].min(axis=0)
                    bing[b] = prim_bmax[ids[sel]].max(axis=0)
            # sweep SAH
            lcnt = np.cumsum(counts)[:-1]
            rcnt = len(ids) - lcnt
            lmin = np.minimum.accumulate(binf, axis=0)[:-1]
            lmax = np.maximum.accumulate(bing, axis=0)[:-1]
            rmin = np.minimum.accumulate(binf[::-1], axis=0)[::-1][1:]
            rmax = np.maximum.accumulate(bing[::-1], axis=0)[::-1][1:]

            def area(mn, mx):
                d = np.maximum(mx - mn, 0.0)
                return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

            cost = lcnt * area(lmin, lmax) + rcnt * area(rmin, rmax)
            cost = np.where((lcnt == 0) | (rcnt == 0), np.inf, cost)
            best = int(np.argmin(cost))
            if np.isfinite(cost[best]):
                sel = bins <= best
                left_ids, right_ids = ids[sel], ids[~sel]
        if left_ids is None or len(left_ids) == 0 or len(right_ids) == 0:
            order = np.argsort(c[:, axis], kind="stable")
            half = len(ids) // 2
            left_ids, right_ids = ids[order[:half]], ids[order[half:]]

        # near child first along split axis (approximate front-to-back)
        emit(left_ids)
        emit(right_ids)
        node_skip[my] = len(node_skip)
        return my

    emit(np.arange(P, dtype=np.int64))
    n = len(node_skip)
    return BVH(
        aabb_min=np.stack(node_bmin).astype(np.float32),
        aabb_max=np.stack(node_bmax).astype(np.float32),
        skip=np.asarray(node_skip, np.int32),
        prim_offset=np.asarray(node_prim, np.int32),
        prim_ids=np.concatenate(prim_ids_out).astype(np.int32)
        if prim_ids_out else np.full((leaf_size,), -1, np.int32),
    )


def triangle_bounds(v0, e1, e2):
    """Per-triangle AABBs from the scene's v0/e1/e2 layout."""
    v1 = v0 + e1
    v2 = v0 + e2
    bmin = np.minimum(np.minimum(v0, v1), v2)
    bmax = np.maximum(np.maximum(v0, v1), v2)
    return bmin, bmax


def curve_bounds(curve_pts):
    """Per-segment conservative AABBs: control hull +- max radius [S,4,4]."""
    p = curve_pts[..., :3]
    r = curve_pts[..., 3].max(axis=-1, keepdims=True)
    return p.min(axis=1) - r, p.max(axis=1) + r


def node_arrays(bvh: BVH):
    """Child-linked view of a threaded BVH: (node_aabb [6, Nn] lo|hi,
    node_meta [2, Nn]) with node_meta[0] = right-child index for internal
    nodes / -1 for leaves and node_meta[1] = leaf slot base / -1.

    Depth-first emission puts the left child at n + 1, and the right child
    is the next disjoint subtree after it: skip[n + 1]. Validated here so
    the native builder cannot silently break the derivation.
    """
    nn = bvh.num_nodes
    internal = np.nonzero(bvh.prim_offset < 0)[0]
    right = np.full((nn,), -1, np.int32)
    if internal.size:
        right[internal] = bvh.skip[internal + 1]
        assert (right[internal] > internal + 1).all()
        assert (bvh.skip[right[internal]] == bvh.skip[internal]).all()
    node_meta = np.stack([right, bvh.prim_offset]).astype(np.int32)
    node_aabb = np.concatenate([bvh.aabb_min.T, bvh.aabb_max.T]).astype(
        np.float32)
    return node_aabb, node_meta


def build_slot_order(tri_v0: np.ndarray, tri_e1: np.ndarray,
                     tri_e2: np.ndarray, cluster: int = SLOT_CLUSTER):
    """The scene's canonical face slot order: a binned-SAH build with
    `cluster`-face leaves whose windows, in depth-first order, become the
    slots (padding slots are -1). Spatially adjacent faces get adjacent
    ids, and the node arrays feed the integrator's compaction signature
    (scene._signature_cut).

    Returns (order [S] source face ids with -1 padding, node_aabb [6, Nn],
    node_meta [2, Nn]); see node_arrays for the node layout.
    """
    if tri_v0.shape[0] == 0:
        node_aabb = np.zeros((6, 1), np.float32)
        node_aabb[0:3] = 1e30
        node_aabb[3:6] = -1e30
        node_meta = np.asarray([[-1], [0]], np.int32)
        return np.full((cluster,), -1, np.int32), node_aabb, node_meta
    bmin, bmax = triangle_bounds(tri_v0, tri_e1, tri_e2)
    bvh = build_bvh(bmin, bmax, leaf_size=cluster)
    node_aabb, node_meta = node_arrays(bvh)
    return bvh.prim_ids.astype(np.int32), node_aabb, node_meta


def morton_order(points: np.ndarray) -> np.ndarray:
    """Stable Morton (Z-curve) order of [n, 3] points, 10 bits per axis
    over the points' own bounds."""
    lo = points.min(axis=0)
    ext = np.maximum(points.max(axis=0) - lo, 1e-12)
    q = np.clip(((points - lo) / ext * 1023.0).astype(np.uint64), 0, 1023)

    def spread(x):
        x = (x | (x << 16)) & np.uint64(0x30000FF)
        x = (x | (x << 8)) & np.uint64(0x300F00F)
        x = (x | (x << 4)) & np.uint64(0x30C30C3)
        x = (x | (x << 2)) & np.uint64(0x9249249)
        return x

    keys = spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) \
        | (spread(q[:, 2]) << np.uint64(2))
    return np.argsort(keys, kind="stable").astype(np.int32)
