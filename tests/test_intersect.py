"""BVH correctness vs brute-force intersection (SURVEY.md §4 strategy)."""
import jax.numpy as jnp
import numpy as np
import pytest

from pbrlab_tpu.core.math import INF
from pbrlab_tpu.ops.intersect import (intersect_bruteforce, intersect_bvh,
                                      occluded_bvh)


def _random_rays(scene, n, rng):
    bmin = np.asarray(scene["aabb_min"])
    bmax = np.asarray(scene["aabb_max"])
    center = 0.5 * (bmin + bmax)
    ext = (bmax - bmin).max()
    org = center + (rng.random((n, 3)) - 0.5) * 2.5 * ext
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (jnp.asarray(org, jnp.float32), jnp.asarray(d, jnp.float32),
            jnp.zeros((n,), jnp.float32), jnp.full((n,), INF, jnp.float32))


def test_bvh_matches_bruteforce(demo_scene, rng_np):
    org, d, mn, mx = _random_rays(demo_scene, 512, rng_np)
    ref = intersect_bruteforce(demo_scene, org, d, mn, mx)
    got = intersect_bvh(demo_scene, org, d, mn, mx)
    hit_ref = np.asarray(ref["prim"]) >= 0
    hit_got = np.asarray(got["prim"]) >= 0
    np.testing.assert_array_equal(hit_ref, hit_got)
    # same t everywhere (prim ids can differ on shared edges)
    np.testing.assert_allclose(np.asarray(got["t"])[hit_ref],
                               np.asarray(ref["t"])[hit_ref], rtol=1e-4)
    same_prim = np.asarray(ref["prim"]) == np.asarray(got["prim"])
    assert same_prim[hit_ref].mean() > 0.99
    uvok = same_prim & hit_ref
    np.testing.assert_allclose(np.asarray(got["u"])[uvok],
                               np.asarray(ref["u"])[uvok], atol=1e-4)


def test_bvh_respects_max_t(demo_scene, rng_np):
    org, d, mn, _ = _random_rays(demo_scene, 512, rng_np)
    full = intersect_bvh(demo_scene, org, d, mn,
                         jnp.full((512,), INF, jnp.float32))
    t = np.asarray(full["t"])
    hit = np.asarray(full["prim"]) >= 0
    # shrink max_t below each hit -> those lanes must miss
    limited = intersect_bvh(demo_scene, org, d, mn,
                            jnp.asarray(np.where(hit, t * 0.5, 1.0),
                                        jnp.float32))
    assert (np.asarray(limited["prim"])[hit] == -1).all()


def test_occluded_matches_closest(demo_scene, rng_np):
    org, d, mn, mx = _random_rays(demo_scene, 512, rng_np)
    closest = intersect_bvh(demo_scene, org, d, mn, mx)
    occ = occluded_bvh(demo_scene, org, d, mn, mx)
    np.testing.assert_array_equal(np.asarray(occ),
                                  np.asarray(closest["prim"]) >= 0)


def test_inside_box_hits(demo_scene):
    # rays from the box center away from the +z opening must hit geometry
    g = np.random.default_rng(7)
    d = g.normal(size=(512, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = d[d[:, 2] < -0.05]
    n = d.shape[0]
    org = jnp.broadcast_to(jnp.asarray([[0.0, 1.0, 0.0]], jnp.float32),
                           (n, 3))
    res = intersect_bvh(demo_scene, org, jnp.asarray(d, jnp.float32),
                        jnp.zeros((n,)), jnp.full((n,), INF))
    assert (np.asarray(res["prim"]) >= 0).all()


# ---- the XLA trace path on scenes of every shape -------------------------
# (closest hit vs brute force, any-hit vs closest, max_t / dead lanes, and
# lane-permutation invariance) x (demo, irregular mesh, no triangles)


def _hair_only_scene():
    from pbrlab_tpu.io.cyhair import make_demo_hair
    from pbrlab_tpu.scene.scene import SceneBuilder, commit

    b = SceneBuilder()
    hair = make_demo_hair(num_strands=24, base=(0.0, 1.0, 0.0))
    hair.material_id = b.materials.add_hair("hair")
    b.add_instance([], curves=[hair])
    return commit(b.build())


_SCENES = {}


def _scene(kind):
    if kind not in _SCENES:
        from pbrlab_tpu.scene.demo import build_demo_scene
        from pbrlab_tpu.scene.scene import scene_to_device

        if kind == "demo":
            scene_np = build_demo_scene(subdiv=1)[0]
        elif kind == "irregular":
            scene_np = build_demo_scene(subdiv=1, irregular=True)[0]
        else:  # triangles absent: hair only
            scene_np = _hair_only_scene()
        _SCENES[kind] = scene_to_device(scene_np)
    return _SCENES[kind]


def _check_closest(scene, org, d, mn, mx, rng):
    ref = intersect_bruteforce(scene, org, d, mn, mx)
    got = intersect_bvh(scene, org, d, mn, mx)
    hit = np.asarray(ref["prim"]) >= 0
    np.testing.assert_array_equal(hit, np.asarray(got["prim"]) >= 0)
    np.testing.assert_allclose(np.asarray(got["t"])[hit],
                               np.asarray(ref["t"])[hit], rtol=1e-4)
    if hit.any():
        same = np.asarray(ref["prim"]) == np.asarray(got["prim"])
        assert same[hit].mean() > 0.99


def _check_any_hit(scene, org, d, mn, mx, rng):
    from pbrlab_tpu.ops.intersect import occluded_scene

    ref = intersect_bruteforce(scene, org, d, mn, mx)
    t_ref = np.asarray(ref["t"])
    hit = np.asarray(ref["prim"]) >= 0
    lim = 1.5
    occ = np.asarray(occluded_bvh(scene, org, d, mn,
                                  jnp.full(mn.shape, lim, jnp.float32)))
    off_band = ~hit | (np.abs(t_ref - lim) > 1e-3)
    np.testing.assert_array_equal(occ[off_band],
                                  (hit & (t_ref <= lim))[off_band])
    if scene["curve_pts"].shape[0] == 0:  # dispatch: same query
        np.testing.assert_array_equal(
            occ, np.asarray(occluded_scene(
                scene, org, d, mn, jnp.full(mn.shape, lim, jnp.float32))))


def _check_max_t_dead(scene, org, d, mn, mx, rng):
    full = intersect_bvh(scene, org, d, mn, mx)
    t = np.asarray(full["t"])
    hit = np.asarray(full["prim"]) >= 0
    lim = np.where(hit, t * 0.5, 1.0).astype(np.float32)
    lim[::3] = -1.0  # dead lanes never traverse
    got = np.asarray(intersect_bvh(scene, org, d, mn,
                                   jnp.asarray(lim))["prim"])
    assert (got[hit] == -1).all()
    assert (got[::3] == -1).all()


def _check_permutation(scene, org, d, mn, mx, rng):
    perm = rng.permutation(org.shape[0])
    base = intersect_bvh(scene, org, d, mn, mx)
    shuf = intersect_bvh(scene, org[perm], d[perm], mn[perm], mx[perm])
    for k in ("t", "u", "v", "prim"):
        np.testing.assert_array_equal(np.asarray(base[k])[perm],
                                      np.asarray(shuf[k]))


_CHECKS = {"closest": _check_closest, "any_hit": _check_any_hit,
           "max_t_dead": _check_max_t_dead,
           "permutation": _check_permutation}


@pytest.mark.parametrize("kind", ["demo", "irregular", "no_triangles"])
@pytest.mark.parametrize("check", sorted(_CHECKS))
def test_trace_xla(check, kind, rng_np):
    scene = _scene(kind)
    org, d, mn, mx = _random_rays(scene, 512, rng_np)
    _CHECKS[check](scene, org, d, mn, mx, rng_np)


@pytest.mark.parametrize("any_hit", [False, True])
def test_curve_trace_matches_bruteforce(any_hit, rng_np):
    """Hair: the curve-BVH walk vs every sub-segment."""
    from pbrlab_tpu.ops.curves import curve_trace, curve_trace_bruteforce

    scene = _scene("no_triangles")
    n = 1024
    org = jnp.asarray(rng_np.normal(0, 0.3, (n, 3)) + [0, 1.2, 0],
                      jnp.float32)
    d = rng_np.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = jnp.asarray(d, jnp.float32)
    mn = jnp.zeros((n,), jnp.float32)
    mx = jnp.full((n,), INF, jnp.float32)
    ref = curve_trace_bruteforce(scene, org, d, mn, mx)
    got = curve_trace(scene, org, d, mn, mx, any_hit=any_hit)
    hit = np.asarray(ref["seg"]) >= 0
    assert hit.sum() > 20
    np.testing.assert_array_equal(hit, np.asarray(got["seg"]) >= 0)
    if any_hit:
        return
    np.testing.assert_allclose(np.asarray(got["t"])[hit],
                               np.asarray(ref["t"])[hit], rtol=1e-4)
    same = np.asarray(got["seg"]) == np.asarray(ref["seg"])
    assert same[hit].mean() > 0.99
    np.testing.assert_allclose(np.asarray(got["v"])[hit & same],
                               np.asarray(ref["v"])[hit & same], atol=1e-4)
