"""Quickest proof that the path tracer runs on a GPU.

Drives the main path once per deployment through the entry points a user
calls, at real sizes, on one card: the CLI demo render, a 235k-triangle
scene, hair, ~100 shared instances, a gradient step and a progressive
preview with a live material edit. Every trace is compared on the card with
its plain reference (brute force), and pixels of every phase's image are
rendered again on the CPU device of this process and compared. Prints one
JSON line per phase (compile and run seconds, peak device memory, every
comparison figure), the card's name and power limit, and last the contract
line {"ok": true, "device": {...}}. Any failed check raises: no ok line.

    python chip_smoke.py           # one GPU, every phase
    python chip_smoke.py --multi   # four GPUs: sharded render + train step
                                   # against one GPU, and nothing else
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np


@dataclasses.dataclass(frozen=True)
class Sizes:
    res: int = 1024  # headline and progressive image side
    spp: int = 4
    max_steps: int = 12
    k_volume: int = 3
    scene_res: int = 512  # xl / hair / instanced image side
    xl_subdiv: int = 6  # ~235k irregular triangles
    xl_spp: int = 2
    instances: int = 100
    grad_res: int = 512
    grad_steps: int = 8
    passes: int = 3
    rays: int = 65536  # one lane batch
    cmp_pixels: int = 4096  # GPU-vs-CPU image comparison


FULL = Sizes()


def emit(**fields) -> None:
    print(json.dumps(fields, default=float), flush=True)


def peak_bytes():
    import jax

    return (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")


def memory_analysis(compiled) -> dict:
    m = compiled.memory_analysis()
    return {k: getattr(m, k) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")}


def compile_and_run(jitted, args, static, repeat=1):
    """AOT-compile jitted(*args, **static), run it `repeat` times.
    Returns (outputs, compile seconds, run seconds per call, compiled)."""
    import jax

    t0 = time.perf_counter()
    compiled = jitted.lower(*args, **static).compile()
    compile_s = time.perf_counter() - t0
    outs, run_s = [], []
    for _ in range(repeat):
        t0 = time.perf_counter()
        outs.append(jax.block_until_ready(compiled(*args)))
        run_s.append(time.perf_counter() - t0)
    return outs, compile_s, run_s, compiled


def render_phase(tag, scene_np, res, spp, max_steps, k_volume, repeat=1):
    """One render() of scene_np on the default device; checks the image."""
    from pbrlab_tpu.render.integrator import render
    from pbrlab_tpu.scene.scene import scene_to_device

    outs, compile_s, run_s, compiled = compile_and_run(
        render, (scene_to_device(scene_np),),
        dict(width=res, height=res, spp=spp, max_steps=max_steps,
             k_volume=k_volume), repeat)
    img = np.asarray(outs[0])
    assert img.shape == (res, res, 3), img.shape
    assert np.isfinite(img).all(), f"{tag}: non-finite pixels"
    assert img.mean() > 1e-3, f"{tag}: black image"
    stats = dict(phase=tag, res=res, spp=spp, max_steps=max_steps,
                 k_volume=k_volume, compile_s=compile_s, run_s=run_s,
                 mean=float(img.mean()), peak_bytes_in_use=peak_bytes())
    if repeat > 1:
        stats["bit_identical_rerun"] = all(
            np.array_equal(img, np.asarray(o)) for o in outs[1:])
        assert stats["bit_identical_rerun"], f"{tag}: rerun differs"
    return img, stats, compiled


def random_rays(scene_np, n, seed):
    import jax.numpy as jnp

    g = np.random.default_rng(seed)
    lo = np.asarray(scene_np["aabb_min"])
    hi = np.asarray(scene_np["aabb_max"])
    org = lo + (hi - lo) * g.random((n, 3))
    d = g.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (jnp.asarray(org, jnp.float32), jnp.asarray(d, jnp.float32),
            jnp.zeros((n,), jnp.float32), jnp.full((n,), 1e18, jnp.float32))


def compare_triangles(tag, scene_np, n_rays):
    """trace_scene / occluded_scene against brute force."""
    import jax
    import jax.numpy as jnp

    from pbrlab_tpu.ops.intersect import (intersect_bruteforce,
                                          occluded_scene, trace_scene)
    from pbrlab_tpu.scene.scene import scene_to_device

    scene = scene_to_device(scene_np)
    org, d, mn, mx = random_rays(scene_np, n_rays, 1)
    t0 = time.perf_counter()
    got = jax.block_until_ready(jax.jit(trace_scene)(scene, org, d, mn, mx))
    trace_s = time.perf_counter() - t0
    ref = intersect_bruteforce(scene, org, d, mn, mx)
    hit_g = np.asarray(got["prim"]) >= 0
    hit_r = np.asarray(ref["prim"]) >= 0
    both = hit_g & hit_r
    t_g, t_r = np.asarray(got["t"]), np.asarray(ref["t"])
    lim = float(0.5 * np.median(t_r[hit_r])) if hit_r.any() else 1.0
    occ = np.asarray(jax.jit(occluded_scene)(
        scene, org, d, mn, jnp.full(mn.shape, lim, jnp.float32)))
    band = hit_r & (np.abs(t_r - lim) <= 1e-3)
    stats = dict(
        check="triangles", scene=tag, rays=n_rays,
        tris=int(scene_np["tri_v0"].shape[0]), trace_s=trace_s,
        hit_rate=float(hit_r.mean()),
        hit_agree=float((hit_g == hit_r).mean()),
        t_max_rel_err=float(np.max(np.abs(t_g[both] - t_r[both])
                                   / np.abs(t_r[both]), initial=0.0)),
        occluded_agree_off_band=float(
            (occ == (hit_r & (t_r <= lim)))[~band].mean()))
    emit(**stats)
    assert stats["hit_agree"] >= 0.999, stats
    np.testing.assert_allclose(t_g[both], t_r[both], rtol=1e-4)
    assert stats["occluded_agree_off_band"] == 1.0, stats


def compare_curves(scene_np, n_rays):
    """curve_trace (closest and any-hit) against every sub-segment."""
    import jax
    import jax.numpy as jnp

    from pbrlab_tpu.ops.curves import curve_trace, curve_trace_bruteforce
    from pbrlab_tpu.scene.scene import scene_to_device

    scene = scene_to_device(scene_np)
    g = np.random.default_rng(2)
    cp = scene_np["curve_pts"][..., :3].reshape(-1, 3)
    lo, hi = cp.min(axis=0), cp.max(axis=0)
    org = jnp.asarray(lo + (hi - lo) * g.random((n_rays, 3)), jnp.float32)
    d = g.normal(size=(n_rays, 3))
    d = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True),
                    jnp.float32)
    mn = jnp.zeros((n_rays,), jnp.float32)
    mx = jnp.full((n_rays,), 1e18, jnp.float32)
    got = jax.jit(curve_trace)(scene, org, d, mn, mx)
    anyh = jax.jit(curve_trace, static_argnames="any_hit")(
        scene, org, d, mn, mx, any_hit=True)
    ref = jax.jit(curve_trace_bruteforce)(scene, org, d, mn, mx)
    hit_r = np.asarray(ref["seg"]) >= 0
    hit_g = np.asarray(got["seg"]) >= 0
    both = hit_g & hit_r
    t_g, t_r = np.asarray(got["t"]), np.asarray(ref["t"])
    stats = dict(
        check="curves", rays=n_rays,
        subsegments=int(scene_np["curve_p0"].shape[0]),
        hit_rate=float(hit_r.mean()),
        hit_agree=float((hit_g == hit_r).mean()),
        any_hit_agree=float(((np.asarray(anyh["seg"]) >= 0) == hit_r).mean()),
        t_max_rel_err=float(np.max(np.abs(t_g[both] - t_r[both])
                                   / np.abs(t_r[both]), initial=0.0)))
    emit(**stats)
    assert hit_r.sum() > 0, stats
    assert stats["hit_agree"] >= 0.999, stats
    assert stats["any_hit_agree"] >= 0.999, stats
    np.testing.assert_allclose(t_g[both], t_r[both], rtol=1e-4)


def compare_instanced(si_np, sb_np, n_rays):
    """Two-level walk against brute force over the baked scene."""
    import jax

    from pbrlab_tpu.ops.intersect import (intersect_bruteforce,
                                          intersect_instanced)
    from pbrlab_tpu.scene.scene import scene_to_device

    org, d, mn, mx = random_rays(si_np, n_rays, 3)
    walk = jax.jit(intersect_instanced, static_argnames="any_hit")
    si = scene_to_device(si_np)
    got = walk(si, org, d, mn, mx)
    anyh = walk(si, org, d, mn, mx, any_hit=True)
    ref = intersect_bruteforce(scene_to_device(sb_np), org, d, mn, mx)
    hit_r = np.asarray(ref["prim"]) >= 0
    hit_g = np.asarray(got["prim"]) >= 0
    both = hit_g & hit_r
    t_g, t_r = np.asarray(got["t"]), np.asarray(ref["t"])
    stats = dict(
        check="instanced", rays=n_rays,
        instances=int(si_np["inst_meta"].shape[0]),
        hit_rate=float(hit_r.mean()),
        hit_mismatch=float((hit_g != hit_r).mean()),
        any_hit_mismatch=float(((np.asarray(anyh["prim"]) >= 0)
                                != hit_r).mean()))
    emit(**stats)
    assert stats["hit_mismatch"] < 2e-3, stats
    assert stats["any_hit_mismatch"] < 2e-3, stats
    np.testing.assert_allclose(t_g[both], t_r[both], rtol=2e-4, atol=2e-4)


def image_agreement(a, b) -> dict:
    return dict(
        within_2e2=float(np.isclose(a, b, rtol=2e-2, atol=2e-2).mean()),
        within_1e4=float(np.isclose(a, b, rtol=1e-4, atol=1e-4).mean()),
        mean_a=float(a.mean()), mean_b=float(b.mean()))


def assert_images_agree(stats):
    assert stats["within_2e2"] >= 0.97, stats
    np.testing.assert_allclose(stats["mean_a"], stats["mean_b"], rtol=2e-2)


def compare_gpu_cpu(tag, scene_np, img, spp, max_steps, k_volume, n_pixels):
    """n_pixels of the device image `img` against the same pixels rendered
    on the CPU device. A pixel's samples are a pure function of (pixel,
    sample, seed), so the CPU renders just those lanes."""
    import jax
    import jax.numpy as jnp

    from pbrlab_tpu.render.integrator import render_lanes_wavefront
    from pbrlab_tpu.scene.scene import scene_to_device

    h, w, _ = img.shape
    pix = np.sort(np.random.default_rng(4).choice(
        h * w, min(n_pixels, h * w), replace=False)).astype(np.int32)
    t0 = time.perf_counter()
    with jax.default_device(jax.devices("cpu")[0]):
        cpu = jax.jit(render_lanes_wavefront, static_argnames=(
            "width", "height", "spp", "max_steps", "k_volume"))(
            scene_to_device(scene_np), width=w, height=h, spp=spp,
            max_steps=max_steps, lane=jnp.asarray(pix), k_volume=k_volume)
        cpu = np.asarray(cpu) / spp
    dev = img.reshape(-1, 3)[pix]
    stats = dict(check="gpu_vs_cpu_image", scene=tag, pixels=int(pix.size),
                 spp=spp, cpu_s=time.perf_counter() - t0,
                 **image_agreement(dev, cpu))
    emit(**stats)
    assert np.isfinite(cpu).all(), tag
    assert_images_agree(stats)


# ---------------------------------------------------------------- phases


def phase_headline(sz, out_dir):
    """CLI demo render (the bench headline's scene and settings), then the
    same render() in-process: compiled, run twice, bit-identical."""
    from pbrlab_tpu.app import cli
    from pbrlab_tpu.scene.demo import build_demo_scene

    scene_np, builder = build_demo_scene()
    img, stats, compiled = render_phase(
        "headline", scene_np, sz.res, sz.spp, sz.max_steps, sz.k_volume,
        repeat=2)
    stats["memory_analysis"] = memory_analysis(compiled)
    png = os.path.join(out_dir, "headline.png")
    t0 = time.perf_counter()
    rc = cli.main(["demo", "--width", str(sz.res), "--height", str(sz.res),
                   "--spp", str(sz.spp), "--max-steps", str(sz.max_steps),
                   "--k-volume", str(sz.k_volume), "--out", png])
    stats["cli_s"] = time.perf_counter() - t0
    assert rc in (None, 0), f"cli returned {rc}"
    with open(png, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n", "cli wrote no PNG"
    stats["png_bytes"] = os.path.getsize(png)
    emit(**stats)
    compare_triangles("headline", scene_np, sz.rays)
    compare_gpu_cpu("headline", scene_np, img, sz.spp, sz.max_steps,
                    sz.k_volume, sz.cmp_pixels)
    return scene_np, builder


def phase_xl(sz):
    from pbrlab_tpu.render.integrator import scene_has_sss
    from pbrlab_tpu.scene.demo import build_demo_scene

    t0 = time.perf_counter()
    scene_np, _ = build_demo_scene(subdiv=sz.xl_subdiv, irregular=True)
    build_s = time.perf_counter() - t0
    kv = sz.k_volume if scene_has_sss(scene_np) else 0
    img, stats, _ = render_phase("xl", scene_np, sz.scene_res, sz.xl_spp,
                                 sz.max_steps, kv)
    emit(**stats, tris=int(scene_np["tri_v0"].shape[0]), build_s=build_s)
    compare_triangles("xl", scene_np, sz.rays)
    compare_gpu_cpu("xl", scene_np, img, sz.xl_spp, sz.max_steps, kv,
                    sz.cmp_pixels)


def phase_hair(sz):
    from pbrlab_tpu.render.integrator import scene_has_sss
    from pbrlab_tpu.scene.demo import build_demo_scene

    scene_np, _ = build_demo_scene(with_hair=True)
    kv = sz.k_volume if scene_has_sss(scene_np) else 0
    img, stats, _ = render_phase("hair", scene_np, sz.scene_res, sz.spp,
                                 sz.max_steps, kv)
    emit(**stats, curve_segments=int(scene_np["curve_pts"].shape[0]))
    compare_curves(scene_np, sz.rays)
    compare_gpu_cpu("hair", scene_np, img, sz.spp, sz.max_steps, kv,
                    sz.cmp_pixels)


def phase_instanced(sz):
    from pbrlab_tpu.scene.demo import instanced_spheres_builders
    from pbrlab_tpu.scene.instanced import build_instanced
    from pbrlab_tpu.scene.scene import commit

    bi, bb = instanced_spheres_builders(sz.instances)
    si_np, sb_np = build_instanced(bi), commit(bb.build())
    img, stats, _ = render_phase("instanced", si_np, sz.scene_res, sz.spp,
                                 sz.max_steps, 0)
    emit(**stats, instances=sz.instances)
    compare_instanced(si_np, sb_np, sz.rays)
    compare_gpu_cpu("instanced", si_np, img, sz.spp, sz.max_steps, 0,
                    sz.cmp_pixels)


def _train_step(scene_np, res, steps, n_devices):
    """One train step over an n-device mesh: (loss, moved, stats)."""
    import jax.numpy as jnp

    from pbrlab_tpu.parallel.sharding import make_mesh, train_step_builder
    from pbrlab_tpu.scene.scene import scene_to_device

    scene = scene_to_device(scene_np)
    target = jnp.full((res, res, 3), 0.25, jnp.float32)
    step = train_step_builder(res, res, 1, make_mesh(n_devices),
                              max_steps=steps)
    (out,), compile_s, run_s, compiled = compile_and_run(
        step, (scene, target), {})
    loss, new_scene = out
    moved = float(jnp.abs(new_scene["materials"]["base_color"]
                          - scene["materials"]["base_color"]).sum())
    return float(loss), moved, dict(
        compile_s=compile_s, run_s=run_s,
        memory_analysis=memory_analysis(compiled),
        peak_bytes_in_use=peak_bytes())


def phase_gradient(sz, scene_np):
    loss, moved, stats = _train_step(scene_np, sz.grad_res, sz.grad_steps, 1)
    emit(phase="gradient", res=sz.grad_res, max_steps=sz.grad_steps,
         loss=loss, param_change=moved, **stats)
    assert np.isfinite(loss), loss
    assert moved > 0.0, "train step moved no parameter"


def phase_progressive(sz, scene_np, builder):
    from pbrlab_tpu.render.progressive import ProgressiveRenderer
    from pbrlab_tpu.scene.scene import scene_to_device

    r = ProgressiveRenderer(scene_to_device(scene_np), sz.res, sz.res,
                            material_names=list(builder.materials.names),
                            max_steps=sz.max_steps, k_volume=sz.k_volume)
    before = None
    for i in range(sz.passes):
        if i == sz.passes - 1:
            before = r.average().copy()
            r.queue_edit("Wall_Red", "base_color", [0.1, 0.1, 0.6])
        r.step()
    after = r.average()
    emit(phase="progressive", res=sz.res, passes=sz.passes,
         pass_s=r.pass_times, passes_after_edit=r.num_passes,
         mean_before_edit=float(before.mean()),
         mean_after_edit=float(after.mean()), peak_bytes_in_use=peak_bytes())
    assert np.isfinite(after).all()
    assert r.num_passes == 1, "the edit must restart accumulation"
    assert not np.array_equal(before, after), "edit changed nothing"


def run_single(sz, out_dir):
    scene_np, builder = phase_headline(sz, out_dir)
    phase_xl(sz)
    phase_hair(sz)
    phase_instanced(sz)
    phase_gradient(sz, scene_np)
    phase_progressive(sz, scene_np, builder)


def run_multi(sz, n_devices=4):
    """Sharded render and train step over n devices against one device."""
    import jax

    from pbrlab_tpu.parallel.sharding import make_mesh, render_sharded
    from pbrlab_tpu.render.integrator import render
    from pbrlab_tpu.scene.demo import build_demo_scene
    from pbrlab_tpu.scene.scene import scene_to_device

    assert len(jax.devices()) >= n_devices, jax.devices()
    scene_np, _ = build_demo_scene()
    scene = scene_to_device(scene_np)
    static = dict(width=sz.res, height=sz.res, spp=sz.spp,
                  max_steps=sz.max_steps, k_volume=sz.k_volume)
    (one,), c1, r1, _ = compile_and_run(render, (scene,), static)
    (many,), cn, rn, _ = compile_and_run(
        render_sharded, (scene,), dict(static, mesh=make_mesh(n_devices)))
    one, many = np.asarray(one), np.asarray(many)
    stats = dict(phase="sharded_render", devices=n_devices, res=sz.res,
                 spp=sz.spp, compile_1_s=c1, run_1_s=r1,
                 compile_n_s=cn, run_n_s=rn,
                 bit_identical=bool(np.array_equal(one, many)),
                 **image_agreement(many, one))
    emit(**stats)
    assert np.isfinite(many).all()
    assert_images_agree(stats)

    loss1, _, s1 = _train_step(scene_np, sz.grad_res, sz.grad_steps, 1)
    lossn, moved, sn = _train_step(scene_np, sz.grad_res, sz.grad_steps,
                                   n_devices)
    emit(phase="sharded_train_step", devices=n_devices, res=sz.grad_res,
         loss_1=loss1, loss_n=lossn, param_change=moved,
         compile_1_s=s1["compile_s"], run_1_s=s1["run_s"],
         compile_n_s=sn["compile_s"], run_n_s=sn["run_s"])
    np.testing.assert_allclose(lossn, loss1, rtol=1e-3)
    assert moved > 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-GPU sharded path")
    args = ap.parse_args(argv)

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pbrlab_tpu.utils.compile_cache import configure_compile_cache
    from pbrlab_tpu.utils.device import (card_name_and_power_limit,
                                         require_gpu)

    device = require_gpu()
    configure_compile_cache()
    emit(device=device)
    t0 = time.perf_counter()
    if args.multi:
        run_multi(FULL)
    else:
        with tempfile.TemporaryDirectory() as out_dir:
            run_single(FULL, out_dir)
    emit(total_s=time.perf_counter() - t0)
    print(card_name_and_power_limit(), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    # the image comparisons render on the CPU device of this process too
    _plats = os.environ.get("JAX_PLATFORMS")
    if _plats and "cpu" not in _plats.split(","):
        os.environ["JAX_PLATFORMS"] = _plats + ",cpu"
    sys.exit(main())
