"""Benchmark: rays/s on the cornellbox demo scene at 1024^2 x 64 spp
(scale down via BENCH_* env vars — Mrays/s is the scale-invariant metric).
Runs only on a GPU: it names the device and the card, and refuses any other
platform.

Prints the device line, the card's `nvidia-smi` name and power limit, then
one JSON line: {"metric", "value", "unit", "device", plus a second
"large_scene_*" measurement at >= 42k triangles and a third "xl_scene_*"
at >= 100k irregular triangles}.

Notes:
* the headline render uses a fixed k_volume=3 (what the CLI's auto rule
  picks for this medium, docs/sss_truncation.md);
* occupancy is algorithm behavior, not hardware behavior, so it is
  measured with a small jitted probe on the CPU backend and applied to the
  device wall time:
      rays = width * height * spp * sum_steps(alive_frac) * 2.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import numpy as np


def measure(scene_np, width, height, spp, max_steps, k_volume):
    from pbrlab_tpu.render.integrator import render
    from pbrlab_tpu.scene.scene import scene_to_device
    from pbrlab_tpu.utils.profiling import measure_occupancy

    ray_units = measure_occupancy(scene_np, max_steps, k_volume=k_volume)
    scene = scene_to_device(scene_np)
    img = render(scene, width, height, spp, max_steps=max_steps,
                 k_volume=k_volume)
    jax.block_until_ready(img)
    np.asarray(img)

    t0 = time.perf_counter()
    img = np.asarray(render(scene, width, height, spp, max_steps=max_steps,
                            k_volume=k_volume))
    dt = time.perf_counter() - t0
    # ray_units includes the closest+shadow x2 and k_volume substep rays
    total_rays = width * height * spp * ray_units
    return total_rays / dt / 1e6


def main():
    # defaults = the headline workload (cornellbox 1024^2, 64 spp);
    # BENCH_* env scales down for quick runs
    width = height = int(os.environ.get("BENCH_RES", "1024"))
    spp = int(os.environ.get("BENCH_SPP", "64"))
    max_steps = int(os.environ.get("BENCH_STEPS", "12"))

    from pbrlab_tpu.render.integrator import scene_has_sss
    from pbrlab_tpu.scene.demo import build_demo_scene
    from pbrlab_tpu.utils.compile_cache import configure_compile_cache
    from pbrlab_tpu.utils.device import (card_name_and_power_limit,
                                         require_gpu)

    device = require_gpu()
    print(json.dumps({"device": device}))
    print(card_name_and_power_limit())
    configure_compile_cache()

    scene_np, _ = build_demo_scene(subdiv=3)
    # fixed k_volume=3 to keep the workload comparable across rounds;
    # the CLI's auto probe (integrator.auto_k_volume) also lands on 3
    # for this medium (docs/sss_truncation.md)
    k_volume = 3 if scene_has_sss(scene_np) else 0
    mrays = measure(scene_np, width, height, spp, max_steps, k_volume)

    out = {
        "metric": f"Mrays/s/GPU (cornellbox {width}^2, {spp}spp, "
                  f"{max_steps} wavefront steps, k_volume={k_volume}, "
                  "occupancy-weighted)",
        "value": round(mrays, 2),
        "unit": "Mrays/s",
        "device": device,
    }

    # second scene: the >=42k-triangle regime with NOISE-DISPLACED
    # (irregular) bodies so the number is not geodesic-sphere best-case;
    # third: an irregular >=100k-tri mesh
    if os.environ.get("BENCH_LARGE", "1") != "0":
        large_np, _ = build_demo_scene(subdiv=5, irregular=True)
        ntri = int(large_np["tri_v0"].shape[0])
        res2 = int(os.environ.get("BENCH_LARGE_RES", "512"))
        spp2 = int(os.environ.get("BENCH_LARGE_SPP", "16"))
        kv2 = 3 if scene_has_sss(large_np) else 0
        mrays2 = measure(large_np, res2, res2, spp2, max_steps, kv2)
        out["large_scene"] = (f"demo subdiv=5 irregular ({ntri} tris), "
                              f"{res2}^2, {spp2}spp, k_volume={kv2}")
        out["large_scene_mrays"] = round(mrays2, 2)
    if os.environ.get("BENCH_XL", "1") != "0":
        xl_np, _ = build_demo_scene(subdiv=6, irregular=True)
        ntri = int(xl_np["tri_v0"].shape[0])
        res3 = int(os.environ.get("BENCH_XL_RES", "512"))
        spp3 = int(os.environ.get("BENCH_XL_SPP", "8"))
        kv3 = 3 if scene_has_sss(xl_np) else 0
        mrays3 = measure(xl_np, res3, res3, spp3, max_steps, kv3)
        out["xl_scene"] = (f"demo subdiv=6 irregular ({ntri} tris), "
                           f"{res3}^2, {spp3}spp, k_volume={kv3}")
        out["xl_scene_mrays"] = round(mrays3, 2)

    print(json.dumps(out))


if __name__ == "__main__":
    main()
