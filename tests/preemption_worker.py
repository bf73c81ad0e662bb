"""Subprocess worker for the preemption-tolerance test: progressive
render with a checkpoint after every pass; optionally resume first.

argv: ckpt_path out_path max_pass [resume]
Prints "pass <n>" after each completed pass (the parent SIGKILLs us
mid-run to simulate preemption).
"""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")

    from pbrlab_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()

    from pbrlab_tpu.render.progressive import ProgressiveRenderer
    from pbrlab_tpu.scene.demo import build_demo_scene
    from pbrlab_tpu.scene.scene import scene_to_device

    ckpt, out, max_pass = sys.argv[1], sys.argv[2], int(sys.argv[3])
    resume = len(sys.argv) > 4 and sys.argv[4] == "resume"

    scene_np, _ = build_demo_scene(subdiv=1)
    r = ProgressiveRenderer(scene_to_device(scene_np), 16, 16, max_steps=4)
    if resume:
        r.load_checkpoint(ckpt)
    while r.num_passes < max_pass:
        r.step()
        r.save_checkpoint(ckpt)
        print(f"pass {r.num_passes}", flush=True)
    np.save(out, r.average())


if __name__ == "__main__":
    main()
