"""Worker process for the multi-host test (tests/test_distributed.py).

Each process owns 2 virtual CPU devices; jax.distributed glues them into
one 4-device global mesh across 2 processes — the CPU stand-in for a
multi-host deployment (SURVEY.md §5 distributed backend).
"""
import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=2")
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    from pbrlab_tpu.parallel.distributed import (global_mesh,
                                                 init_distributed,
                                                 render_distributed)
    from pbrlab_tpu.scene.demo import build_demo_scene

    assert init_distributed(), "PBRLAB_* env not set"
    assert jax.process_count() == 2, jax.process_count()
    mesh = global_mesh()
    assert mesh.devices.size == 4, mesh

    scene_np, _ = build_demo_scene(subdiv=1, lambert_only=True)
    img = render_distributed(scene_np, 16, 16, 2, mesh=mesh, max_steps=6)
    if jax.process_index() == 0:
        np.save(sys.argv[1], img)
    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
