"""Test harness: force an 8-virtual-device CPU mesh.

The suite runs on the CPU backend: JAX_PLATFORMS and jax.config are both
set before any backend initializes, and XLA_FLAGS gives the CPU eight
virtual devices so the sharding tests run anywhere. The GPU path is
exercised by `python chip_smoke.py` on a machine with a card.
"""
import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# persistent executable cache: the suite's wall time is dominated by
# XLA:CPU compiles of the big wavefront programs; workers and reruns
# share compiled artifacts
from pbrlab_tpu.utils.compile_cache import configure_compile_cache  # noqa: E402

configure_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))


@pytest.fixture(scope="session")
def demo_scene():
    from pbrlab_tpu.scene.demo import build_demo_scene
    from pbrlab_tpu.scene.scene import scene_to_device

    scene_np, _ = build_demo_scene(subdiv=2)
    return scene_to_device(scene_np)


@pytest.fixture(scope="session")
def lambert_scene():
    from pbrlab_tpu.scene.demo import build_demo_scene
    from pbrlab_tpu.scene.scene import scene_to_device

    scene_np, _ = build_demo_scene(subdiv=2, lambert_only=True)
    return scene_to_device(scene_np)


@pytest.fixture()
def rng_np():
    return np.random.default_rng(12345)
