"""Multi-host distributed rendering and training.

Scaling path specified by SURVEY.md §5 / BASELINE.md: multi-host via
``jax.distributed.initialize`` with pixels sharded across the global device
mesh (the sharding is axis-agnostic: XLA routes the collectives), replacing
the reference's single-node thread pool
(/root/reference/src/render.cc:192-241). The only cross-host traffic is the
image all-gather at the end of a pass and the psum gradient all-reduce in
the training step — scene arrays are replicated at upload, so per-pass
scaling is embarrassingly parallel.

Works on any backend: the multi-process test drives it with two CPU
processes (tests/test_distributed.py).
"""
from __future__ import annotations

import os
from functools import partial
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .sharding import AXIS, _pad_to, shard_map
from ..render.integrator import render_lanes


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Initialize jax.distributed from args or PBRLAB_* env vars.

    Env: PBRLAB_COORDINATOR (host:port), PBRLAB_NUM_PROCESSES,
    PBRLAB_PROCESS_ID. Returns True when running multi-process; without a
    coordinator the run stays single-process.
    """
    coordinator = coordinator or os.environ.get("PBRLAB_COORDINATOR")
    if num_processes is None and "PBRLAB_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["PBRLAB_NUM_PROCESSES"])
    if process_id is None and "PBRLAB_PROCESS_ID" in os.environ:
        process_id = int(os.environ["PBRLAB_PROCESS_ID"])
    if coordinator is None:
        return False
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)
    return jax.process_count() > 1


def global_mesh() -> Mesh:
    """1-D mesh over every device of every process."""
    return Mesh(np.asarray(jax.devices()), (AXIS,))


def replicate_scene(scene: Dict, mesh: Mesh) -> Dict:
    """Upload the (host-identical) scene dict as replicated global arrays."""
    rep = NamedSharding(mesh, P())

    def put(x):
        x = np.asarray(x)
        return jax.make_array_from_callback(x.shape, rep, lambda idx: x[idx])

    return jax.tree_util.tree_map(put, scene)


def _global_lanes(n: int, n_pad: int, mesh: Mesh):
    """Lane-id array [n_pad] sharded over the mesh axis."""
    sh = NamedSharding(mesh, P(AXIS))
    lanes = np.minimum(np.arange(n_pad, dtype=np.int32), n - 1)
    return jax.make_array_from_callback(lanes.shape, sh,
                                        lambda idx: lanes[idx])


@partial(jax.jit, static_argnames=("width", "height", "spp", "max_steps",
                                   "k_volume", "mesh"))
def _render_global(scene, lanes, width, height, spp, mesh, seed,
                   max_steps, k_volume):
    @partial(shard_map, mesh=mesh, in_specs=(P(), P(AXIS)),
             out_specs=P(AXIS))
    def passes(scene_rep, lane_slice):
        # same persistent-lane refill body as single-chip render(): the
        # multi-host image stays bit-identical to the local one
        from ..render.integrator import render_lanes_wavefront

        return render_lanes_wavefront(scene_rep, width, height, spp, seed,
                                      max_steps, lane_slice,
                                      k_volume=k_volume)

    return passes(scene, lanes) / spp


def render_distributed(scene: Dict, width: int, height: int, spp: int,
                       mesh: Mesh | None = None, seed=0, max_steps: int = 32,
                       k_volume: int = 0) -> np.ndarray:
    """Render with pixel lanes sharded over every device of every process.

    `scene` is the host numpy scene dict (identical on all processes).
    Returns the full [H, W, 3] image on every process (all-gathered).
    Deterministic: per-lane counter RNG makes the image bit-identical to
    the single-device render at the same seed.
    """
    mesh = mesh or global_mesh()
    n = width * height
    n_pad = _pad_to(n, mesh.devices.size)
    scene_g = replicate_scene(scene, mesh)
    lanes = _global_lanes(n, n_pad, mesh)
    acc = _render_global(scene_g, lanes, width, height, spp, mesh, seed,
                         max_steps, k_volume)
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        acc = multihost_utils.process_allgather(acc, tiled=True)
    return np.asarray(acc)[:n].reshape(height, width, 3)
