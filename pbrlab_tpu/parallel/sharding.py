"""Multi-chip rendering and training via mesh sharding.

Replaces the reference's only parallelism — a thread pool
with atomic tile work-stealing and mutexed accumulation
(/root/reference/src/render.cc:192-241, SURVEY.md §2.3): pixels are sharded
over a `jax.sharding.Mesh` axis with `shard_map`; each device renders its
contiguous lane slice (scene arrays replicated), so forward accumulation is
local — the cross-device analogue of "each lane owns its pixel" needs no
collective until image assembly (an all-gather the partitioner inserts at
the output) and gradient reduction (an explicit psum here, the analogue of
the gradient all-reduce).
"""
from __future__ import annotations

from functools import partial
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jax import shard_map as _shard_map_fn


def shard_map(fn=None, **kw):
    """shard_map with varying-manual-axes checking off: the traversal
    while_loop mixes fresh (unvarying) carries with sharded ray data, which
    trips the vma consistency check although the program is correct."""
    kw.setdefault("check_vma", False)
    if fn is None:
        return lambda f: _shard_map_fn(f, **kw)
    return _shard_map_fn(fn, **kw)

from ..render.integrator import render_lanes, render_lanes_wavefront

AXIS = "shard"


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.asarray(devs[:n]), (AXIS,))


def _pad_to(n: int, m: int) -> int:
    return (n + m - 1) // m * m


@partial(jax.jit, static_argnames=("width", "height", "spp", "max_steps",
                                   "mesh", "k_volume"))
def render_sharded(scene: Dict, width: int, height: int, spp: int,
                   mesh: Mesh, seed=0, max_steps: int = 32,
                   k_volume: int = 0):
    """Mean radiance [H, W, 3], pixels sharded across `mesh`'s devices.

    k_volume threads the SSS walk budget through (same semantics as
    render(); callers should pass the CLI's auto-selected value so a
    sharded SSS render matches the single-chip one bit for bit)."""
    n_dev = mesh.devices.size
    n = width * height
    n_pad = _pad_to(n, n_dev)
    lanes = jnp.arange(n_pad, dtype=jnp.int32)
    lanes = jnp.minimum(lanes, n - 1)  # padded lanes re-render last pixel

    @partial(shard_map, mesh=mesh, in_specs=(P(), P(AXIS)), out_specs=P(AXIS))
    def one_pass_sharded(scene_rep, lane_slice):
        # persistent-lane refill wavefront per shard: the same loop body
        # as single-chip render() so sharded output stays bit-identical
        return render_lanes_wavefront(scene_rep, width, height, spp, seed,
                                      max_steps, lane_slice,
                                      k_volume=k_volume)

    acc = one_pass_sharded(scene, lanes)
    return acc[:n].reshape(height, width, 3) / spp


def train_step_builder(width: int, height: int, spp: int, mesh: Mesh,
                       max_steps: int = 8, lr: float = 0.05,
                       k_volume: int = 0):
    """Build a jitted differentiable-rendering training step.

    The "training" surface of the reference is its GUI edit loop mutating
    material parameters between passes (pc/pc-common.h EditQueue,
    SURVEY.md §3.3); here the same parameters are optimized by gradient
    descent against a target image: the canonical inverse-rendering loop.
    Gradients of the replicated parameters are psum-reduced across the mesh
    inside shard_map.
    """
    n_dev = mesh.devices.size
    n = width * height
    n_pad = _pad_to(n, n_dev)

    grad_keys = ("base_color", "subsurface_color", "subsurface_radius",
                 "roughness", "specular", "metallic")
    # scene-level differentiable leaves (BASELINE "material/light/texture"):
    # per-face emission and the texture atlas ride the same psum reduction
    scene_keys = ("face_emission", "texture_atlas")

    def train_step(scene, target):
        lanes0 = jnp.minimum(jnp.arange(n_pad, dtype=jnp.int32), n - 1)
        target_flat = target.reshape(-1, 3)
        target_pad = jnp.concatenate(
            [target_flat,
             jnp.broadcast_to(target_flat[-1:], (n_pad - n, 3))]) \
            if n_pad > n else target_flat

        @partial(shard_map, mesh=mesh,
                 in_specs=(P(), P(), P(AXIS), P(AXIS)),
                 out_specs=(P(), P()))
        def grad_shard(params, scene_rep, lane_slice, tgt_slice):
            def loss_fn(params):
                s = dict(scene_rep)
                m = dict(s["materials"])
                m.update(params["materials"])
                s["materials"] = m
                for k in scene_keys:
                    s[k] = params[k]

                def body(acc, sample_id):
                    c = render_lanes(s, width, height, sample_id, 0,
                                     max_steps, lane_slice, remat=True,
                                     k_volume=k_volume)
                    return acc + c, None

                acc, _ = jax.lax.scan(
                    body, jnp.zeros((lane_slice.shape[0], 3), jnp.float32),
                    jnp.arange(spp, dtype=jnp.uint32))
                img = acc / spp
                return jnp.sum((img - tgt_slice) ** 2)

            loss, grads = jax.value_and_grad(loss_fn)(params)
            # replicated-parameter gradient all-reduce over the pixel shards
            grads = jax.tree_util.tree_map(
                lambda g: jax.lax.psum(g, AXIS), grads)
            loss = jax.lax.psum(loss, AXIS)
            return loss, grads

        params = {"materials": {k: scene["materials"][k] for k in grad_keys}}
        params.update({k: scene[k] for k in scene_keys})
        loss, grads = grad_shard(params, scene, lanes0, target_pad)
        new_mats = dict(scene["materials"])
        for k in grad_keys:
            new_mats[k] = jnp.clip(
                params["materials"][k] - lr * grads["materials"][k], 0.0,
                None)
        new_scene = dict(scene)
        new_scene["materials"] = new_mats
        for k in scene_keys:
            new_scene[k] = jnp.clip(params[k] - lr * grads[k], 0.0, None)
        return loss, new_scene

    return jax.jit(train_step)
