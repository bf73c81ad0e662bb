"""Branchless orthonormal basis + frame transforms, vectorized over lanes.

Reference: Pixar BranchlessONB and the global<->shading-local rotations in
/root/reference/src/shader/shader-utils.h:44-114. Instead of 4x4 matrices we
keep the three basis vectors and transform with dot products (3 fused
multiply-adds per component).
"""
from __future__ import annotations

import jax.numpy as jnp

from .math import vdot


def branchless_onb(n):
    """Build (ex, ey) given unit normals n [..., 3] (Pixar, Duff et al. 2017)."""
    sign = jnp.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    ex = jnp.stack(
        [1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b, -sign * n[..., 0]],
        axis=-1,
    )
    ey = jnp.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], axis=-1)
    return ex, ey


def to_local(v, ex, ey, ez):
    """Global -> shading-local (shader-utils.h GrobalToShadingLocal)."""
    return jnp.stack([vdot(v, ex), vdot(v, ey), vdot(v, ez)], axis=-1)


def to_global(v, ex, ey, ez):
    """Shading-local -> global (shader-utils.h ShadingLocalToGlobal)."""
    return (
        v[..., 0:1] * ex + v[..., 1:2] * ey + v[..., 2:3] * ez
    )
