"""Per-lane counter-seeded PCG random number generation.

The reference uses stateful 64-bit PCG32, one generator per render *thread*
seeded (thread_id, 1234567890) (/root/reference/src/random/rng.h:9-69,
src/render.cc:215) — which makes its images thread-schedule dependent. This
design instead carries one 32-bit PCG state *per wavefront lane*,
deterministically seeded from (pixel_id, sample_id, stream seed): the same
seed reproduces bit-exact images across any sharding layout, which is what
gradient replay requires.

The generator is the 32-bit PCG-RXS-M-XS-style hash of Jarzynski & Olano,
"Hash Functions for GPU Rendering" (JCGT 2020) — the standard per-lane PCG
for GPU renderers. Draw output uses the same mantissa bit-trick as the
reference Draw() (rng.h:52-65): (word >> 9) | 0x3f800000 reinterpreted as
float minus 1.0 -> uniform [0, 1).

All functions operate on uint32 arrays of any shape (one state per lane) and
are stateless: `state, u = draw(state)`.
"""
from __future__ import annotations

import jax.numpy as jnp

# numpy scalars (not jnp): jnp module-level constants would be committed to
# the default device and captured as device constants at every trace.
import numpy as np

_MULT = np.uint32(747796405)
_INC = np.uint32(2891336453)
_OUT_MULT = np.uint32(277803737)
_GOLDEN = np.uint32(0x9E3779B9)


def _pcg_out(state):
    """PCG output permutation on a uint32 state."""
    word = ((state >> ((state >> np.uint32(28)) + np.uint32(4))) ^ state) * _OUT_MULT
    return (word >> np.uint32(22)) ^ word


def hash_u32(x):
    """One full PCG round used as an integer hash (advance + permute)."""
    x = jnp.asarray(x).astype(jnp.uint32)
    return _pcg_out(x * _MULT + _INC)


def seed_state(pixel_id, sample_id, seed=0):
    """Build decorrelated per-lane states from (pixel, sample, seed) keys."""
    pixel_id = jnp.asarray(pixel_id).astype(jnp.uint32)
    sample_id = jnp.asarray(sample_id).astype(jnp.uint32)
    seed = jnp.asarray(seed).astype(jnp.uint32)
    h = hash_u32(pixel_id ^ (seed * _GOLDEN))
    h = hash_u32(h ^ (sample_id * np.uint32(0x85EBCA6B)))
    return h


def next_state(state):
    return state * _MULT + _INC


def draw(state):
    """Advance each lane and return (new_state, uniform in [0, 1))."""
    from jax import lax

    state = next_state(state)
    word = _pcg_out(state)
    bits = (word >> np.uint32(9)) | np.uint32(0x3F800000)
    u = lax.bitcast_convert_type(bits, jnp.float32) - 1.0
    return state, u


def draw_n(state, n):
    """Draw n uniforms per lane; returns (state, [n] list of arrays)."""
    us = []
    for _ in range(n):
        state, u = draw(state)
        us.append(u)
    return state, us
