"""pbrlab_tpu — differentiable wavefront path tracer in JAX.

A from-scratch JAX/XLA re-architecture of lighttransport/pbrlab:
wavefront path tracing with threaded-BVH intersection, Cycles-compatible
Principled BSDF, random-walk SSS, Principled Hair BSDF, NEE/MIS area lights,
textures, and multi-chip sharding. See SURVEY.md for the reference map.
"""

__version__ = "0.1.0"
