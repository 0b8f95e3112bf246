"""tpu_raytracer: a real-time ReSTIR path tracer in JAX.

From-scratch rebuild of the capabilities of kokutoupan/fast-raytracing-wgpu
(ReSTIR path tracing, NEE+MIS, GGX/Lambert/glass BSDFs, glTF scenes,
TAA/accumulation post pipeline, async screenshots) on its own software
intersection stack: a fused Moller-Trumbore sweep and a stackless BVH
walk instead of hardware ray queries, wavefront shading under jit, and
screen-tile sharding over a device mesh.
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# Geometry math needs true f32: a float32 matmul may otherwise run in
# TF32 on the GPU (about three decimal digits), which breaks the camera's
# inverse-projection w cancellation and makes the one-hot gathers
# (ops/hit.fetch_cols) inexact.
_jax.config.update("jax_default_matmul_precision", "highest")

# Persistent compile cache: where JAX_COMPILATION_CACHE_DIR says (JAX
# reads the variable itself), else a fixed .jax_cache/ at the checkout
# root - a fixed path, since the path is part of the cache key.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(_os.path.dirname(_os.path.dirname(
            _os.path.abspath(__file__))), ".jax_cache"))
