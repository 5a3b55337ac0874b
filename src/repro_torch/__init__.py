"""PyTorch/CUDA port of the crowdsourced-join system in ``repro``.

The JAX package ``repro`` is the reference; this package imports neither it
nor jax.  Entry points run on the CUDA device unless the caller passes
``device="cpu"``.  What is ported so far is listed in ROADMAP.md.
"""
from .device import warm_cpu_math

# before any multi-threaded elementwise call of this process (ROADMAP C11)
warm_cpu_math()
