"""PyTorch/CUDA port of the lazy-copy platform.

The JAX package ``repro`` is the reference; this package mirrors its
layout (``core/``, ``smc/``, ``kernels/<op>/{ops,ref}.py``) and imports
nothing from it and nothing of jax.  The Pallas kernels on the particle
filter's path are hand-written CUDA C++ for Hopper (``csrc/*.cu``),
built with ``nvcc`` at first use (:mod:`repro_torch.kernels._build`).

Device policy: entry points (``core.store.create``,
``smc.filters.ParticleFilter``) default to ``device="cuda"`` and raise
when no GPU is present.  A kernel wrapper given CUDA tensors launches
its kernel or raises; given CPU tensors it runs the plain PyTorch
version beside it (``ref.py``).  There is no silent fallback.
"""
