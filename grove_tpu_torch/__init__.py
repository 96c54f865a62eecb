"""PyTorch/CUDA port of grove_tpu's serving path for NVIDIA Hopper.

The JAX package ``grove_tpu`` is the reference; this package mirrors its
layout (``ops/``, ``models/``, ``serving/``, ``parallel/``) and names,
imports neither it nor JAX, and runs its entry points on the card unless
the caller passes ``device="cpu"``. Hand-written CUDA kernels live in ``csrc/`` and are built
at first use (``ops/_build.py``).
"""
