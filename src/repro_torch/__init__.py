"""PyTorch + CUDA port of the TIDAL serving system for NVIDIA Hopper.

The package mirrors ``repro``'s layout (``models/``, ``kernels/``,
``runtime/``, ``configs/``) and imports nothing of it: the JAX package is
the reference the port is tested against, not a dependency.  Attention on
the serving path runs hand-written CUDA kernels (``csrc/``) on a CUDA
device and their plain PyTorch versions on the CPU.
"""
