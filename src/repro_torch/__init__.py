"""PyTorch/CUDA port of ``repro``: the same analytical GEMM selector driving
hand-written Hopper kernels (``csrc/``), with the serving path around them.

Layout mirrors the JAX package module for module (``core``, ``obs``,
``runtime``, ``nn``, ``kernels``, ``launch``, ``configs``).  Nothing here
imports JAX or the ``repro`` package; the numpy-only modules are copies,
held to the originals by golden-parity tests.
"""
