"""PyTorch/CUDA port of the hybrid CPU+GPU work-sharing reproduction.

Mirrors the layout of the JAX package ``repro`` (``core/``,
``kernels/<name>/``, ``obs/``, ``workloads/``) with the same public
names, but imports neither JAX nor ``repro``: the accelerator is an
NVIDIA GPU running hand-written CUDA kernels (``csrc/``) and the host
is the CPU running PyTorch's own CPU operators.
"""
