"""Hand-written Hopper kernels (``csrc``) with their plain PyTorch versions.

Each wrapper launches its CUDA kernel for CUDA tensors and runs its plain
version for CPU tensors; it counts its launches in ``<wrapper>.launches``.
"""
