"""PyTorch/CUDA port of the ``repro`` serving stack for NVIDIA Hopper.

The package mirrors ``src/repro/`` module by module. It imports ``torch``
and numpy, never JAX and nothing of the JAX package: what it needs from
there (configs, telemetry) it keeps as its own copy. The attention kernels
are hand-written CUDA C++ for ``sm_90a`` (``kernels/csrc``), built with
``nvcc`` at first use and bound with ``ctypes``.
"""
