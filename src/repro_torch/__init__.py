"""PyTorch/CUDA port of the ``repro`` serving stack for NVIDIA Hopper.

The package mirrors ``src/repro/`` module by module. It imports ``torch``
and numpy, never JAX and nothing of the JAX package: what it needs from
there (configs, the numpy AdaOper core) it keeps as its own copy. The
kernels (prefill and decode attention, the SSD chunked scan) are
hand-written CUDA C++ for ``sm_90a`` (``kernels/csrc``), built with ``nvcc``
at first use and bound with ``ctypes``.
"""
