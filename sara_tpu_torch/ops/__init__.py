"""Device-op layer: top-k and the hand-written CUDA kernels.

Twin of ``sara_tpu/ops``. Each CUDA kernel lives in ``csrc/`` with its
wrapper and plain PyTorch version in the module of the same name; ``_build``
compiles the sources with nvcc at first use.
"""
