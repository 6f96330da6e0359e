"""Hand-written Hopper kernels for the USEC hot loop and the model stack,
with plain versions.

  usec_matvec     -- block-row matvec/matmat (csrc/usec_matvec.cu)
  usec_segmented  -- every worker's block list in one launch
                     (csrc/usec_segmented.cu)
  flash_attention -- online-softmax attention over KV tiles, the model
                     stack's long-sequence attention (csrc/flash_attention.cu)

``ops`` holds the public wrappers (dispatch by device: the kernel for CUDA
tensors, the plain version for CPU tensors); ``ref`` holds the plain PyTorch
versions. The CUDA sources are built with ``nvcc`` at first use
(:mod:`._build`), never at import.
"""

from .ops import (
    executor_matmul,
    flash_attention,
    usec_matmat,
    usec_matvec,
    usec_segmented,
)

__all__ = ["executor_matmul", "flash_attention", "usec_matmat", "usec_matvec",
           "usec_segmented"]
