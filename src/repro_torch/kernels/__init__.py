"""Hand-written Hopper kernels for the USEC hot loop and the model stack,
with plain versions.

  usec_matvec     -- block-row matvec/matmat (csrc/usec_matvec.cu)
  usec_segmented  -- every worker's block list in one launch
                     (csrc/usec_segmented.cu)
  flash_attention -- online-softmax attention over KV tiles, the model
                     stack's long-sequence attention: bf16 on the tensor
                     cores (csrc/flash_attention_tc.cu), fp32 in FFMA
                     (csrc/flash_attention.cu)
  tile_checksum   -- zlib's CRC32 of every staged tile in one launch, the
                     integrity audit of the card's copy
                     (csrc/tile_checksum.cu)

``ops`` holds the public wrappers (dispatch by device: the kernel for CUDA
tensors, the plain version for CPU tensors); ``ref`` holds the plain PyTorch
versions. The CUDA sources are built with ``nvcc`` at first use
(:mod:`._build`), never at import.
"""

from .ops import (
    executor_matmul,
    flash_attention,
    tile_checksum,
    usec_matmat,
    usec_matvec,
    usec_segmented,
)

__all__ = ["executor_matmul", "flash_attention", "tile_checksum", "usec_matmat",
           "usec_matvec", "usec_segmented"]
