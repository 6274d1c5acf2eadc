"""gprf_torch: Gaussian Process Random Fields on PyTorch and CUDA.

The port of ``gprf_tpu`` (JAX on a TPU) to one NVIDIA H100.  ``gprf_tpu``
stays the reference: every module here mirrors the module of the same path
there and is tested against it.  The batched Cholesky kernels of the hot
loop are hand-written CUDA (``gprf_torch/csrc``), built with ``nvcc`` at
first use; every kernel has a plain PyTorch twin that runs on the CPU.

Importing the package loads no submodule.  It pins float32 matrix products
to full precision (TF32 off): the Schur-complement algebra of the objective
must stay numerically positive definite, and TF32's ten-bit mantissa is
coarser than the reference's accuracy contract.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"
