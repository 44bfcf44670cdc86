"""The float32 accumulation of the port's matrix products."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def float32_accumulation():
    """Products inside sum in float32, as the JAX package's do (XLA keeps
    float32 sums, and its bfloat16 layers ask for float32 results): no TF32
    for float32 products, and no bfloat16 reduction of a bfloat16 product's
    partial sums in cuBLAS (``allow_bf16_reduced_precision_reduction``, True
    by default). The switches are process-wide: they are set on entry and
    their earlier values restored on exit. Also a decorator."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (matmul.allow_tf32, cudnn.allow_tf32, matmul.allow_bf16_reduced_precision_reduction)
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        (matmul.allow_tf32, cudnn.allow_tf32,
         matmul.allow_bf16_reduced_precision_reduction) = saved
