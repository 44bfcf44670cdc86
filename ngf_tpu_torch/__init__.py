"""PyTorch/CUDA port of ngf_tpu (Neural Gauge Fields) for NVIDIA Hopper.

Mirrors the `ngf_tpu` subpackages; imports neither JAX nor `ngf_tpu`.
Slice 1: render-only evaluation (`main_torch.py`), with the hand-written
CUDA kernel `ops/kernels/bilinear_gather.cu` on every tri-plane fetch.
Slice 2: dense InfoInv training (`train/`), with the CUDA kernels
`ops/kernels/bilinear_gather_backward.cu` (the fetch's plane gradient) and
`ops/kernels/gather_rows.cu` (batch assembly).
"""
