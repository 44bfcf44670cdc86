"""PyTorch/CUDA port of ngf_tpu (Neural Gauge Fields) for NVIDIA Hopper.

Mirrors the `ngf_tpu` subpackages; imports neither JAX nor `ngf_tpu`.
Slice 1: render-only evaluation (`main_torch.py`), with the hand-written
CUDA kernel `ops/kernels/bilinear_gather.cu` on every tri-plane fetch.
"""
