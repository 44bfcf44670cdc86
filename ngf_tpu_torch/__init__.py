"""PyTorch/CUDA port of ngf_tpu (Neural Gauge Fields) for NVIDIA Hopper.

Mirrors the `ngf_tpu` subpackages; imports neither JAX nor `ngf_tpu`.
Slice 1: render-only evaluation (`main_torch.py`), with the hand-written
CUDA kernel `ops/kernels/bilinear_gather.cu` on every tri-plane fetch.
Slice 2: dense InfoInv training (`train/`), with the CUDA kernels
`ops/kernels/bilinear_gather_backward.cu` (the fetch's plane gradient) and
`ops/kernels/gather_rows.cu` (batch assembly). Later slices: the staged
and learned-gauge tri-plane recipes (K3, K4, K2c) and bfloat16 training.
And the UV-Mapping (NeuTex) subsystem (`fields/neutex.py`,
`train/uv_loop.py`, `data/dtu.py`; CLIs `uv_train_torch.py` and
`uv_test_torch.py`), with the compositing scan K5 `ops/kernels/ray_march.cu`.
Then tri-plane training resume (`--ckpt` in training mode, SIGTERM saving,
background periodic saves) and the Blender loader (`data/blender.py`), the
parallel modes (`parallel/`), top-K shading and the other loaders. And the
I/O tail: the mesh export (`utils/marching_cubes.py`, `utils/viz.py`),
LPIPS (`utils/lpips.py`), evaluation videos, PFM files and profiling, the
UV ray functions (`ops/rays.py`) and the UV trainer's data mesh.
"""
