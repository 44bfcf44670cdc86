"""Core math ops: encodings, grid sampling, ray sampling, compositing, and
the hand-written CUDA kernels (`cuda_kernels.py`)."""

from .rays import sample_pdf

__all__ = ["sample_pdf"]
