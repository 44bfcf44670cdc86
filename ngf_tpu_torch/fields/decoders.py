"""MLP decoders as nested dicts of tensors plus apply functions.

Port of `ngf_tpu/fields/decoders.py:31-140` (reference
`InfoInv/models/networks.py:12-54`). Weights are (in, out) and the tree
names are the JAX package's (``{'w', 'b'}`` per layer, ``mlp/layers/<i>``),
so one checkpoint loads in both packages.

Init follows torch semantics from a ``torch.Generator``: ``nn.Linear``'s
default (weights and bias uniform in +-1/sqrt(fan_in)) or xavier-uniform
(bound = sqrt(6/(fan_in+fan_out))). The draws differ from the JAX
package's; the distributions are the same.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from ..ops.encoding import positional_encoding

Params = dict[str, Any]


def _uniform(gen, shape, bound, device) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=device)
    return (2.0 * u - 1.0) * bound


def init_linear(
    gen: torch.Generator,
    in_dim: int,
    out_dim: int,
    init: str = "torch",
    zero_bias: bool = False,
    bias: bool = True,
    device: torch.device | str | None = None,
    gain: float = 1.0,
) -> Params:
    """One float32 linear layer: {'w': (in, out), 'b': (out,)?}
    (`ngf_tpu/fields/decoders.py:31-60`); ``init`` is 'torch' or
    'xavier_uniform' (bound ``gain * sqrt(6 / (in + out))``; NeuTex's
    layers take sqrt(2) before a ReLU and sqrt(2 / 1.04) before a leaky
    ReLU). ``device`` None is the generator's, as in every initialiser
    here."""
    device = gen.device if device is None else device
    if init == "torch":
        bound = 1.0 / math.sqrt(in_dim)
    elif init == "xavier_uniform":
        bound = gain * math.sqrt(6.0 / (in_dim + out_dim))
    else:
        raise ValueError(f"unknown init {init!r}")
    p: Params = {"w": _uniform(gen, (in_dim, out_dim), bound, device)}
    if bias:
        if zero_bias:
            p["b"] = torch.zeros((out_dim,), device=device)
        else:
            p["b"] = _uniform(gen, (out_dim,), 1.0 / math.sqrt(in_dim), device)
    return p


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The float32 product of two bfloat16 matrices, accumulated in float32
    and not rounded: cuBLAS's ``out_dtype`` product on the card; on the CPU,
    which has no such kernel, the product of the float32 copies (each
    bfloat16 product is exact in float32, so the two differ only in the
    order of the float32 sums)."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _LowPrecisionLinear(torch.autograd.Function):
    """``x @ w + b`` of bfloat16 ``x``, ``w`` and ``b`` as
    ``jnp.dot(x, w, preferred_element_type=float32) + b`` computes it, and
    its vjp: the product kept in float32, the bias added in float32, one
    rounding to bfloat16. Backward, the cotangent's products with ``w`` and
    ``x`` each in float32 and rounded once to bfloat16, and the bias's the
    float32 sum of the cotangent rounded once, as JAX's transposes of the
    dot and of the casts give them. ``torch.mm``'s ``out_dtype`` product has
    no derivative of its own, hence this Function."""

    @staticmethod
    def forward(ctx, x, w, b):
        x2 = x.reshape(-1, x.shape[-1])
        y = _mm_f32(x2, w)
        if b is not None:
            y = y + b.float()
        ctx.save_for_backward(x2, w)
        ctx.has_bias, ctx.in_shape = b is not None, x.shape
        return y.to(x.dtype).reshape(*x.shape[:-1], w.shape[1])

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = _mm_f32(g2, w.t()).to(w.dtype).reshape(ctx.in_shape)
        if ctx.needs_input_grad[1]:
            dw = _mm_f32(x2.t(), g2).to(w.dtype)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = g2.float().sum(0).to(w.dtype)
        return dx, dw, db


def apply_linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x @ w + b in the weights' dtype (`ngf_tpu/fields/decoders.py:63-70`).

    The input is cast to the weights' dtype. Float32 weights: the float32
    product plus the bias (no TF32: `main_torch.py` and the trainer keep
    float32 products in full float32). bfloat16 weights (the bfloat16
    recipe's ``_cast``): the product of the bfloat16 inputs kept in float32,
    the float32 bias added, one rounding to bfloat16, as the JAX layer's
    ``preferred_element_type=float32`` dot has it, forward and backward
    (:class:`_LowPrecisionLinear`). On the card that is cuBLAS's bfloat16
    product with a float32 output (``torch.mm(..., out_dtype=float32)``), on
    the CPU the product of float32 copies; both sum in float32.
    """
    x = x.to(p["w"].dtype)
    if x.dtype == torch.float32:
        y = x @ p["w"]
        return y + p["b"] if "b" in p else y
    return _LowPrecisionLinear.apply(x, p["w"], p.get("b"))


def init_mlp(gen: torch.Generator, dims: list[int], device: torch.device | str | None = None) -> Params:
    """Sequential linear stack with torch init and a zero last bias
    (`ngf_tpu/fields/decoders.py:73-96`)."""
    layers = []
    for i, (d0, d1) in enumerate(zip(dims[:-1], dims[1:])):
        layers.append(init_linear(gen, d0, d1, zero_bias=i == len(dims) - 2, device=device))
    return {"layers": layers}


def apply_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    """ReLU between layers, none after the last."""
    layers = p["layers"]
    for lp in layers[:-1]:
        x = torch.relu(apply_linear(lp, x))
    return apply_linear(layers[-1], x)


def init_rgb_decoder(
    gen: torch.Generator,
    feat_dim: int,
    view_pe: int = 6,
    middle_dim: int = 128,
    device: torch.device | str | None = None,
) -> Params:
    """`rgb_decoder.__init__` (`ngf_tpu/fields/decoders.py:106-119`)."""
    input_dim = feat_dim + 3 + 2 * view_pe * 3
    return {
        "basis": init_linear(gen, feat_dim, feat_dim, bias=False, device=device),
        "mlp": init_mlp(gen, [input_dim, middle_dim, middle_dim, 3], device=device),
    }


def apply_rgb_decoder(
    p: Params, features: torch.Tensor, view_dirs: torch.Tensor, view_pe: int
) -> torch.Tensor:
    """`rgb_decoder.forward` (`ngf_tpu/fields/decoders.py:122-130`)."""
    features = apply_linear(p["basis"], features)
    mlp_in = torch.cat(
        [features, view_dirs, positional_encoding(view_dirs, view_pe)], dim=-1
    )
    return torch.sigmoid(apply_mlp(p["mlp"], mlp_in))


def init_density_decoder(
    gen: torch.Generator, feat_dim: int, middle_dim: int = 32, device: torch.device | str | None = None
) -> Params:
    """`density_decoder.__init__` (`ngf_tpu/fields/decoders.py:133-135`)."""
    return {"mlp": init_mlp(gen, [feat_dim, middle_dim, middle_dim, 1], device=device)}


def apply_density_decoder(p: Params, features: torch.Tensor) -> torch.Tensor:
    """Raw density feature, no activation (`ngf_tpu/fields/decoders.py:138-140`)."""
    return apply_mlp(p["mlp"], features)
