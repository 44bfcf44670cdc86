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
) -> Params:
    """One float32 linear layer: {'w': (in, out), 'b': (out,)?}
    (`ngf_tpu/fields/decoders.py:31-60`); ``init`` is 'torch' or
    'xavier_uniform' (gain 1). ``device`` None is the generator's, as in
    every initialiser here."""
    device = gen.device if device is None else device
    if init == "torch":
        bound = 1.0 / math.sqrt(in_dim)
    elif init == "xavier_uniform":
        bound = math.sqrt(6.0 / (in_dim + out_dim))
    else:
        raise ValueError(f"unknown init {init!r}")
    p: Params = {"w": _uniform(gen, (in_dim, out_dim), bound, device)}
    if bias:
        if zero_bias:
            p["b"] = torch.zeros((out_dim,), device=device)
        else:
            p["b"] = _uniform(gen, (out_dim,), 1.0 / math.sqrt(in_dim), device)
    return p


def apply_linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x @ w + b in the weights' dtype (`ngf_tpu/fields/decoders.py:63-70`).

    The input is cast to the weights' dtype; the bias is added in float32
    and the result cast back. (A bfloat16 product is rounded to bfloat16
    before the bias here, where XLA keeps it in float32.)
    """
    x = x.to(p["w"].dtype)
    y = x @ p["w"]
    if "b" in p:
        y = y.float() + p["b"].float()
    return y.to(x.dtype)


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
