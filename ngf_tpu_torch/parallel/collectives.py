"""Collectives with the gradients the parallel modes need.

JAX gets these from ``shard_map``'s transposes; here they are two
``autograd.Function``s whose backward is right for a loss that every rank of
the sample group holds whole (after :func:`psum_replicated`, each of them
computes the same loss from the same sums):

- :func:`psum_replicated`: forward the sum over the group, backward the
  identity. (``torch.distributed.nn.functional.all_reduce`` sums the
  cotangents over the group in its backward, which would count a replicated
  loss once per rank.)
- :func:`all_gather_totals`: forward the (m, n) stack of every rank's
  (n,) row, as an all-reduce SUM of a zero stack with this rank's row
  filled (gloo reduces CUDA tensors); backward the sum of the stack's
  cotangents over the group, this rank's row.

And the trainers' :func:`broadcast_from_rank0` (every rank starts from rank
0's parameters) and host-side agreement :func:`any_rank` (a MAX all-reduce
of a flag).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class _PsumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def psum_replicated(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``group``; the gradient passes through
    unchanged, for a loss that every rank of the group holds whole."""
    return _PsumReplicated.apply(x, group)


class _AllGatherTotals(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        m, r = dist.get_world_size(group), dist.get_rank(group)
        stack = x.new_zeros((m, *x.shape))
        stack[r] = x
        dist.all_reduce(stack, op=dist.ReduceOp.SUM, group=group)
        ctx.group, ctx.r = group, r
        return stack

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g[ctx.r], None


def all_gather_totals(x: torch.Tensor, group) -> torch.Tensor:
    """(m, ...) stack of every rank's ``x`` over ``group`` (m ranks), in
    rank order; the gradient of this rank's ``x`` is the sum of every rank's
    cotangent of its row."""
    return _AllGatherTotals.apply(x, group)


def _flag_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def any_rank(flag: bool) -> bool:
    """True on every rank when ``flag`` is True on any (a MAX all-reduce
    over the world)."""
    t = torch.tensor([int(flag)], dtype=torch.int32, device=_flag_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def broadcast_from_rank0(tensors) -> None:
    """Every rank's ``tensors`` take rank 0's values, in place: one broadcast
    of a flat buffer (the same tensors, in the same order, on every rank)."""
    tensors = list(tensors)
    with torch.no_grad():
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.broadcast(flat, src=0)
        for t, v in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.copy_(v.view_as(t))
