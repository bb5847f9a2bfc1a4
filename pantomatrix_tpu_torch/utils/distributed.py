"""Collectives of multi-process training, and the scope that tells the layers which rows
of the global batch this process holds.

Every collective here is an all-reduce or a broadcast. PyTorch's gloo backend serves only
these two for CUDA tensors, and NCCL serves them all, so one code path runs over NCCL
(one card a process), over gloo on the CPU, and over gloo with several processes sharing
one card. An all-gather is an all-reduce of a zero-filled buffer in which each process
writes its own block (exact, since x + 0 = x); a reduce-scatter is an all-reduce after
which each process keeps its block.

Inside :func:`batch_shard` the train-mode layers see the global batch (``nn/layers.py``):
BatchNorm reduces its statistics over every process, dropout draws its masks at the
global shape and keeps this process's rows, and the steps gather what couples the rows of
a batch (``train/steps.py``). Outside it, or with no process group, nothing is
communicated and the arithmetic is the single-process one.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class BatchShard:
    """This process's block of the global batch: rows ``[index * b, (index + 1) * b)`` of
    ``count * b``, the blocks spread over ``group`` in process order (the loaders' block
    order, ``data/beat2.py``). Every process holds the same number of rows."""

    group: Any
    index: int
    count: int


_local = threading.local()


@contextlib.contextmanager
def batch_shard(shard: Optional[BatchShard]):
    """The train-mode layers and the steps inside the scope treat their batch as this
    process's block of ``shard`` (None: the whole batch, one process)."""
    prev = getattr(_local, "shard", None)
    _local.shard = shard
    try:
        yield shard
    finally:
        _local.shard = prev


def current_batch_shard() -> Optional[BatchShard]:
    return getattr(_local, "shard", None)


class _AllReduceSum(torch.autograd.Function):
    """Sum over ``group``; the backward sums the gradient over it too, which is the
    gradient of the sum for each process's input."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the processes of ``group``, differentiable."""
    return _AllReduceSum.apply(x, group)


def all_reduce_mean(x: torch.Tensor, shard: Optional[BatchShard]) -> torch.Tensor:
    """The mean of ``x`` over the processes of ``shard`` (``x`` itself without one),
    differentiable. At one process it is bitwise ``x``: the sum is a copy and the
    division is by 1."""
    if shard is None:
        return x
    return all_reduce_sum(x, shard.group) / shard.count


def gather_rows(x: torch.Tensor, shard: Optional[BatchShard], dim: int = 0) -> torch.Tensor:
    """The global tensor of a row-split one: every process's ``x`` as block ``index``
    along ``dim``, in process order. Differentiable: a process's input receives the
    gradient of its block summed over the processes."""
    if shard is None:
        return x
    b = x.shape[dim]
    shape = list(x.shape)
    before, after = list(shape), list(shape)
    before[dim], after[dim] = shard.index * b, (shard.count - shard.index - 1) * b
    full = torch.cat([x.new_zeros(before), x, x.new_zeros(after)], dim)
    return all_reduce_sum(full, shard.group)


def local_rows(x: torch.Tensor, shard: Optional[BatchShard], dim: int = 0) -> torch.Tensor:
    """This process's block of a global tensor along ``dim``."""
    if shard is None:
        return x
    b = x.shape[dim] // shard.count
    return x.narrow(dim, shard.index * b, b)


def rand_rows(shape: Sequence[int], generator: torch.Generator, device,
              dim: int = 0) -> torch.Tensor:
    """``torch.rand(shape)`` for this process's rows of the current batch shard: the global
    shape (``shape[dim]`` times the process count) is drawn from ``generator`` and this
    process keeps its block, so every process draws what one process draws for the whole
    batch, and the generator advances alike everywhere."""
    shard = current_batch_shard()
    full = list(shape)
    if shard is not None:
        full[dim] *= shard.count
    return local_rows(torch.rand(full, generator=generator, device=device), shard, dim)


def flat_all_reduce(tensors: Sequence[torch.Tensor], group, divide: int = 1) -> int:
    """Sum ``tensors`` over ``group`` in place (then divide by ``divide``), through one
    flattened all-reduce per dtype. Returns the bytes reduced."""
    nbytes = 0
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.all_reduce(flat, group=group)
        if divide != 1:
            flat /= divide
        nbytes += flat.numel() * flat.element_size()
        off = 0
        for t in same:
            n = t.numel()
            t.copy_(flat[off:off + n].view_as(t))
            off += n
    return nbytes


__all__ = ["BatchShard", "all_reduce_mean", "all_reduce_sum", "batch_shard",
           "current_batch_shard", "flat_all_reduce", "gather_rows", "local_rows",
           "rand_rows"]
