"""Neural-net primitives: plain functions on tensors, and the modules that hold their
parameters under the JAX package's ``state_dict`` paths (``nn/layers.py`` there).

Activations are channels-last ``(batch, length, channels)`` at every public function,
as in the JAX package; weights keep torch layout, so ``conv1d`` transposes to torch's
``(B, C, L)`` inside (which PyTorch makes contiguous before cuDNN sees it). The WavEncoder
of the low-precision copy keeps its activations channels-last between its convs instead
(``nn/blocks.FoldedWavEncoder``).

Modes follow ``nn.Module.training``, but every module here is built in eval mode (the
inference paths never call ``.eval()``); ``model.train()`` turns training on. In eval
mode dropout is the identity and BatchNorm normalizes with its running statistics. In
train mode BatchNorm normalizes with the batch's statistics and updates its running ones
in place, and dropout draws its masks from the generator of the enclosing
:func:`dropout_rng` scope (a :class:`DropoutRng`, seeded by the caller), the counterpart
of the JAX package's ``Ctx``.

Random init draws from an explicit CPU ``torch.Generator`` with the same
distributions as the JAX initializers (torch defaults), so a seed gives one set of
weights whatever device the model is moved to afterwards.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.distributed import all_reduce_mean, current_batch_shard, rand_rows


@contextlib.contextmanager
def strict_fp32():
    """Float32 arithmetic for matmuls and cuDNN convolutions inside the scope, restoring
    the caller's settings after. cuDNN convolutions default to TF32, which keeps
    about three decimal digits; the autoregressive head argmax turns such noise into
    discrete divergence, so the parity path runs in full float32. bfloat16/float16
    matmuls accumulate in float32 too (cuBLAS may otherwise reduce split-K partial
    sums in the low precision), as the JAX package's do.
    Usable as ``with strict_fp32():`` or as a decorator ``@strict_fp32()``."""
    matmul = torch.backends.cuda.matmul
    prev = (matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            matmul.allow_bf16_reduced_precision_reduction,
            matmul.allow_fp16_reduced_precision_reduction)
    matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    matmul.allow_bf16_reduced_precision_reduction = False
    matmul.allow_fp16_reduced_precision_reduction = False
    try:
        yield
    finally:
        (matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         matmul.allow_bf16_reduced_precision_reduction,
         matmul.allow_fp16_reduced_precision_reduction) = prev


# ---------------------------------------------------------------------------
# plain functions
# ---------------------------------------------------------------------------

def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """torch nn.Linear: weight (out, in)."""
    return F.linear(x, weight, bias)


def embedding(ids: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Row lookup: weight (num, dim), ids (...) -> (..., dim)."""
    return F.embedding(ids, weight)


def conv1d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
           stride: int = 1, padding: int = 0) -> torch.Tensor:
    """torch nn.Conv1d on channels-last input with symmetric zero padding.

    x (B, L, Cin); weight (Cout, Cin, K) -> (B, Lout, Cout)."""
    y = F.conv1d(x.transpose(1, 2), weight, bias, stride=stride, padding=padding)
    return y.transpose(1, 2)


LOW_PRECISION = (torch.bfloat16, torch.float16)


def batch_norm1d(x: torch.Tensor, running_mean: torch.Tensor, running_var: torch.Tensor,
                 weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Eval-mode BatchNorm1d over the last (channel) dim, on running statistics.

    Under bfloat16/float16 activations the per-channel scale and shift are computed in
    float32 and applied in the activation dtype on every call, as the JAX package does.
    The low-precision copy's WavEncoder does not call this: its BatchNorms are folded
    into the convs before them once, when the copy is made (:func:`fold_batch_norm`)."""
    if x.dtype in LOW_PRECISION:
        scale = torch.rsqrt(running_var.float() + eps) * weight.float()
        shift = bias.float() - running_mean.float() * scale
        return x * scale.to(x.dtype) + shift.to(x.dtype)
    return (x - running_mean) * (torch.rsqrt(running_var + eps) * weight) + bias


def fold_batch_norm(conv: "Conv1d", bn: "BatchNorm1d"):
    """The float32 weight and bias of one conv equal to ``conv`` followed by ``bn`` in
    eval mode: ``w' = w * s`` and ``b' = (b - mean) * s + beta`` with
    ``s = gamma / sqrt(var + eps)``, computed from the modules' float32 tensors (the
    caller rounds the result once to its compute dtype)."""
    with torch.no_grad():
        scale = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
        weight = conv.weight.float() * scale[:, None, None]
        bias = (conv.bias.float() - bn.running_mean.float()) * scale + bn.bias.float()
    return weight, bias


def batch_norm1d_train(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                       eps: float = 1e-5):
    """Train-mode BatchNorm1d over the last (channel) dim: normalize with the biased
    batch statistics. Returns (y, mean, var); the statistics are reduced in float32 under
    bfloat16/float16 activations, with the two-pass variance, as in the JAX package's
    ``batch_norm1d`` with ``Ctx(train=True)``.

    Inside a :func:`~pantomatrix_tpu_torch.utils.distributed.batch_shard` scope the
    statistics are the global batch's: the mean and then the variance are each this
    process's mean all-reduced over the processes (equal blocks, so the mean of the
    means), through an all-reduce that carries the gradient."""
    low = x.dtype in LOW_PRECISION
    xf = x.float() if low else x
    dims = tuple(range(x.dim() - 1))
    shard = current_batch_shard()
    mean = all_reduce_mean(xf.mean(dims), shard)
    var = all_reduce_mean((xf - mean).square().mean(dims), shard)
    inv = torch.rsqrt(var + eps)
    if low:
        scale = inv * weight.float()
        shift = bias.float() - mean * scale
        return x * scale.to(x.dtype) + shift.to(x.dtype), mean, var
    return (x - mean) * (inv * weight) + bias, mean, var


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """torch nn.LayerNorm over the last dim. Under bfloat16/float16 activations torch's
    kernel computes the statistics and the affine in float32 and rounds the result
    once, which is the JAX package's explicit float32 form."""
    return F.layer_norm(x, (x.shape[-1],), weight, bias, eps)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)


def log_softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return F.log_softmax(x, dim=dim)


# ---------------------------------------------------------------------------
# train mode: dropout generators and BatchNorm running statistics
# ---------------------------------------------------------------------------

_local = threading.local()  # the current DropoutRng and the frozen-statistics flag


def mix_seed(*keys: int) -> int:
    """A 64-bit seed drawn from non-negative integer ``keys`` (numpy's SeedSequence), so
    that nearby keys such as (seed, iteration) give unrelated generators."""
    return int(np.random.SeedSequence([int(k) for k in keys]).generate_state(1, np.uint64)[0])


class DropoutRng:
    """A node of a tree of dropout generators. ``generator`` is a ``torch.Generator`` on
    ``device`` seeded with ``seed``; each ``split()`` gives a child with a seed of its
    own, in call order, like the JAX package's ``Ctx.next_rng`` fold-ins. The port cannot
    reproduce ``jax.random``'s bits and does not try; a seed gives the same masks on one
    device every time."""

    def __init__(self, seed: int, device="cpu"):
        self.seed, self.device = int(seed), torch.device(device)
        self._generator: Optional[torch.Generator] = None
        self._children = 0

    @property
    def generator(self) -> torch.Generator:
        if self._generator is None:
            self._generator = torch.Generator(self.device).manual_seed(self.seed)
        return self._generator

    def split(self) -> "DropoutRng":
        self._children += 1
        return DropoutRng(mix_seed(self.seed, self._children), self.device)


@contextlib.contextmanager
def dropout_rng(rng: Optional[DropoutRng]):
    """Train-mode dropout inside the scope draws from ``rng`` (per thread)."""
    prev = getattr(_local, "rng", None)
    _local.rng = rng
    try:
        yield rng
    finally:
        _local.rng = prev


def child_rng():
    """A scope whose dropout draws from a new child of the current generator: one per
    transformer stack, and one per layer of it (the JAX package's ``_layer_keys``).
    Nothing changes where no generator is set."""
    rng = getattr(_local, "rng", None)
    return dropout_rng(rng.split()) if rng is not None else contextlib.nullcontext()


def dropout(x: torch.Tensor, rate: float, training: bool, batch_dim: int = 0) -> torch.Tensor:
    """torch nn.Dropout: the identity in eval mode or at rate 0, else inverted scaling
    with a mask drawn from the current :func:`dropout_rng` generator (raises without
    one, as the JAX package raises without ``Ctx.rng``). Under a batch shard the mask is
    drawn for the global batch (``batch_dim`` the batch axis of ``x``) and this process
    keeps its rows (``utils/distributed.rand_rows``)."""
    if not training or rate == 0.0:
        return x
    rng = getattr(_local, "rng", None)
    if rng is None:
        raise ValueError("train-mode dropout needs a generator: run it inside "
                         "nn.layers.dropout_rng(DropoutRng(seed, device))")
    keep = 1.0 - rate
    mask = rand_rows(x.shape, rng.generator, x.device, batch_dim) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


@contextlib.contextmanager
def frozen_running_stats():
    """Train-mode BatchNorm inside the scope normalizes with batch statistics but leaves
    its running statistics alone: the recomputation of a checkpointed forward
    (``torch.utils.checkpoint``'s ``context_fn``) must not update them a second time."""
    prev = getattr(_local, "frozen", False)
    _local.frozen = True
    try:
        yield
    finally:
        _local.frozen = prev


# ---------------------------------------------------------------------------
# initializers (torch defaults, drawn from an explicit generator)
# ---------------------------------------------------------------------------

def uniform(shape, bound: float, generator: torch.Generator) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape).uniform_(-bound, bound, generator=generator))


def normal(shape, std: float, generator: torch.Generator) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape).normal_(0.0, std, generator=generator))


# ---------------------------------------------------------------------------
# parameter-holding modules
# ---------------------------------------------------------------------------

class Linear(nn.Module):
    """Keys ``weight`` (out, in) and ``bias``; default init U(+-1/sqrt(in))."""

    def __init__(self, in_dim: int, out_dim: int, *, generator: torch.Generator):
        super().__init__()
        bound = 1.0 / math.sqrt(in_dim)
        self.weight = uniform((out_dim, in_dim), bound, generator)
        self.bias = uniform((out_dim,), bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias)


class Embedding(nn.Module):
    """Key ``weight`` (num, dim); default init N(0, 1)."""

    def __init__(self, num: int, dim: int, *, generator: torch.Generator,
                 bound: Optional[float] = None):
        super().__init__()
        # the VQ quantizer draws its codebook from U(-bound, bound) instead
        self.weight = (normal((num, dim), 1.0, generator) if bound is None
                       else uniform((num, dim), bound, generator))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return embedding(ids, self.weight)


class Conv1d(nn.Module):
    """Keys ``weight`` (Cout, Cin, K) and ``bias``; channels-last forward.

    ``xavier=True`` is the VQ tokenizers' init (xavier-normal weight, zero bias);
    otherwise torch's default U(+-1/sqrt(Cin*K))."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, *, generator: torch.Generator,
                 stride: int = 1, padding: int = 0, xavier: bool = False):
        super().__init__()
        self.stride, self.padding = stride, padding
        shape = (out_ch, in_ch, kernel)
        if xavier:
            std = math.sqrt(2.0 / (in_ch * kernel + out_ch * kernel))
            self.weight = normal(shape, std, generator)
            self.bias = nn.Parameter(torch.zeros(out_ch))
        else:
            bound = 1.0 / math.sqrt(in_ch * kernel)
            self.weight = uniform(shape, bound, generator)
            self.bias = uniform((out_ch,), bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv1d(x, self.weight, self.bias, self.stride, self.padding)


class BatchNorm1d(nn.Module):
    """Keys ``weight``, ``bias``, ``running_mean``, ``running_var`` and
    ``num_batches_tracked``. Built in eval mode (running statistics); in train mode it
    normalizes with batch statistics and updates the running ones in place with momentum
    0.1 and the unbiased variance (float32 whatever the activation dtype), and counts
    the batch, unless inside :func:`frozen_running_stats`. Under a batch shard the
    statistics and the count are the global batch's (:func:`batch_norm1d_train`)."""

    momentum = 0.1
    eps = 1e-5

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return batch_norm1d(x, self.running_mean, self.running_var, self.weight, self.bias,
                                self.eps)
        y, mean, var = batch_norm1d_train(x, self.weight, self.bias, self.eps)
        if not getattr(_local, "frozen", False):
            shard = current_batch_shard()
            n = x.numel() // x.shape[-1] * (shard.count if shard is not None else 1)
            m = self.momentum
            with torch.no_grad():
                mean, unbiased = mean.detach(), var.detach() * (n / max(n - 1, 1))
                self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
                self.running_var.copy_((1 - m) * self.running_var + m * unbiased)
                self.num_batches_tracked.add_(1)
        return y


class LayerNorm(nn.Module):
    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias)


__all__ = [
    "BatchNorm1d",
    "DropoutRng",
    "Conv1d",
    "Embedding",
    "LayerNorm",
    "Linear",
    "batch_norm1d",
    "batch_norm1d_train",
    "child_rng",
    "conv1d",
    "dropout",
    "dropout_rng",
    "embedding",
    "fold_batch_norm",
    "frozen_running_stats",
    "layer_norm",
    "leaky_relu",
    "linear",
    "log_softmax",
    "mix_seed",
    "normal",
    "strict_fp32",
    "uniform",
]
