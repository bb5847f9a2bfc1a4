"""Neural-net primitives: plain functions on tensors, and the modules that hold their
parameters under the JAX package's ``state_dict`` paths (``nn/layers.py`` there).

Activations are channels-last ``(batch, length, channels)`` at every public function,
as in the JAX package; weights keep torch layout, so ``conv1d`` transposes to torch's
``(B, C, L)`` inside. Only eval-mode semantics exist here (dropout is the identity,
BatchNorm normalizes with running statistics).

Random init draws from an explicit CPU ``torch.Generator`` with the same
distributions as the JAX initializers (torch defaults), so a seed gives one set of
weights whatever device the model is moved to afterwards.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


@contextlib.contextmanager
def strict_fp32():
    """Full float32 for matmuls and cuDNN convolutions inside the scope, restoring
    the caller's settings after. cuDNN convolutions default to TF32, which keeps
    about three decimal digits; the autoregressive head argmax turns such noise into
    discrete divergence, so the parity path runs in full float32.
    Usable as ``with strict_fp32():`` or as a decorator ``@strict_fp32()``."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


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


def batch_norm1d(x: torch.Tensor, running_mean: torch.Tensor, running_var: torch.Tensor,
                 weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Eval-mode BatchNorm1d over the last (channel) dim, on running statistics."""
    return (x - running_mean) * (torch.rsqrt(running_var + eps) * weight) + bias


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), weight, bias, eps)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)


def log_softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return F.log_softmax(x, dim=dim)


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
    ``num_batches_tracked`` (present in the JAX tree, unused at eval)."""

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return batch_norm1d(x, self.running_mean, self.running_var, self.weight, self.bias)


class LayerNorm(nn.Module):
    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias)


__all__ = [
    "BatchNorm1d",
    "Conv1d",
    "Embedding",
    "LayerNorm",
    "Linear",
    "batch_norm1d",
    "conv1d",
    "embedding",
    "layer_norm",
    "leaky_relu",
    "linear",
    "log_softmax",
    "normal",
    "strict_fp32",
    "uniform",
]
