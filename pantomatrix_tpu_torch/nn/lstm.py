"""Bidirectional multi-layer LSTM (counterpart of ``pantomatrix_tpu/nn/lstm.py``),
matching ``torch.nn.LSTM`` in gates and names.

As in the JAX package, the input projection ``x @ W_ih^T + (b_ih + b_hh)`` of the whole
sequence is one matmul outside the recurrence: here one matmul per layer, against both
directions' input weights stacked, on the unflipped sequence. Both recurrences of the
layer then run in one ``ops/lstm_cuda.lstm_bidirectional`` call (one launch of kernel
K2 on a CUDA tensor), which reads the reverse direction's steps back to front and
writes its states in place, so nothing is flipped or concatenated. Parameters keep
torch's names: ``weight_ih_l{k}[_reverse]``, ``weight_hh_l{k}[_reverse]``,
``bias_ih_l{k}[_reverse]``, ``bias_hh_l{k}[_reverse]``. In train mode dropout at
``dropout`` follows every layer but the last, as in torch; where a gradient is wanted
on the card, K2 runs under autograd (``ops/lstm_cuda.LstmLayerFunction``: the kernel
forward, a backward through the plain recurrence), and the gradients of ``weight_ih``
and the biases come through the input projection's matmul.

Under bfloat16 (the serving mode's ``compute_dtype``) the input projection is a bfloat16
matmul, as in the JAX package, but K2 takes float32 only: x_proj and the
bfloat16-valued W_hh are upcast exactly, the recurrence runs in float32 and each layer's
output is cast back to bfloat16 (the casts are differentiable). The weights are the same
bfloat16 values as the JAX package's; the one difference is the recurrence state, which
the JAX scan carries in bfloat16 (``pantomatrix_tpu/nn/lstm.py``) and which here is
float32, so more precise.

Each layer, its projection, upcasts, K2 and cast back, is one ``lstm.layer`` span
(``utils/trace.py``), which records only under a profiler.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.lstm_cuda import lstm_bidirectional
from ..utils import trace
from .layers import dropout, uniform

SUFFIXES = ("", "_reverse")  # forward, then backward direction


class LSTM(nn.Module):
    """Bidirectional: (B, T, C) -> (B, T, 2H), forward then backward states; init
    U(+-1/sqrt(H))."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int, *,
                 generator: torch.Generator, dropout: float = 0.0):
        super().__init__()
        self.hidden_size, self.num_layers, self.dropout = hidden_size, num_layers, dropout
        bound = 1.0 / math.sqrt(hidden_size)
        four_h = 4 * hidden_size
        for layer in range(num_layers):
            in_dim = input_size if layer == 0 else 2 * hidden_size
            for sfx in SUFFIXES:
                setattr(self, f"weight_ih_l{layer}{sfx}",
                        uniform((four_h, in_dim), bound, generator))
                setattr(self, f"weight_hh_l{layer}{sfx}",
                        uniform((four_h, hidden_size), bound, generator))
                setattr(self, f"bias_ih_l{layer}{sfx}", uniform((four_h,), bound, generator))
                setattr(self, f"bias_hh_l{layer}{sfx}", uniform((four_h,), bound, generator))
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.transpose(0, 1)  # (T, B, C)
        t, b = y.shape[:2]
        for layer in range(self.num_layers):
            p = lambda name: [getattr(self, f"{name}_l{layer}{sfx}") for sfx in SUFFIXES]
            with trace.span("lstm.layer", y, layer=layer, t=t, b=b):
                w_ih = torch.cat(p("weight_ih"))  # (8H, C): forward rows, then reverse rows
                bias = torch.cat(p("bias_ih")) + torch.cat(p("bias_hh"))
                x_proj = torch.matmul(y, w_ih.T) + bias  # (T, B, 8H)
                # K2 takes float32: low-precision values are upcast exactly, and the
                # layer's output is cast back (both no-ops in float32)
                w_hh = torch.stack(p("weight_hh")).float()
                y = lstm_bidirectional(x_proj.float(), w_hh,
                                       self.hidden_size).to(x_proj.dtype)
            if layer < self.num_layers - 1:
                y = dropout(y, self.dropout, self.training, batch_dim=1)
        return y.transpose(0, 1)


__all__ = ["LSTM"]
