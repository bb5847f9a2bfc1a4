"""Post-norm transformer layers matching torch ``nn.Transformer*Layer`` (counterpart of
``pantomatrix_tpu/nn/attention.py``).

Keys mirror the JAX param tree: ``self_attn.{in_proj_weight,in_proj_bias,out_proj.*}``,
``multihead_attn.*`` (decoder), ``linear1/linear2``, ``norm1/2/3`` and ``layers.{i}``
for the stacks. Tensors are batch-first (B, T, E). Sequences are 64 tokens, so the
attention is plain batched matmuls and a softmax.

In train mode (``module.train()``) dropout at ``dropout`` applies where torch's layers
apply it: to the attention weights, to each sublayer's output before its residual add,
and inside the feed-forward block. Each stack draws from a child of the current
generator, and each of its layers from a child of that (``nn.layers.child_rng``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .layers import LayerNorm, Linear, child_rng, dropout, linear, uniform


class MultiheadAttention(nn.Module):
    """torch nn.MultiheadAttention with the packed (3E, E) ``in_proj_weight``."""

    def __init__(self, embed_dim: int, num_heads: int, *, generator: torch.Generator,
                 dropout: float = 0.1):
        super().__init__()
        self.num_heads, self.dropout = num_heads, dropout
        # xavier-uniform packed projection, zero biases, Linear-default out weight
        self.in_proj_weight = uniform((3 * embed_dim, embed_dim),
                                      math.sqrt(6.0 / (4 * embed_dim)), generator)
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = Linear(embed_dim, embed_dim, generator=generator)
        with torch.no_grad():
            self.out_proj.bias.zero_()
        self.eval()

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor) -> torch.Tensor:
        E = query.shape[-1]
        H = self.num_heads
        Dh = E // H
        w_q, w_k, w_v = self.in_proj_weight.chunk(3, dim=0)
        b_q, b_k, b_v = self.in_proj_bias.chunk(3, dim=0)

        def heads(t: torch.Tensor) -> torch.Tensor:
            B, T, _ = t.shape
            return t.reshape(B, T, H, Dh).transpose(1, 2)  # (B, H, T, Dh)

        q = heads(linear(query, w_q, b_q))
        k = heads(linear(key, w_k, b_k))
        v = heads(linear(value, w_v, b_v))
        # under bfloat16 scores torch's softmax computes in float32 and rounds once,
        # which is the JAX package's explicit float32 softmax
        attn = torch.softmax((q @ k.transpose(-1, -2)) / math.sqrt(Dh), dim=-1)
        attn = dropout(attn, self.dropout, self.training)
        out = attn @ v  # (B, H, Tq, Dh)
        B, _, Tq, _ = out.shape
        return self.out_proj(out.transpose(1, 2).reshape(B, Tq, E))


class _Sublayers(nn.Module):
    """Dropout and the ReLU feed-forward block shared by the two layer kinds."""

    def _drop(self, x: torch.Tensor) -> torch.Tensor:
        return dropout(x, self.dropout, self.training)

    def _ffn(self, x: torch.Tensor) -> torch.Tensor:
        return self._drop(self.linear2(self._drop(F.relu(self.linear1(x)))))


class TransformerEncoderLayer(_Sublayers):
    """Post-norm: x = norm1(x + drop(SA(x))); x = norm2(x + drop(FFN(x))); ReLU FFN."""

    def __init__(self, d_model: int, dim_feedforward: int, num_heads: int, *,
                 generator: torch.Generator, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiheadAttention(d_model, num_heads, generator=generator,
                                            dropout=dropout)
        self.linear1 = Linear(d_model, dim_feedforward, generator=generator)
        self.linear2 = Linear(dim_feedforward, d_model, generator=generator)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x + self._drop(self.self_attn(x, x, x)))
        return self.norm2(x + self._ffn(x))


class TransformerDecoderLayer(_Sublayers):
    """Post-norm decoder: self-attn -> cross-attn -> FFN, each through dropout, then the
    residual add and LayerNorm."""

    def __init__(self, d_model: int, dim_feedforward: int, num_heads: int, *,
                 generator: torch.Generator, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiheadAttention(d_model, num_heads, generator=generator,
                                            dropout=dropout)
        self.multihead_attn = MultiheadAttention(d_model, num_heads, generator=generator,
                                                 dropout=dropout)
        self.linear1 = Linear(d_model, dim_feedforward, generator=generator)
        self.linear2 = Linear(dim_feedforward, d_model, generator=generator)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)
        self.eval()

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        x = self.norm1(tgt + self._drop(self.self_attn(tgt, tgt, tgt)))
        x = self.norm2(x + self._drop(self.multihead_attn(x, memory, memory)))
        return self.norm3(x + self._ffn(x))


class TransformerEncoder(nn.Module):
    """torch nn.TransformerEncoder without a final norm; keys layers.{i}."""

    def __init__(self, num_layers: int, d_model: int, dim_feedforward: int,
                 num_heads: int, *, generator: torch.Generator, dropout: float = 0.1):
        super().__init__()
        self.layers = nn.ModuleList([
            TransformerEncoderLayer(d_model, dim_feedforward, num_heads, generator=generator,
                                   dropout=dropout)
            for _ in range(num_layers)
        ])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with child_rng():
            for layer in self.layers:
                with child_rng():
                    x = layer(x)
        return x


class TransformerDecoder(nn.Module):
    """torch nn.TransformerDecoder without a final norm; keys layers.{i}."""

    def __init__(self, num_layers: int, d_model: int, dim_feedforward: int,
                 num_heads: int, *, generator: torch.Generator, dropout: float = 0.1):
        super().__init__()
        self.layers = nn.ModuleList([
            TransformerDecoderLayer(d_model, dim_feedforward, num_heads, generator=generator,
                                   dropout=dropout)
            for _ in range(num_layers)
        ])

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        with child_rng():
            for layer in self.layers:
                with child_rng():
                    tgt = layer(tgt, memory)
        return tgt


__all__ = [
    "MultiheadAttention",
    "TransformerDecoder",
    "TransformerDecoderLayer",
    "TransformerEncoder",
    "TransformerEncoderLayer",
]
