"""Vector quantization (counterpart of ``pantomatrix_tpu/nn/vq.py``): the codebook,
the nearest-code search, and the quantizer's forward with its straight-through
estimator, commitment loss and perplexity.

``nearest_code`` here is the reference Quantizer's search, with the full expanded
distance ``||z||^2 + ||e||^2 - 2 z.e``; ``quantize`` and ``map2index`` use it, as the
JAX package's do. The decode path re-quantizes through ``ops/vq_cuda.py::nearest_code``,
the hand-written kernel, which drops the row-constant ``||z||^2``: the two agree except
on genuine near-ties, so the encode side keeps the expanded form.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from .layers import Embedding, embedding


def codebook_distances(z_flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """(N, D), (K, D) -> (N, K) squared L2 distances in the reference's expanded form."""
    z_sq = (z_flat * z_flat).sum(dim=1, keepdim=True)
    e_sq = (codebook * codebook).sum(dim=1)
    return z_sq + e_sq - 2.0 * (z_flat @ codebook.T)


def nearest_code(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """z (..., D) -> (...,) int32 nearest codebook indices."""
    flat = z.reshape(-1, z.shape[-1])
    idx = torch.argmin(codebook_distances(flat, codebook), dim=1)
    return idx.reshape(z.shape[:-1]).to(torch.int32)


def get_codebook_entry(quantizer: "Quantizer", indices: torch.Tensor) -> torch.Tensor:
    """indices (...,) -> code vectors (..., D)."""
    return embedding(indices, quantizer.embedding.weight)


def quantize(quantizer: "Quantizer", z: torch.Tensor, beta: float
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantizer.forward on z (B, T, D): (loss, z_q straight-through, indices (B, T)
    int32, perplexity). The loss is ``mse(z_q, sg(z)) + beta * mse(sg(z_q), z)``; the
    straight-through output is ``z + sg(z_q - z)``."""
    codebook = quantizer.embedding.weight
    indices = nearest_code(z, codebook)
    z_q = embedding(indices, codebook)
    loss = ((z_q - z.detach()) ** 2).mean() + beta * ((z_q.detach() - z) ** 2).mean()
    z_q_st = z + (z_q - z).detach()
    one_hot = torch.nn.functional.one_hot(indices.reshape(-1).long(),
                                          codebook.shape[0]).to(z.dtype)
    e_mean = one_hot.mean(dim=0)
    perplexity = torch.exp(-(e_mean * torch.log(e_mean + 1e-10)).sum())
    return loss, z_q_st, indices, perplexity


def map2index(quantizer: "Quantizer", z: torch.Tensor) -> torch.Tensor:
    """(B, T, D) -> (B, T) int32 nearest indices (Quantizer.map2index)."""
    return nearest_code(z, quantizer.embedding.weight)


class Quantizer(nn.Module):
    """Key ``embedding.weight`` (n_e, e_dim); reference init U(-1/n_e, 1/n_e)."""

    def __init__(self, n_e: int, e_dim: int, *, generator: torch.Generator):
        super().__init__()
        self.embedding = Embedding(n_e, e_dim, generator=generator, bound=1.0 / n_e)


__all__ = ["Quantizer", "codebook_distances", "get_codebook_entry", "map2index",
           "nearest_code", "quantize"]
