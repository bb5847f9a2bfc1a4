"""Vector-quantizer codebook (counterpart of ``pantomatrix_tpu/nn/vq.py``, eval only).

``nearest_code`` here is the reference Quantizer's search, with the full expanded
distance ``||z||^2 + ||e||^2 - 2 z.e``. The decode path re-quantizes through
``ops/vq_cuda.py::nearest_code``, the hand-written kernel, which drops the row-constant
``||z||^2``: the two agree except on genuine near-ties.
"""
from __future__ import annotations

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


class Quantizer(nn.Module):
    """Key ``embedding.weight`` (n_e, e_dim); reference init U(-1/n_e, 1/n_e)."""

    def __init__(self, n_e: int, e_dim: int, *, generator: torch.Generator):
        super().__init__()
        self.embedding = Embedding(n_e, e_dim, generator=generator, bound=1.0 / n_e)


__all__ = ["Quantizer", "codebook_distances", "get_codebook_entry", "nearest_code"]
