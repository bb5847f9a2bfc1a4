"""Velocity -> position integration as a prefix sum (counterpart of
``pantomatrix_tpu/core/integrate.py``)."""
from __future__ import annotations

import torch


def velocity2position(data_seq: torch.Tensor, dt: float, init_pos: torch.Tensor) -> torch.Tensor:
    """Euler-integrate velocities: data_seq (bs, t, c), init_pos (bs, c) -> (bs, t, c)
    with out[:, 0] = init_pos and out[:, i] = out[:, i-1] + dt * data_seq[:, i-1]."""
    init = init_pos[:, None, :]
    if data_seq.shape[1] == 1:
        return init
    increments = dt * torch.cumsum(data_seq[:, :-1, :], dim=1)
    return torch.cat([init, init + increments], dim=1)


__all__ = ["velocity2position"]
