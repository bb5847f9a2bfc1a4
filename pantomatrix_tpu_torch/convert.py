"""Carry weights from a JAX-package param tree into the port's modules.

The JAX param trees are nested dicts whose paths are torch ``state_dict`` paths, so a
tree of numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``) flattens to a
``state_dict`` and loads with ``strict=True``: a missing, extra or misshapen key fails.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from .io.hf_checkpoint import flatten_params


def from_jax_params(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Nested tree of numpy arrays -> flat ``state_dict`` of CPU tensors (copied)."""
    return {k: torch.from_numpy(np.array(v)) for k, v in flatten_params(tree).items()}


def load_jax_params(module: nn.Module, tree: Dict[str, Any]) -> nn.Module:
    """Strict-load a JAX param tree (of numpy arrays) into ``module``; returns it."""
    module.load_state_dict(from_jax_params(tree), strict=True)
    return module


__all__ = ["from_jax_params", "load_jax_params"]
