"""HuggingFace-layout checkpoint IO (counterpart of ``pantomatrix_tpu/io/hf_checkpoint.py``).

A checkpoint directory is ``config.json`` plus weights in ``model.safetensors`` or
``pytorch_model.bin``, keyed by ``state_dict`` paths: the JAX package reads and writes
the same layout, so one directory loads into either package.
"""
from __future__ import annotations

import os
from typing import Any, Dict

import torch

SAFETENSORS_NAME = "model.safetensors"
TORCH_BIN_NAME = "pytorch_model.bin"


def flatten_params(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Nested dict -> flat ``{dotted.path: leaf}`` (``state_dict`` layout)."""
    flat: Dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update(flatten_params(v, f"{prefix}{k}."))
        else:
            flat[f"{prefix}{k}"] = v
    return flat


def unflatten_params(flat: Dict[str, Any]) -> Dict[str, Any]:
    """Flat ``{dotted.path: leaf}`` -> nested dict."""
    tree: Dict[str, Any] = {}
    for name, value in flat.items():
        *parents, leaf = name.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def load_state_dict(directory: str) -> Dict[str, torch.Tensor]:
    """Weights of a checkpoint directory as CPU tensors: ``model.safetensors`` if
    present, else ``pytorch_model.bin``."""
    st_path = os.path.join(directory, SAFETENSORS_NAME)
    if os.path.exists(st_path):
        try:
            from safetensors.torch import load_file
        except ImportError as e:
            raise RuntimeError(
                f"{st_path} needs the 'safetensors' package, which is not installed; "
                f"convert the checkpoint to {TORCH_BIN_NAME} or install safetensors") from e
        return load_file(st_path, device="cpu")
    bin_path = os.path.join(directory, TORCH_BIN_NAME)
    if os.path.exists(bin_path):
        return torch.load(bin_path, map_location="cpu", weights_only=True)
    raise FileNotFoundError(
        f"no {SAFETENSORS_NAME} or {TORCH_BIN_NAME} in {directory} "
        "(pass a local checkpoint directory)")


def save_checkpoint(directory: str, state_dict: Dict[str, torch.Tensor], config=None) -> None:
    """Write ``pytorch_model.bin`` (CPU, contiguous tensors) and ``config.json``."""
    os.makedirs(directory, exist_ok=True)
    cpu = {k: v.detach().cpu().contiguous() for k, v in state_dict.items()}
    torch.save(cpu, os.path.join(directory, TORCH_BIN_NAME))
    if config is not None:
        config.save_json(directory)


__all__ = [
    "flatten_params",
    "load_state_dict",
    "save_checkpoint",
    "unflatten_params",
]
