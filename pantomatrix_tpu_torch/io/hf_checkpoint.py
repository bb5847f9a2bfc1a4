"""HuggingFace-layout checkpoint IO (counterpart of ``pantomatrix_tpu/io/hf_checkpoint.py``).

A checkpoint directory is ``config.json`` plus weights in ``model.safetensors`` or
``pytorch_model.bin``, keyed by ``state_dict`` paths: the JAX package reads and writes
the same layout, so one directory loads into either package. The safetensors format
(an 8-byte little-endian header length, a JSON header of dtype, shape and byte range per
tensor, then the raw little-endian bytes) is read and written here without the
``safetensors`` package, which the GPU machine need not have.
"""
from __future__ import annotations

import json
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


_ST_DTYPES = {torch.float64: "F64", torch.float32: "F32", torch.float16: "F16",
              torch.bfloat16: "BF16", torch.int64: "I64", torch.int32: "I32",
              torch.int16: "I16", torch.int8: "I8", torch.uint8: "U8", torch.bool: "BOOL"}
_ST_TORCH = {v: k for k, v in _ST_DTYPES.items()}


def write_safetensors(path: str, state_dict: Dict[str, torch.Tensor]) -> None:
    """Write ``state_dict`` (any device) as a safetensors file."""
    header: Dict[str, Any] = {}
    blobs, offset = [], 0
    for name, t in state_dict.items():
        t = t.detach().cpu().contiguous()
        data = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": _ST_DTYPES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(len(text).to_bytes(8, "little"))
        f.write(text)
        for data in blobs:
            f.write(data)


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A safetensors file as CPU tensors."""
    with open(path, "rb") as f:
        raw = f.read()
    n = int.from_bytes(raw[:8], "little")
    header = json.loads(raw[8:8 + n])
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        data = torch.frombuffer(bytearray(raw[base + begin:base + end]) or bytearray(1),
                                dtype=torch.uint8)[:end - begin]
        out[name] = data.view(_ST_TORCH[info["dtype"]]).reshape(info["shape"]).clone()
    return out


def load_state_dict(directory: str) -> Dict[str, torch.Tensor]:
    """Weights of a checkpoint directory as CPU tensors: ``model.safetensors`` if
    present, else ``pytorch_model.bin``."""
    st_path = os.path.join(directory, SAFETENSORS_NAME)
    if os.path.exists(st_path):
        return read_safetensors(st_path)
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
    "read_safetensors",
    "save_checkpoint",
    "unflatten_params",
    "write_safetensors",
]
