"""Training checkpoints with last/best semantics (counterpart of
``pantomatrix_tpu/train/ckpt.py``).

Two formats, as in the reference and the JAX package:
- ``last.bin`` / ``best.bin``: the train state, ``{"model": state_dict, "optimizer":
  TrainOptimizer.state_dict(), "iteration": int, "extra": dict}``, written with
  ``torch.save`` (model tensors on the CPU) and read with ``torch.load(weights_only=True)``,
  which unpickles tensors and plain containers only;
- ``last/``, ``best/`` and ``test_best/``: the bare model in the HuggingFace layout
  (``io/hf_checkpoint.save_checkpoint``: ``pytorch_model.bin`` and ``config.json``), which
  ``from_pretrained`` of either package reads.

Resume restores the model, the optimizer with its schedule and the iteration; the loop
fast-forwards the data (``train/loop.py``).
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..io.hf_checkpoint import save_checkpoint


def save_train_state(path: str, model: nn.Module, optimizer, iteration: int,
                     extra: Optional[Dict[str, Any]] = None) -> None:
    state = {"model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
             "optimizer": optimizer.state_dict(), "iteration": int(iteration),
             "extra": dict(extra or {})}
    tmp = f"{path}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def load_train_state(path: str, model: nn.Module, optimizer=None) -> Tuple[int, Dict[str, Any]]:
    """Load ``path`` into ``model`` (strictly) and ``optimizer`` (when given); returns
    (iteration, extra)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(state["model"], strict=True)
    if optimizer is not None:
        optimizer.load_state_dict(state["optimizer"])
    return int(state["iteration"]), dict(state["extra"])


class BestKeeper:
    """Tracks a lower-is-better metric; every update writes ``last.bin`` and ``last/``,
    and an improvement also ``best.bin`` and ``best/``."""

    def __init__(self, ckpt_dir: str, config=None):
        self.ckpt_dir = ckpt_dir
        self.config = config
        self.best = float("inf")
        os.makedirs(ckpt_dir, exist_ok=True)

    def update(self, metric: float, model: nn.Module, optimizer, iteration: int,
               extra: Optional[Dict[str, Any]] = None) -> bool:
        meta = {"metric": metric, **(extra or {})}
        save_train_state(os.path.join(self.ckpt_dir, "last.bin"), model, optimizer,
                         iteration, meta)
        save_checkpoint(os.path.join(self.ckpt_dir, "last"), model.state_dict(), self.config)
        improved = metric < self.best
        if improved:
            self.best = metric
            save_train_state(os.path.join(self.ckpt_dir, "best.bin"), model, optimizer,
                             iteration, meta)
            save_checkpoint(os.path.join(self.ckpt_dir, "best"), model.state_dict(),
                            self.config)
        return improved


__all__ = ["BestKeeper", "load_train_state", "save_train_state"]
