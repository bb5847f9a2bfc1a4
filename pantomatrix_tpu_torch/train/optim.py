"""Optimizer and learning-rate schedule (counterpart of ``pantomatrix_tpu/train/optim.py``).

``make_optimizer`` builds a :class:`TrainOptimizer`: the JAX package's optax chain as torch
objects. ``adam`` is ``torch.optim.Adam``, or ``torch.optim.AdamW`` (decoupled decay) when
``weight_decay > 0``; ``sgd`` is ``torch.optim.SGD``, whose weight decay on plain SGD is
the same update as optax's ``add_decayed_weights`` before ``sgd``. The schedule is a
``LambdaLR`` stepped after every update, so the k-th update (from 0) runs at optax's
``schedule(k)``.

Gradient clipping: the reference calls ``clip_grad_norm_`` before ``backward``, which
clips stale or zero gradients, i.e. does not clip. ``clip_parity="reference"`` (default)
keeps that (no clip); ``"fixed"`` clips the global norm to ``max_grad_norm`` with
``torch.nn.utils.clip_grad_norm_`` before each update.
"""
from __future__ import annotations

import math
from typing import Callable, Iterable, Optional

import torch


def lr_factor(name: str, warmup_steps: int = 0,
              total_steps: Optional[int] = None) -> Callable[[int], float]:
    """The schedule as a factor of the peak learning rate at update count k (from 0),
    as optax's ``constant``, ``warmup_constant_schedule(0, lr, warmup)``,
    ``linear_schedule(lr, 0, total)`` and ``warmup_cosine_decay_schedule(0, lr, warmup,
    total)`` give it."""
    total = total_steps or 1
    if name == "constant":
        return lambda k: 1.0
    if name == "constant_with_warmup":
        return lambda k: min(k / warmup_steps, 1.0) if warmup_steps > 0 else 1.0
    if name == "linear":
        return lambda k: 1.0 - min(k, total) / total
    if name == "cosine":
        decay = total - warmup_steps
        if decay <= 0:
            raise ValueError(f"cosine schedule needs total_steps > warmup_steps, got "
                             f"{total_steps} and {warmup_steps}")

        def cosine(k: int) -> float:
            if k < warmup_steps:
                return k / warmup_steps
            return 0.5 * (1.0 + math.cos(math.pi * min(k - warmup_steps, decay) / decay))

        return cosine
    raise ValueError(f"unknown lr scheduler {name!r}")


class TrainOptimizer:
    """An optimizer, its schedule and the clip, stepped together: ``zero_grad()``, then
    ``backward()``, then ``step()``; ``state_dict``/``load_state_dict`` cover all."""

    def __init__(self, params: Iterable[torch.nn.Parameter], learning_rate: float = 1.5e-4,
                 beta1: float = 0.9, beta2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, max_grad_norm: float = 0.0,
                 clip_parity: str = "reference", lr_scheduler: str = "constant",
                 warmup_steps: int = 0, total_steps: Optional[int] = None,
                 optimizer: str = "adam"):
        if clip_parity not in ("reference", "fixed"):
            raise ValueError(f"unknown clip_parity {clip_parity!r} (reference|fixed)")
        self.hparams = dict(learning_rate=learning_rate, beta1=beta1, beta2=beta2, eps=eps,
                            weight_decay=weight_decay, max_grad_norm=max_grad_norm,
                            clip_parity=clip_parity, lr_scheduler=lr_scheduler,
                            warmup_steps=warmup_steps, total_steps=total_steps,
                            optimizer=optimizer)
        self.params = [p for p in params if p.requires_grad]
        if optimizer == "sgd":
            self.optimizer = torch.optim.SGD(self.params, lr=learning_rate,
                                             weight_decay=weight_decay)
        elif optimizer != "adam":
            raise ValueError(f"unknown optimizer {optimizer!r} (adam|sgd)")
        elif weight_decay > 0:
            self.optimizer = torch.optim.AdamW(self.params, lr=learning_rate,
                                               betas=(beta1, beta2), eps=eps,
                                               weight_decay=weight_decay)
        else:
            self.optimizer = torch.optim.Adam(self.params, lr=learning_rate,
                                              betas=(beta1, beta2), eps=eps)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer, lr_factor(lr_scheduler, warmup_steps, total_steps))
        self.clip = max_grad_norm if (max_grad_norm > 0 and clip_parity == "fixed") else 0.0

    @property
    def lr(self) -> float:
        """The learning rate of the next update."""
        return self.optimizer.param_groups[0]["lr"]

    def like(self, params: Iterable[torch.nn.Parameter], **overrides) -> "TrainOptimizer":
        """A fresh optimizer of these hyperparameters over other parameters (FSDP's
        slices, ``train/mesh.py``), with ``overrides`` applied."""
        return TrainOptimizer(params, **{**self.hparams, **overrides})

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self) -> None:
        if self.clip:
            torch.nn.utils.clip_grad_norm_(self.params, self.clip)
        self.optimizer.step()
        self.scheduler.step()

    def state_dict(self) -> dict:
        return {"optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])


def make_optimizer(params: Iterable[torch.nn.Parameter], **kwargs) -> TrainOptimizer:
    """``TrainOptimizer(params, **kwargs)``, with the JAX ``make_optimizer``'s keywords:
    ``learning_rate``, ``beta1``, ``beta2``, ``eps``, ``weight_decay``,
    ``max_grad_norm``, ``clip_parity``, ``lr_scheduler``, ``warmup_steps``,
    ``total_steps`` and ``optimizer`` ("adam" or "sgd": the equivalence tests use SGD,
    because Adam's early steps are about sign(g) * lr and turn last-ulp differences
    between two programs into visible ones)."""
    return TrainOptimizer(params, **kwargs)


__all__ = ["TrainOptimizer", "lr_factor", "make_optimizer"]
