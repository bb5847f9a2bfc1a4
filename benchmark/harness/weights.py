"""Seeded weights for a reference module tree, drawn on the device in a few large calls.

Each module of the reference says how its tensors are drawn (its ``init`` dict): a
uniform bound, a normal scale, a constant, or a fixed table. ``build`` makes the module
without initialising it (on ``meta``, then uninitialised memory on the device) and fills
every tensor from one uniform and one normal draw of a ``torch.Generator`` on the device,
so a seed gives one set of weights whatever the device's host is doing.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import nn


def _leaves(module: nn.Module):
    for mod_name, mod in module.named_modules():
        rules = getattr(mod, "init", None) or {}
        for name, (kind, arg) in rules.items():
            t = getattr(mod, name, None)
            if t is not None:
                yield f"{mod_name}.{name}" if mod_name else name, t, kind, arg


def fill(module: nn.Module, seed: int) -> nn.Module:
    """Draw every tensor of ``module`` from ``seed``; raises if one has no rule."""
    leaves = list(_leaves(module))
    covered = {id(t) for _, t, _, _ in leaves}
    missing = [n for n, t in list(module.named_parameters()) + list(module.named_buffers())
               if id(t) not in covered]
    if missing:
        raise ValueError(f"no init rule for {missing[:5]}")
    device = next(module.parameters()).device
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    with torch.no_grad():
        for kind in ("uniform", "normal"):
            group = [(t, arg) for _, t, k, arg in leaves if k == kind]
            total = sum(t.numel() for t, _ in group)
            if not total:
                continue
            flat = (torch.rand(total, generator=gen, device=device) * 2 - 1
                    if kind == "uniform" else
                    torch.randn(total, generator=gen, device=device))
            at = 0
            for t, scale in group:
                n = t.numel()
                t.copy_(flat[at:at + n].view_as(t) * scale)
                at += n
        for _, t, kind, arg in leaves:
            if kind == "const":
                t.fill_(arg)
            elif kind == "fixed":
                t.copy_(arg(device))
    return module


def build(factory: Callable[[], nn.Module], seed: int, device) -> nn.Module:
    """``factory()`` on the device, in eval mode, with every tensor drawn from ``seed``."""
    with torch.device("meta"):
        module = factory()
    module = module.to_empty(device=device).eval()
    return fill(module, seed)
