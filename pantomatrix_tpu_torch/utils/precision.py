"""The low-precision serving mode's parameter cast (counterpart of
``pantomatrix_tpu/utils/precision.py``).

``cast_floating`` gives a copy of a module whose floating-point parameters and buffers
(BatchNorm running statistics and the periodic PE table included) are in the compute
dtype, while integer buffers such as BatchNorm's ``num_batches_tracked`` stay as they
are. Numerical safety lives in the primitives, as in the JAX package: ``layer_norm``,
``batch_norm1d``'s scale and shift, the attention softmax and ``velocity2position``
work in float32 whatever the activation dtype (``nn/layers.py``, ``nn/attention.py``,
``core/integrate.py``), and the VQ tokenizer suite stays float32.

One module is not a plain cast: an eval-mode WavEncoder becomes a
:class:`~pantomatrix_tpu_torch.nn.blocks.FoldedWavEncoder` in the copy, its BatchNorms
folded into its convs (computed in float32 from the original's float32 tensors, rounded
once) and its activations channels-last between its convs. The JAX package applies
each BatchNorm's scale and shift per call; the fold gives the same arithmetic up to
rounding. A WavEncoder with a BatchNorm in train mode is cast, not folded. The
original module, its ``state_dict`` and its loading are untouched.

The JAX package casts the parameter tree once per call. Here a cast copies every
module of the tree on the host, which costs more than 1% of a small call, so
``cast_once`` keeps the cast copy on the module and reuses it while the weights and the
modules' modes are unchanged: a second, resident copy of the weights in the compute
dtype.
"""
from __future__ import annotations

import copy
import itertools
from typing import Optional, Union

import torch
from torch import nn

from ..nn.blocks import FoldedWavEncoder, WavEncoder
from ..nn.layers import BatchNorm1d

_COPIES = "_compute_dtype_copies"  # attribute holding cast_once's copies on a module


def compute_dtype_of(name: Union[None, str, torch.dtype]) -> Optional[torch.dtype]:
    """The serving mode's dtype: None for the float32 parity path (None or
    ``"float32"``), else the low-precision dtype (``"bfloat16"``)."""
    if name is None:
        return None
    dtype = name if isinstance(name, torch.dtype) else getattr(torch, str(name), None)
    if dtype == torch.float32:
        return None
    if dtype not in (torch.bfloat16, torch.float16):
        raise ValueError(f"compute_dtype must be bfloat16, float16 or float32, got {name!r}")
    return dtype


def cast_floating(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """A copy of ``module`` with every floating parameter and buffer cast to ``dtype``;
    integer buffers are shared with ``module``, not copied. Each WavEncoder of
    ``module`` whose BatchNorms are all in eval mode is a ``FoldedWavEncoder`` in the
    copy."""
    memo = {}
    copies = module.__dict__.get(_COPIES)
    if copies is not None:
        memo[id(copies)] = {}
    for m in module.modules():
        if isinstance(m, WavEncoder) and not any(b.training for b in m.modules()
                                                 if isinstance(b, BatchNorm1d)):
            memo[id(m)] = FoldedWavEncoder(m, dtype)
    for t in itertools.chain(module.parameters(), module.buffers()):
        if t.is_floating_point():
            cast = t.detach().to(dtype)
            memo[id(t)] = nn.Parameter(cast, requires_grad=False) \
                if isinstance(t, nn.Parameter) else cast
        else:
            memo[id(t)] = t
    return copy.deepcopy(module, memo)


def _weights_key(module: nn.Module):
    """Changes when a parameter or buffer is replaced, moved or written in place, and
    when a module's mode changes (the copy folds eval-mode WavEncoders only). Read from
    each module's own tensor dicts: ``parameters()`` builds every tensor's name, which
    costs twice as long, and this runs on every call."""
    modules = list(module.modules())
    return (tuple(m.training for m in modules),
            tuple((t.data_ptr(), t._version) for m in modules
                  for t in itertools.chain(m._parameters.values(), m._buffers.values())
                  if t is not None))


def cast_once(module: nn.Module, dtype: Optional[torch.dtype]) -> nn.Module:
    """``module`` itself when ``dtype`` is None, else ``cast_floating(module, dtype)``,
    made on the first call and kept on ``module`` until its weights or a module's mode
    change."""
    if dtype is None:
        return module
    copies = module.__dict__.setdefault(_COPIES, {})
    key = _weights_key(module)
    kept = copies.get(dtype)
    if kept is None or kept[0] != key:
        kept = copies[dtype] = (key, cast_floating(module, dtype))
    return kept[1]


__all__ = ["cast_floating", "cast_once", "compute_dtype_of"]
