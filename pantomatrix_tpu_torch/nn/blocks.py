"""Composite blocks of the EMAGE, CaMN and DisCo families (counterpart of
``pantomatrix_tpu/nn/blocks.py``).

Each JAX ``f(p, x, ...)`` becomes a module whose ``state_dict`` paths equal the JAX
param tree and whose ``forward`` is ``f``: ``mlp`` -> :class:`MLP`, ``basic_block`` ->
:class:`BasicBlock`, ``wav_encoder`` -> :class:`WavEncoder`, ``res_block`` ->
:class:`ResBlock`, ``vq_encoder`` -> :class:`VQEncoder`, ``vq_decoder`` ->
:class:`VQDecoder`. Stacks are ``nn.Sequential`` so their keys carry torch's
sequential numbering (``main.0``, ``main.2``, ...), activations included.
All activations are channels-last (B, L, C). :class:`FoldedWavEncoder`, which has no
JAX counterpart, is the WavEncoder of the low-precision copy of a model.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm1d, Conv1d, Linear, dropout, fold_batch_norm, leaky_relu


class MLP(nn.Module):
    """linear -> LeakyReLU(0.1) -> linear; keys fc1, fc2."""

    def __init__(self, in_dim: int, middle_dim: int, out_dim: int, *,
                 generator: torch.Generator):
        super().__init__()
        self.fc1 = Linear(in_dim, middle_dim, generator=generator)
        self.fc2 = Linear(middle_dim, out_dim, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(leaky_relu(self.fc1(x), 0.1))


class BasicBlock(nn.Module):
    """1-D residual block: conv1(k, stride, pad=first_dilation) -> BN -> LeakyReLU(0.01)
    -> conv2(k, 1, pad=k//2) -> BN, [+ conv/BN downsample on the shortcut], add,
    LeakyReLU(0.01).

    This is the float32 parity path's and training's arithmetic, each BatchNorm a pass of
    its own. The low-precision copy of an eval-mode WavEncoder runs these blocks as
    :class:`FoldedWavEncoder`: each BatchNorm folded into the conv before it."""

    def __init__(self, inplanes: int, planes: int, ker_size: int, stride: int,
                 first_dilation: int, downsample: bool, *, generator: torch.Generator):
        super().__init__()
        self.conv1 = Conv1d(inplanes, planes, ker_size, generator=generator,
                            stride=stride, padding=first_dilation)
        self.bn1 = BatchNorm1d(planes)
        self.conv2 = Conv1d(planes, planes, ker_size, generator=generator,
                            padding=ker_size // 2)
        self.bn2 = BatchNorm1d(planes)
        self.downsample = (
            nn.Sequential(
                Conv1d(inplanes, planes, ker_size, generator=generator, stride=stride,
                       padding=first_dilation),
                BatchNorm1d(planes),
            )
            if downsample else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = leaky_relu(self.bn1(self.conv1(x)), 0.01)
        y = self.bn2(self.conv2(y))
        shortcut = x if self.downsample is None else self.downsample(x)
        return leaky_relu(y + shortcut, 0.01)


def wav_encoder_stages(out_dim: int, variant: str = "emage"):
    """WavEncoder stages, (in, out, kernel, stride, first_dilation, downsample); stage-1
    padding 1600.

    ``"emage"``: strides 5*6*1*6*1*3 = /540 (~30 fps from 16 kHz), channels d/4, d/4,
    d/4, d/2, d/2, d. ``"camn"`` (CaMN and DisCo): strides 5*6*1*6*1*6 = /1080 (~15 fps),
    channels fixed at 32, 32, 32, 64, 64, 128 whatever ``out_dim`` is; its blocks take
    a downsample path wherever the stride or the width changes."""
    if variant == "emage":
        d = out_dim
        return [
            (1, d // 4, 15, 5, 1600, True),
            (d // 4, d // 4, 15, 6, 0, True),
            (d // 4, d // 4, 15, 1, 7, False),
            (d // 4, d // 2, 15, 6, 0, True),
            (d // 2, d // 2, 15, 1, 7, False),
            (d // 2, d, 15, 3, 0, True),
        ]
    if variant == "camn":
        return [
            (1, 32, 15, 5, 1600, True),
            (32, 32, 15, 6, 0, True),
            (32, 32, 15, 1, 7, False),
            (32, 64, 15, 6, 0, True),
            (64, 64, 15, 1, 7, False),
            (64, 128, 15, 6, 0, True),
        ]
    raise ValueError(f"unknown WavEncoder variant {variant!r}")


def wav_encoder_out_len(n_samples: int, out_dim: int, variant: str = "emage") -> int:
    """Exact output frame count of the WavEncoder (torch conv1d length arithmetic)."""
    length = n_samples
    for (_, _, k, s, fd, _) in wav_encoder_stages(out_dim, variant):
        length = (length + 2 * fd - k) // s + 1  # conv1
        length = (length + 2 * (k // 2) - k) + 1  # conv2, length-preserving
    return length


class WavEncoder(nn.Module):
    """Raw 16 kHz wave (B, samples) -> (B, frames, channels); keys feat_extractor.{0..5}."""

    def __init__(self, out_dim: int, variant: str = "emage", *, generator: torch.Generator):
        super().__init__()
        self.feat_extractor = nn.Sequential(*[
            BasicBlock(cin, cout, k, s, fd, ds, generator=generator)
            for (cin, cout, k, s, fd, ds) in wav_encoder_stages(out_dim, variant)
        ])

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        return self.feat_extractor(wav[..., None])


class FoldedWavEncoder(nn.Module):
    """An eval-mode :class:`WavEncoder` as the low-precision copy of a model runs it
    (``utils/precision.cast_floating``), with its arithmetic up to rounding:

    - each BatchNorm is folded into the conv before it (``nn/layers.fold_batch_norm``,
      in float32 from the encoder's float32 tensors, rounded once to ``dtype``), and on a
      block with a downsample the second conv's bias is added to the shortcut conv's, so
      a block runs its convs, a bias add for each conv that keeps a bias, the residual
      add and two LeakyReLUs;
    - the activations stay in one layout from the first conv to the last: (B, C, 1, L)
      in torch's ``channels_last`` format, which is the port's channels-last (B, L, C) in
      memory and the NHWC layout that cuDNN's low-precision kernels take natively, so
      nothing is transposed or converted between the convs. Its weights are stored
      ``channels_last`` too, which makes PyTorch pick that format at the first conv,
      whose one-channel input fits either format;
    - the LeakyReLUs run in place, and the residual is added into the second conv's
      output, which nothing else reads.

    (B, samples) -> (B, frames, channels), contiguous. Its tensors are parameters
    without gradients, under keys of its own: it is made from a WavEncoder, never
    loaded."""

    def __init__(self, encoder: WavEncoder, dtype: torch.dtype):
        super().__init__()
        self.blocks = nn.ModuleList()
        self.geometry = []  # per block: stride, first padding, second padding
        for block in encoder.feat_extractor:
            w1, b1 = fold_batch_norm(block.conv1, block.bn1)
            w2, b2 = fold_batch_norm(block.conv2, block.bn2)
            tensors = {"w1": w1, "b1": b1, "w2": w2, "b2": b2}
            if block.downsample is not None:
                wd, bd = fold_batch_norm(*block.downsample)
                tensors.update(wd=wd, bd=bd + tensors.pop("b2"))
            self.blocks.append(nn.ParameterDict({
                k: nn.Parameter(_channels_last(t) if t.dim() == 3 else t, requires_grad=False)
                for k, t in ((k, t.to(dtype)) for k, t in tensors.items())}))
            self.geometry.append((block.conv1.stride, block.conv1.padding,
                                  block.conv2.padding))

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        x = wav[:, None, None, :]
        for p, (stride, pad1, pad2) in zip(self.blocks, self.geometry):
            y = F.leaky_relu_(F.conv2d(x, p["w1"], p["b1"], (1, stride), (0, pad1)), 0.01)
            y = F.conv2d(y, p["w2"], p.get("b2"), 1, (0, pad2))
            y += F.conv2d(x, p["wd"], p["bd"], (1, stride), (0, pad1)) if "wd" in p else x
            x = F.leaky_relu_(y, 0.01)
        return x[:, :, 0].transpose(1, 2)


def _channels_last(weight: torch.Tensor) -> torch.Tensor:
    """A (Cout, Cin, K) conv weight as (Cout, Cin, 1, K) in ``channels_last`` memory,
    with exactly the strides torch gives that format. Where Cin is 1 the size-1 dims'
    strides alone tell the formats apart (``.contiguous(memory_format=...)`` leaves them
    as they were), and PyTorch would pick NCHW for the first conv, whose input has one
    channel, and copy its output at the next conv."""
    cout, cin, k = weight.shape
    out = torch.empty_strided((cout, cin, 1, k), (k * cin, 1, k * cin, cin),
                              dtype=weight.dtype, device=weight.device)
    return out.copy_(weight[:, :, None])


class ResBlock(nn.Module):
    """conv(3,1,1) -> LeakyReLU(0.2) -> conv(3,1,1), plus the skip; keys model.0/model.2."""

    def __init__(self, channel: int, *, generator: torch.Generator):
        super().__init__()
        self.model = nn.Sequential(
            Conv1d(channel, channel, 3, generator=generator, padding=1, xavier=True),
            nn.LeakyReLU(0.2),
            Conv1d(channel, channel, 3, generator=generator, padding=1, xavier=True),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x) + x


class VQEncoder(nn.Module):
    """Per layer conv(3,1,1) + LeakyReLU(0.2) + ResBlock; (B, T, in) -> (B, T, channels).
    Keys main.{0,2,3,5,...}."""

    def __init__(self, in_dim: int, channels: int, n_layers: int, *,
                 generator: torch.Generator):
        super().__init__()
        layers = []
        cin = in_dim
        for _ in range(n_layers):
            layers += [
                Conv1d(cin, channels, 3, generator=generator, padding=1, xavier=True),
                nn.LeakyReLU(0.2),
                ResBlock(channels, generator=generator),
            ]
            cin = channels
        self.main = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.main(x)


class VQDecoder(nn.Module):
    """Two ResBlocks, ``n_layers`` x (conv + LeakyReLU(0.2)), final conv. The input
    width equals ``channels`` on every EMAGE part, so the reference's optional stem
    conv is absent: keys main.{0,1} ResBlocks, main.{2,4,..} up convs, main.{last}."""

    def __init__(self, out_dim: int, channels: int, n_layers: int, *,
                 generator: torch.Generator):
        super().__init__()
        layers = [ResBlock(channels, generator=generator),
                  ResBlock(channels, generator=generator)]
        chans = [channels] * n_layers + [out_dim]
        for i in range(n_layers):
            layers += [
                Conv1d(chans[i], chans[i + 1], 3, generator=generator, padding=1,
                       xavier=True),
                nn.LeakyReLU(0.2),
            ]
        layers.append(Conv1d(out_dim, out_dim, 3, generator=generator, padding=1,
                             xavier=True))
        self.main = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.main(x)


def make_periodic_pe(d_model: int, period: int, max_seq_len: int) -> torch.Tensor:
    """Sinusoidal PE of length ``period`` tiled past ``max_seq_len``: (1, n, d) float32.
    Built on the host in float64 and rounded once, so it lands within float32 rounding
    of the reference table."""
    position = np.arange(period, dtype=np.float64)[:, None]
    div_term = np.exp(
        np.arange(0, d_model, 2, dtype=np.float64) * (-math.log(10000.0) / d_model)
    )
    pe = np.zeros((period, d_model))
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    repeat_num = (max_seq_len // period) + 1
    return torch.from_numpy(np.tile(pe[None], (1, repeat_num, 1)).astype(np.float32))


def periodic_positional_encoding(pe: torch.Tensor, x: torch.Tensor, dropout_rate: float = 0.0,
                                 training: bool = False) -> torch.Tensor:
    """x (B, T, d) + pe[:, :T], then dropout (train mode only)."""
    return dropout(x + pe[:, : x.shape[1], :], dropout_rate, training)


__all__ = [
    "BasicBlock",
    "FoldedWavEncoder",
    "MLP",
    "ResBlock",
    "VQDecoder",
    "VQEncoder",
    "WavEncoder",
    "make_periodic_pe",
    "periodic_positional_encoding",
    "wav_encoder_out_len",
    "wav_encoder_stages",
]
