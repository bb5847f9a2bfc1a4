"""Composite blocks of the EMAGE family (counterpart of ``pantomatrix_tpu/nn/blocks.py``).

Each JAX ``f(p, x, ...)`` becomes a module whose ``state_dict`` paths equal the JAX
param tree and whose ``forward`` is ``f``: ``mlp`` -> :class:`MLP`, ``basic_block`` ->
:class:`BasicBlock`, ``wav_encoder`` -> :class:`WavEncoder`, ``res_block`` ->
:class:`ResBlock`, ``vq_encoder`` -> :class:`VQEncoder`, ``vq_decoder`` ->
:class:`VQDecoder`. Stacks are ``nn.Sequential`` so their keys carry torch's
sequential numbering (``main.0``, ``main.2``, ...), activations included.
All activations are channels-last (B, L, C).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from .layers import BatchNorm1d, Conv1d, Linear, leaky_relu


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
    LeakyReLU(0.01)."""

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


def wav_encoder_stages(out_dim: int):
    """EMAGE WavEncoder stages, (in, out, kernel, stride, first_dilation, downsample):
    strides 5*6*1*6*1*3 = /540 (~30 fps from 16 kHz); stage-1 padding 1600."""
    d = out_dim
    return [
        (1, d // 4, 15, 5, 1600, True),
        (d // 4, d // 4, 15, 6, 0, True),
        (d // 4, d // 4, 15, 1, 7, False),
        (d // 4, d // 2, 15, 6, 0, True),
        (d // 2, d // 2, 15, 1, 7, False),
        (d // 2, d, 15, 3, 0, True),
    ]


def wav_encoder_out_len(n_samples: int, out_dim: int) -> int:
    """Exact output frame count of the WavEncoder (torch conv1d length arithmetic)."""
    length = n_samples
    for (_, _, k, s, fd, _) in wav_encoder_stages(out_dim):
        length = (length + 2 * fd - k) // s + 1  # conv1
        length = (length + 2 * (k // 2) - k) + 1  # conv2, length-preserving
    return length


class WavEncoder(nn.Module):
    """Raw 16 kHz wave (B, samples) -> (B, frames, out_dim); keys feat_extractor.{0..5}."""

    def __init__(self, out_dim: int, *, generator: torch.Generator):
        super().__init__()
        self.feat_extractor = nn.Sequential(*[
            BasicBlock(cin, cout, k, s, fd, ds, generator=generator)
            for (cin, cout, k, s, fd, ds) in wav_encoder_stages(out_dim)
        ])

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        return self.feat_extractor(wav[..., None])


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


def periodic_positional_encoding(pe: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x (B, T, d) + pe[:, :T] (dropout is the identity at eval)."""
    return x + pe[:, : x.shape[1], :]


__all__ = [
    "BasicBlock",
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
