"""User-facing model classes with ``from_pretrained`` / ``save_pretrained`` (counterpart
of ``pantomatrix_tpu/models/api.py``, EMAGE only).

Every constructor and loader takes ``device``, default ``"cuda"``, and raises when CUDA
is absent rather than running on the CPU; pass ``device="cpu"`` for a CPU run. Random
init draws from a CPU ``torch.Generator`` seeded with ``seed``, then moves to the device.
"""
from __future__ import annotations

from typing import Type

import torch

from ..io import hf_checkpoint
from .configs import BaseConfig, EmageAudioConfig, EmageVAEConvConfig, EmageVQVAEConvConfig
from .emage import EmageAudio, emage_inference
from .emage_vq import (
    EmageVAE,
    EmageVQSuite,
    EmageVQVAE,
    init_vq_suite,
    vq_decode,
    vqvae_decode_index,
    vqvae_decode_latent,
)


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, raising if it names CUDA and no CUDA device exists."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev


class PretrainedModel:
    """Mixin over a model ``nn.Module`` whose constructor is ``(config, *, generator)``."""

    config_class: Type[BaseConfig] = BaseConfig

    def __init__(self, config: BaseConfig, seed: int = 0, device="cuda"):
        dev = resolve_device(device)
        super().__init__(config, generator=torch.Generator().manual_seed(seed))
        self.to(dev)

    @classmethod
    def from_pretrained(cls, directory: str, device="cuda"):
        """Load a local checkpoint directory (config.json + weights), strictly."""
        dev = resolve_device(device)
        model = cls(cls.config_class.load_json(directory), device="cpu")
        model.load_state_dict(hf_checkpoint.load_state_dict(directory), strict=True)
        return model.to(dev)

    def save_pretrained(self, directory: str) -> None:
        hf_checkpoint.save_checkpoint(directory, self.state_dict(), self.config)


class EmageVQVAEConv(PretrainedModel, EmageVQVAE):
    config_class = EmageVQVAEConvConfig

    def decode(self, index):
        return vqvae_decode_index(self, index)

    def decode_from_latent(self, latent):
        return vqvae_decode_latent(self, latent)


class EmageVAEConv(PretrainedModel, EmageVAE):
    config_class = EmageVAEConvConfig


class EmageVQModel(EmageVQSuite):
    """The five tokenizers composed for decoding."""

    @classmethod
    def random(cls, seed: int = 0, device="cuda") -> "EmageVQModel":
        """Random weights at the reference part widths."""
        dev = resolve_device(device)
        suite = init_vq_suite(torch.Generator().manual_seed(seed))
        return cls(**dict(suite.named_children())).to(dev)

    def decode(self, **kwargs):
        return vq_decode(self, **kwargs)


class EmageAudioModel(PretrainedModel, EmageAudio):
    config_class = EmageAudioConfig

    def inference(self, audio, speaker_id, vq_model: EmageVQSuite, masked_motion=None,
                  mask=None):
        return emage_inference(self, audio, speaker_id, vq_model, masked_motion, mask)


__all__ = [
    "EmageAudioModel",
    "EmageVAEConv",
    "EmageVQModel",
    "EmageVQVAEConv",
    "PretrainedModel",
    "resolve_device",
]
