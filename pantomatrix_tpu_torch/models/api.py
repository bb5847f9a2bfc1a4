"""User-facing model classes with ``from_pretrained`` / ``save_pretrained``, and the
auto classes that pick one by a checkpoint's ``model_type`` (counterpart of
``pantomatrix_tpu/models/api.py``).

Every constructor and loader takes ``device``, default ``"cuda"``, and raises when CUDA
is absent rather than running on the CPU; pass ``device="cpu"`` for a CPU run. Random
init draws from a CPU ``torch.Generator`` seeded with ``seed``, then moves to the device.
"""
from __future__ import annotations

import os
from typing import Dict, Type

import torch

from ..io import hf_checkpoint
from ..utils import trace
from .camn import CamnAudio
from .configs import (
    BaseConfig,
    CamnAudioConfig,
    DiscoAudioConfig,
    EmageAudioConfig,
    EmageVAEConvConfig,
    EmageVQVAEConvConfig,
    auto_config,
)
from .disco import DiscoAudio
from .emage import EmageAudio, emage_inference
from .emage_vq import (
    EmageVAE,
    EmageVQSuite,
    EmageVQVAE,
    init_vq_suite,
    vq_decode,
    vq_get_global_motion,
    vq_map2index,
    vq_map2latent,
    vq_split_inputs,
    vqvae_decode_index,
    vqvae_decode_latent,
    vqvae_map2index,
    vqvae_map2latent,
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


class CamnAudioModel(PretrainedModel, CamnAudio):
    """``model(audio, speaker_id, seed_frames=4, seed_motion=None,
    return_axis_angle=True, compute_dtype=None)`` runs ``camn_forward``;
    ``compute_dtype="bfloat16"`` is the low-precision serving mode."""

    config_class = CamnAudioConfig


class DiscoAudioModel(PretrainedModel, DiscoAudio):
    """``model(audio, speaker_id, seed_frames=4, seed_motion=None,
    return_axis_angle=True, compute_dtype=None)`` runs ``disco_forward``;
    ``compute_dtype="bfloat16"`` is the low-precision serving mode."""

    config_class = DiscoAudioConfig


class EmageVQVAEConv(PretrainedModel, EmageVQVAE):
    """``model(inputs)`` runs ``vqvae_forward`` (loss, straight-through latent,
    perplexity, reconstruction, indices, pre-quantization latent)."""

    config_class = EmageVQVAEConvConfig

    def map2index(self, inputs):
        return vqvae_map2index(self, inputs)

    def map2latent(self, inputs):
        return vqvae_map2latent(self, inputs)

    def decode(self, index):
        return vqvae_decode_index(self, index)

    def decode_from_latent(self, latent):
        return vqvae_decode_latent(self, latent)


class EmageVAEConv(PretrainedModel, EmageVAE):
    """``model(inputs)`` runs ``vae_forward`` (the reconstruction)."""

    config_class = EmageVAEConvConfig


class EmageVQModel(EmageVQSuite):
    """The five tokenizers composed: the part split, encoding to codes or latents,
    decoding, and the global translation."""

    @classmethod
    def random(cls, seed: int = 0, device="cuda") -> "EmageVQModel":
        """Random weights at the reference part widths."""
        dev = resolve_device(device)
        suite = init_vq_suite(torch.Generator().manual_seed(seed))
        return cls(**dict(suite.named_children())).to(dev)

    @classmethod
    def from_pretrained(cls, root: str, device="cuda") -> "EmageVQModel":
        """The five tokenizers of the checkpoint root ``root``:
        ``emage_vq/{face,upper,hands,lower,global}``."""
        sub = lambda name: os.path.join(root, "emage_vq", name)
        return cls(
            face=EmageVQVAEConv.from_pretrained(sub("face"), device=device),
            upper=EmageVQVAEConv.from_pretrained(sub("upper"), device=device),
            hands=EmageVQVAEConv.from_pretrained(sub("hands"), device=device),
            lower=EmageVQVAEConv.from_pretrained(sub("lower"), device=device),
            global_motion=EmageVAEConv.from_pretrained(sub("global"), device=device),
        )

    def spilt_inputs(self, rot6d, expression, tar_contact=None, tar_trans=None):
        # (sic) the reference's spelling
        return vq_split_inputs(rot6d, expression, tar_contact, tar_trans)

    def map2index(self, rot6d, expression, tar_contact=None, tar_trans=None):
        return vq_map2index(self, rot6d, expression, tar_contact, tar_trans)

    def map2latent(self, rot6d, expression, tar_contact=None, tar_trans=None):
        return vq_map2latent(self, rot6d, expression, tar_contact, tar_trans)

    def decode(self, **kwargs):
        # the span sits here, not in vq_decode, which the window-step graphs capture
        x = next((v for k, v in kwargs.items()
                  if v is not None and k.endswith(("_index", "_latent"))), None)
        with trace.span("emage.decode", x, frames=None if x is None else x.shape[1]):
            return vq_decode(self, **kwargs)

    def get_global_motion(self, lower_body, ref_trans):
        return vq_get_global_motion(self, lower_body, ref_trans)


class EmageAudioModel(PretrainedModel, EmageAudio):
    config_class = EmageAudioConfig

    def inference(self, audio, speaker_id, vq_model: EmageVQSuite, masked_motion=None,
                  mask=None, compute_dtype=None, batched_wav=False):
        """``emage_inference``; ``compute_dtype="bfloat16"`` and ``batched_wav=True``
        select the serving modes, the defaults the float32 parity path."""
        return emage_inference(self, audio, speaker_id, vq_model, masked_motion, mask,
                               compute_dtype=compute_dtype, batched_wav=batched_wav)


MODEL_REGISTRY: Dict[str, Type[PretrainedModel]] = {
    "camn_audio": CamnAudioModel,
    "disco_audio": DiscoAudioModel,
    "emage_audio": EmageAudioModel,
    "emage_vqvaeconv": EmageVQVAEConv,
    "emage_vaeconv": EmageVAEConv,
}


class AutoModel:
    """Loads a checkpoint directory into the model class its ``model_type`` names."""

    @classmethod
    def from_pretrained(cls, directory: str, device="cuda") -> PretrainedModel:
        return MODEL_REGISTRY[auto_config(directory).model_type].from_pretrained(
            directory, device=device)


class AutoConfig:
    @classmethod
    def from_pretrained(cls, directory: str) -> BaseConfig:
        return auto_config(directory)


__all__ = [
    "AutoConfig",
    "AutoModel",
    "CamnAudioModel",
    "DiscoAudioModel",
    "EmageAudioModel",
    "EmageVAEConv",
    "EmageVQModel",
    "EmageVQVAEConv",
    "MODEL_REGISTRY",
    "PretrainedModel",
    "resolve_device",
]
