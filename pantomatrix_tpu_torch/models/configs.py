"""Model configuration dataclasses (the port's own copy).

Same fields and defaults as ``pantomatrix_tpu/models/configs.py:104-160``; round-trips
through the same ``config.json`` files. Identity equality (``eq=False``) as in the
reference copy, so a config can key a cache by object.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Any, Dict


@dataclass(eq=False)
class BaseConfig:
    model_type: str = "base"

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "BaseConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        cfg = cls(**{k: v for k, v in d.items() if k in known})
        # unknown keys stay as attributes, like the reference's config flattening
        for k, v in d.items():
            if k not in known:
                setattr(cfg, k, v)
        return cfg

    def to_dict(self) -> Dict[str, Any]:
        return dict(self.__dict__)

    def save_json(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        with open(os.path.join(directory, "config.json"), "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)

    @classmethod
    def load_json(cls, directory: str) -> "BaseConfig":
        with open(os.path.join(directory, "config.json")) as f:
            return cls.from_dict(json.load(f))


@dataclass(eq=False)
class EmageAudioConfig(BaseConfig):
    """configs/emage_audio.yaml model subtree."""

    model_type: str = "emage_audio"
    pose_fps: int = 30
    motion_f: int = 256
    pose_dims: int = 330
    pose_rep: str = "smplx"
    audio_rep: str = "wave16k"
    audio_sr: int = 16000
    audio_fps: int = 16000
    audio_norm: bool = False
    audio_f: int = 256
    speaker_f: int = 768
    speaker_dims: int = 1
    hidden_size: int = 768
    n_layer: int = 1
    dropout_prob: float = 0.1
    seed_frames: int = 4
    pose_length: int = 64
    vae_codebook_size: int = 256
    vae_length: int = 256
    joint_mask: str = "local_full"
    # head routing: at inference c*>0 decodes that part from code indices, else from
    # latents (l* > 0); face is latent-routed by default
    ll: float = 3.0
    lf: float = 3.0
    lu: float = 3.0
    lh: float = 3.0
    cl: float = 1.0
    cf: float = 0.0
    cu: float = 1.0
    ch: float = 1.0


@dataclass(eq=False)
class EmageVQVAEConvConfig(BaseConfig):
    """Per-part VQ-VAE tokenizer config."""

    model_type: str = "emage_vqvaeconv"
    vae_layer: int = 2
    vae_length: int = 256
    vae_test_dim: int = 106
    vae_codebook_size: int = 256
    vae_quantizer_lambda: float = 1.0


@dataclass(eq=False)
class EmageVAEConvConfig(BaseConfig):
    """Global-translation VAE config."""

    model_type: str = "emage_vaeconv"
    vae_layer: int = 4
    vae_length: int = 240
    vae_test_dim: int = 61


__all__ = [
    "BaseConfig",
    "EmageAudioConfig",
    "EmageVAEConvConfig",
    "EmageVQVAEConvConfig",
]
