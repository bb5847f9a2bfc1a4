"""Entry point of the port's flagship forward (counterpart of the repository's
``__graft_entry__.entry``): one full-width EMAGE masked-transformer window.

    fn, args = entry()       # on the card; entry("cpu") builds it on the CPU
    outputs = fn(*args)      # rec_* latents and cls_* logits of one 64-frame window

The multi-card dry run (``dryrun_multichip``) waits for the ``torch.distributed`` port.
"""
from __future__ import annotations

import numpy as np
import torch


def _flagship(tiny: bool = False, device="cuda"):
    """The EMAGE audio model at the published widths, or at the tiny test widths, with
    random weights from seed 0."""
    from .models.api import EmageAudioModel
    from .models.configs import EmageAudioConfig

    cfg = (EmageAudioConfig(audio_f=32, motion_f=16, hidden_size=32, speaker_dims=4,
                            pose_length=8, seed_frames=2, vae_codebook_size=16,
                            vae_length=16, dropout_prob=0.0)
           if tiny else EmageAudioConfig())
    return EmageAudioModel(cfg, seed=0, device=device)


def _entry(tiny: bool, device):
    from .models.emage import SAMPLES_PER_FRAME, emage_forward

    model = _flagship(tiny, device)
    cfg = model.config
    t = cfg.pose_length
    dev = model.mask_embedding.device
    rng = np.random.RandomState(0)
    audio = torch.from_numpy(rng.uniform(-1, 1, (1, t * SAMPLES_PER_FRAME))
                             .astype(np.float32)).to(dev)
    speaker_id = torch.zeros((1, 1), dtype=torch.long, device=dev)
    motion = torch.zeros((1, t, cfg.pose_dims + 7), device=dev)
    mask = torch.ones((1, t, cfg.pose_dims + 7), device=dev)

    def fn(model, audio, speaker_id, motion, mask):
        return emage_forward(model, audio, speaker_id, motion, mask)

    return fn, (model, audio, speaker_id, motion, mask)


def entry(device="cuda"):
    """(fn, example_args): ``fn(*example_args)`` is ``emage_forward`` on one full-width
    window (h = 768, 64 frames, 337 motion channels) with batch 1."""
    return _entry(False, device)


__all__ = ["entry"]
