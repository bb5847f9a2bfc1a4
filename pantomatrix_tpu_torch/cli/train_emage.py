"""EMAGE trainer (counterpart of ``pantomatrix_tpu/cli/train_emage.py``): the 3-pass
masked objective against five frozen VQ/VAE tokenizers, windowed validation FGD over
decoded predictions, best checkpoints, on one card or several processes
(``cli/_train_common.py``). The tokenizers load from
``--vq_path <root>`` (``<root>/emage_vq/{face,upper,hands,lower,global}``) or are random
with ``--random_vq`` for smoke runs.

Usage: python -m pantomatrix_tpu_torch.cli.train_emage (--vq_path <dir> | --random_vq)
       [--config <yaml>] [--debug] [--device cuda|cpu] [k=v ...]
"""
from __future__ import annotations

import argparse
import sys


def load_suite(vq_path, random_vq, device):
    """The frozen tokenizers: from ``vq_path``, or random at the reference widths."""
    from ..models.api import EmageVQModel

    if vq_path:
        return EmageVQModel.from_pretrained(vq_path, device=device)
    if random_vq:
        return EmageVQModel.random(seed=777, device=device)
    raise SystemExit("--vq_path <dir> (frozen tokenizers) or --random_vq required")


def build_training(cfg, device, suite, mesh=None):
    """(model, optimizer, step_fn, train_loader) of a run of ``cfg`` against the frozen
    tokenizers ``suite``, placed on ``mesh`` (None: one process): what ``main`` trains
    and scripts/torch_replay_check.py replays."""
    from ..data.beat2 import BEAT2Dataset, DataLoader
    from ..models.api import EmageAudioModel
    from ..models.configs import EmageAudioConfig
    from ..train.mesh import make_mesh, place_train_state
    from ..train.steps import make_emage_train_step
    from . import _train_common as common

    mesh = make_mesh(1) if mesh is None else mesh
    common.seed_everything(cfg.seed)
    model_cfg = EmageAudioConfig.from_dict(cfg.model.to_dict())
    model = EmageAudioModel(model_cfg, seed=cfg.seed, device=device)
    model, optimizer = place_train_state(model, common.optimizer_from_config(cfg, model), mesh)
    s = cfg.solver
    step_fn = make_emage_train_step(
        model, suite, optimizer, mask_schedule=cfg.get("mask_schedule", "reference"),
        gradient_checkpointing=bool(s.get("gradient_checkpointing", False)),
        share_audio_encoder=bool(s.get("share_audio_encoder", True)),
        compute_dtype=s.get("compute_dtype"), seed=cfg.seed, mesh=mesh)
    train_ds = BEAT2Dataset(cfg.data.meta_paths, "train", model_cfg.pose_fps,
                            model_cfg.audio_sr, None, variant="emage_footcontact")
    train_loader = DataLoader(train_ds, cfg.data.train_bs, seed=cfg.seed,
                              process_index=mesh.rank, process_count=mesh.world)
    return model, optimizer, step_fn, train_loader


def main():
    import torch

    from ..core.rotations import axis_angle_to_rotation_6d
    from ..data.beat2 import BEAT2Dataset, DataLoader
    from ..eval.test_flow import make_emage_generate
    from ..models.emage import _select_decode_inputs
    from ..models.emage_vq import vq_decode
    from . import _train_common as common

    vq_parser = argparse.ArgumentParser(add_help=False)
    vq_parser.add_argument("--vq_path", type=str, default=None)
    vq_parser.add_argument("--random_vq", action="store_true")
    vq_args, rest = vq_parser.parse_known_args()
    sys.argv = [sys.argv[0]] + rest

    cfg, device, mesh = common.init_env("emage_audio.yaml")
    suite = load_suite(vq_args.vq_path, vq_args.random_vq, device)
    model, optimizer, step_fn, train_loader = build_training(cfg, device, suite, mesh)
    model_cfg = model.config
    val_ds = BEAT2Dataset(cfg.data.test_meta_paths, "val", model_cfg.pose_fps,
                          model_cfg.audio_sr, None, variant="emage_footcontact")

    def predict_rot6d(model, batch):
        """Seed-mask pass -> head routing -> VQ decode -> full-body rot6d."""
        motion = batch["motion"]
        bs, t, jc = motion.shape
        gt6 = axis_angle_to_rotation_6d(motion.reshape(bs, t, jc // 3, 3)).reshape(bs, t, -1)
        masked_motion = torch.cat([gt6, batch["trans"], batch["foot_contact"]], dim=-1)
        mask = torch.ones_like(masked_motion)
        mask[:, :model_cfg.seed_frames] = 0.0
        pred = model(batch["audio"], torch.zeros((bs, 1), dtype=torch.long, device=device),
                     masked_motion, mask)
        dec = vq_decode(suite, **_select_decode_inputs(model_cfg, pred))
        return dec["all_motion4inference"][:, :, :-7], gt6

    val_fn = None
    if len(val_ds):
        val_loader = DataLoader(val_ds, min(cfg.data.train_bs, len(val_ds)), shuffle=False)
        val_fn = common.windowed_fgd_val(val_loader, predict_rot6d, device)
    test_fn = common.build_test_fn(cfg, lambda m: make_emage_generate(m, suite),
                                   model_cfg.pose_fps, device, with_face=True)
    if common.run_test_and_exit(cfg, test_fn, model):
        return
    common.run(cfg, device, model, step_fn, optimizer, train_loader, val_fn, test_fn,
               mesh)


if __name__ == "__main__":
    main()
