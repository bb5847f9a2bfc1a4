"""CaMN trainer (counterpart of ``pantomatrix_tpu/cli/train_camn.py``): the geodesic
objective on rot6d, windowed validation FGD with best checkpoints, a step-indexed loop,
on one card.

Usage: python -m pantomatrix_tpu_torch.cli.train_camn [--config <yaml>] [--debug]
       [--device cuda|cpu] [k=v ...]
"""
from __future__ import annotations


def main():
    import torch

    from ..core.masking import MASK_DICT
    from ..data.beat2 import BEAT2Dataset, DataLoader
    from ..eval.test_flow import make_camn_generate
    from ..models.camn import CamnAudio
    from ..models.configs import CamnAudioConfig
    from ..train.steps import make_camn_train_step
    from . import _train_common as common

    cfg, device = common.init_env("camn_audio.yaml")
    common.seed_everything(cfg.seed)
    model_cfg = CamnAudioConfig.from_dict(cfg.model.to_dict())
    model = CamnAudio(model_cfg, generator=torch.Generator().manual_seed(cfg.seed)).to(device)
    optimizer = common.optimizer_from_config(cfg, model)
    step_fn = make_camn_train_step(model, optimizer, compute_dtype=cfg.solver.get("compute_dtype"),
                                   seed=cfg.seed)

    train_ds = BEAT2Dataset(cfg.data.meta_paths, "train", model_cfg.pose_fps,
                            model_cfg.audio_sr, model_cfg.joint_mask)
    train_loader = DataLoader(train_ds, cfg.data.train_bs, seed=cfg.seed)
    val_ds = BEAT2Dataset(cfg.data.test_meta_paths, "val", model_cfg.pose_fps,
                          model_cfg.audio_sr, model_cfg.joint_mask)
    val_fn = None
    if len(val_ds):
        val_loader = DataLoader(val_ds, min(cfg.data.train_bs, len(val_ds)), shuffle=False)
        val_fn = common.windowed_fgd_val(
            val_loader, common.masked_rot6d_predictor(MASK_DICT[model_cfg.joint_mask]), device)
    test_fn = common.build_test_fn(cfg, make_camn_generate, model_cfg.pose_fps, device)
    if common.run_test_and_exit(cfg, test_fn, model):
        return
    common.run(cfg, device, model, step_fn, optimizer, train_loader, val_fn, test_fn)


if __name__ == "__main__":
    main()
