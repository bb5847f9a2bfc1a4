"""CaMN trainer (counterpart of ``pantomatrix_tpu/cli/train_camn.py``): the geodesic
objective on rot6d, windowed validation FGD with best checkpoints, a step-indexed loop,
on one card or several processes (``cli/_train_common.py``).

Usage: python -m pantomatrix_tpu_torch.cli.train_camn [--config <yaml>] [--debug]
       [--device cuda|cpu] [k=v ...]
"""
from __future__ import annotations


def build_training(cfg, device, mesh=None):
    """(model, optimizer, step_fn, train_loader) of a run of ``cfg``, placed on ``mesh``
    (None: one process): what ``main`` trains and scripts/torch_replay_check.py
    replays."""
    import torch

    from ..data.beat2 import BEAT2Dataset, DataLoader
    from ..models.camn import CamnAudio
    from ..models.configs import CamnAudioConfig
    from ..train.mesh import make_mesh, place_train_state
    from ..train.steps import make_camn_train_step
    from . import _train_common as common

    mesh = make_mesh(1) if mesh is None else mesh
    common.seed_everything(cfg.seed)
    model_cfg = CamnAudioConfig.from_dict(cfg.model.to_dict())
    model = CamnAudio(model_cfg, generator=torch.Generator().manual_seed(cfg.seed)).to(device)
    model, optimizer = place_train_state(model, common.optimizer_from_config(cfg, model), mesh)
    step_fn = make_camn_train_step(model, optimizer, compute_dtype=cfg.solver.get("compute_dtype"),
                                   seed=cfg.seed, mesh=mesh)
    train_ds = BEAT2Dataset(cfg.data.meta_paths, "train", model_cfg.pose_fps,
                            model_cfg.audio_sr, model_cfg.joint_mask)
    train_loader = DataLoader(train_ds, cfg.data.train_bs, seed=cfg.seed,
                              process_index=mesh.rank, process_count=mesh.world)
    return model, optimizer, step_fn, train_loader


def main():
    from ..core.masking import MASK_DICT
    from ..data.beat2 import BEAT2Dataset, DataLoader
    from ..eval.test_flow import make_camn_generate
    from . import _train_common as common

    cfg, device, mesh = common.init_env("camn_audio.yaml")
    model, optimizer, step_fn, train_loader = build_training(cfg, device, mesh)
    model_cfg = model.config
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
    common.run(cfg, device, model, step_fn, optimizer, train_loader, val_fn, test_fn,
               mesh)


if __name__ == "__main__":
    main()
