"""Wiring shared by the three train CLIs (counterpart of
``pantomatrix_tpu/cli/_train_common.py``, the reference's init_env): --config plus
dotlist overrides and flags, timestamped experiment directories, the sanity_check
snapshot, seeding, the optimizer from the solver section, the device-resident loader,
the metric sinks, the periodic test pass and the validation FGD.

``--device`` defaults to ``cuda`` and raises where there is none; ``--device cpu`` runs
on the CPU. ``--debug`` runs 4 steps with a validation and a test every 2.

Several processes (``torchrun --nproc_per_node N -m pantomatrix_tpu_torch.cli.train_camn
...``, or the ``PANTO_COORDINATOR``/``PANTO_NUM_PROCESSES``/``PANTO_PROCESS_ID``
variables): ``init_env`` starts the process group first (``train/mesh.py``), each process
takes its card and reads ``data.train_bs // N`` rows of every global batch, and
``solver.fsdp_model_axis = M`` shards the parameters and moments over M processes.
Process 0 writes the metrics, the checkpoints and the test pass.
"""
from __future__ import annotations

import argparse
import json
import os
import random
from typing import Callable, List, Tuple

import numpy as np
import torch

from ..utils.config import load_config, snapshot_sanity_check, timestamp_exp_name


def parse_args(default_config: str) -> Tuple[argparse.Namespace, List[str]]:
    p = argparse.ArgumentParser()
    p.add_argument("--config", type=str, default=default_config)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--visualization", action="store_true")
    p.add_argument("--evaluation", action="store_true")
    p.add_argument("--test", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p.parse_known_args()


def default_config(name: str) -> str:
    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "configs", name)


def init_env(config_name: str):
    """The run's config (file, then overrides, then flags), its device and its process
    mesh (``train/mesh.make_train_mesh``); starts the process group where the launch
    asks for one and makes the experiment directory with its sanity_check snapshot."""
    from ..models.api import resolve_device
    from ..train.mesh import make_train_mesh, maybe_init_distributed

    args, overrides = parse_args(default_config(config_name))
    maybe_init_distributed(args.device)
    device = resolve_device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    cfg = load_config(args.config, overrides)
    if args.debug:
        cfg.solver.max_train_steps = 4
        cfg.validation.validation_steps = 2
        cfg.validation.test_steps = 2
        cfg.solver.steps_per_dispatch = 1
        cfg.debug = True
    for flag in ("wandb", "visualization", "evaluation", "test"):
        if getattr(args, flag):
            cfg.validation[flag] = True
    mesh = make_train_mesh(int(cfg.data.train_bs), int(cfg.solver.get("fsdp_model_axis", 1)))
    cfg.exp_name = timestamp_exp_name(cfg.get("exp_name", "exp"))
    cfg.output_dir = os.path.join(cfg.get("output_dir", "./outputs/"), cfg.exp_name)
    os.makedirs(cfg.output_dir, exist_ok=True)
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    snapshot_sanity_check(cfg.output_dir, cfg, pkg_root)
    return cfg, device, mesh


def seed_everything(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)


def optimizer_from_config(cfg, model):
    """The solver section's optimizer. The reference's only use of
    gradient_accumulation_steps is stretching the schedule by it; it never accumulates
    micro-batches, and neither does this."""
    from ..train.optim import make_optimizer

    s = cfg.solver
    accumulation = int(s.get("gradient_accumulation_steps", 1))
    return make_optimizer(
        model.parameters(), learning_rate=float(s.learning_rate), beta1=float(s.adam_beta1),
        beta2=float(s.adam_beta2), eps=float(s.adam_epsilon),
        weight_decay=float(s.adam_weight_decay), max_grad_norm=float(s.max_grad_norm),
        clip_parity=s.get("clip_parity", "reference"), lr_scheduler=s.lr_scheduler,
        warmup_steps=int(s.lr_warmup_steps) * accumulation,
        total_steps=int(s.max_train_steps) * accumulation,
        optimizer=s.get("optimizer", "adam"))


def loop_config(cfg):
    from ..train.loop import TrainLoopConfig

    return TrainLoopConfig(
        max_train_steps=int(cfg.solver.max_train_steps),
        validation_steps=int(cfg.validation.validation_steps),
        log_period=int(cfg.get("log_period", 50)),
        ckpt_dir=os.path.join(cfg.output_dir, "ckpt"),
        resume_from_checkpoint=cfg.get("resume_from_checkpoint"),
        steps_per_dispatch=int(cfg.solver.get("steps_per_dispatch", 1)),
        test_steps=int(cfg.validation.get("test_steps", 0) or 0),
    )


def maybe_device_resident(cfg, train_loader, device):
    """``data.device_resident`` (default on): stage the takes on ``device`` and send only
    (take, start) indices a step (``data/device_data.py``, bit-identical batches).
    Returns (loader, place_batch). Where the dataset breaks the staging contract the
    host loader serves, as in the JAX CLIs."""
    from ..data.beat2 import to_device
    from ..data.device_data import DeviceResidentLoader, StagingUnsupported

    host = (train_loader, lambda b: to_device(b, device))
    if not cfg.data.get("device_resident", True):
        return host
    try:
        loader = DeviceResidentLoader(train_loader, device)
    except StagingUnsupported as e:
        print(f"device-resident data pipeline unavailable ({e}); using host loader")
        return host
    print(f"device-resident data: staged {loader.staged_bytes / 2**20:.1f} MiB on {device}; "
          "steps transfer (take, start) indices only")
    return loader, loader.place_batch


def make_log_fn(cfg, pidx: int = 0):
    """metrics.jsonl (always) and wandb (opt-in, main process). Returns (log_fn, finish).
    Keys already namespaced (val/*, test/*) pass through; train means get wandb's
    loss/Train/ prefix."""
    from ..train.logging import JsonlLogger, WandbLogger

    wb = WandbLogger(bool(cfg.validation.get("wandb")) and pidx == 0,
                     project=cfg.get("wandb_project", ""), entity=cfg.get("wandb_entity", ""),
                     name=cfg.exp_name, config=cfg.to_dict(),
                     api_key=str(cfg.get("wandb_key", "") or ""))
    jl = JsonlLogger(os.path.join(cfg.output_dir, "metrics.jsonl"))

    def log_fn(step, metrics):
        jl.log(metrics, step)
        wb.log({(k if "/" in k else f"loss/Train/{k}"): v for k, v in metrics.items()}, step)

    return log_fn, wb.finish


def build_test_fn(cfg, make_generate: Callable, pose_fps: int, device, with_face: bool = False):
    """The periodic test pass (generate the test split, save npz, the metrics): returns
    ``test_fn(model, iteration) -> metric dict``, or None when neither --evaluation nor
    --test asks for it or the test split is empty. ``make_generate(model)`` binds the
    live model."""
    if not (cfg.validation.get("evaluation") or cfg.validation.get("test")):
        return None
    from ..eval.test_flow import run_test_pass, unique_test_clips

    test_list = unique_test_clips(cfg.data.test_meta_paths)
    if not test_list:
        print("no mode=='test' clips in data.test_meta_paths; test pass disabled")
        return None
    viz = 1 if cfg.validation.get("visualization") else 0

    def test_fn(model, iteration):
        folder = os.path.join(cfg.output_dir, f"test_{iteration}")
        return run_test_pass(make_generate(model), test_list, folder, pose_fps=pose_fps,
                             with_face=with_face, visualize=viz, device=device)

    return test_fn


def run_test_and_exit(cfg, test_fn, model) -> bool:
    """--test: run the test pass once from the configured checkpoint; True when the CLI
    should stop."""
    if not cfg.validation.get("test"):
        return False
    from ..train.ckpt import load_train_state

    if cfg.get("resume_from_checkpoint"):
        it, _ = load_train_state(cfg.resume_from_checkpoint, model)
        print(f"testing checkpoint {cfg.resume_from_checkpoint} (step {it})")
    if test_fn is None:
        raise SystemExit("--test needs mode=='test' clips in data.test_meta_paths")
    model.eval()
    print(json.dumps(test_fn(model, 0), indent=2))
    return True


def windowed_fgd_val(val_loader, predict_rot6d_fn, device):
    """``val_fn(model, iteration)``: windowed FGD over the val split.
    ``predict_rot6d_fn(model, batch) -> (pred_rot6d, gt_rot6d)`` in the 330-channel
    full-body layout, on a batch on ``device``."""
    from ..data.beat2 import to_device
    from ..eval.metrics import FGD
    from ..nn.layers import strict_fp32

    def val_fn(model, iteration):
        fgd = FGD(download_path=os.environ.get("EMAGE_EVALTOOLS", "./emage_evaltools/"),
                  device=device)
        for batch in val_loader:
            with torch.no_grad(), strict_fp32():
                pred, gt = predict_rot6d_fn(model, to_device(batch, device))
            pred, gt = pred.cpu().numpy(), gt.cpu().numpy()
            for i in range(pred.shape[0]):
                fgd.update(pred[i:i + 1], gt[i:i + 1])
        return fgd.compute()

    return val_fn


def masked_rot6d_predictor(joint_mask):
    """predict_rot6d_fn for CaMN and DisCo: the model seeded with the ground truth's first
    frames, both streams scattered to the full-body layout."""
    from ..core.masking import recover_from_mask
    from ..core.rotations import axis_angle_to_rotation_6d

    def predict(model, batch):
        motion = batch["motion"]
        bs, t, jc = motion.shape
        gt6 = axis_angle_to_rotation_6d(motion.reshape(bs, t, jc // 3, 3)).reshape(bs, t, -1)
        speaker = torch.zeros((bs, 1), dtype=torch.long, device=motion.device)
        pred = model(batch["audio"], speaker, model.config.seed_frames, seed_motion=gt6,
                     return_axis_angle=False)["motion"]
        return recover_from_mask(pred, joint_mask), recover_from_mask(gt6, joint_mask)

    return predict


def run(cfg, device, model, step_fn, optimizer, train_loader, val_fn, test_fn,
        mesh) -> None:
    """The loop with the CLIs' sinks and loaders; ends the process group, if any."""
    import torch.distributed as dist

    from ..train.loop import run_training

    log_fn, finish = make_log_fn(cfg, mesh.rank)
    loader, place_batch = maybe_device_resident(cfg, train_loader, device)
    try:
        run_training(loop_config(cfg), step_fn, model, optimizer, loader, place_batch,
                     val_fn=val_fn, model_config=getattr(model, "config", None), log_fn=log_fn,
                     is_main_process=mesh.rank == 0, test_fn=test_fn, mesh=mesh)
    finally:
        finish()
        if dist.is_initialized():
            dist.destroy_process_group()


__all__ = ["build_test_fn", "init_env", "loop_config", "make_log_fn", "masked_rot6d_predictor",
           "maybe_device_resident", "optimizer_from_config", "parse_args", "run",
           "run_test_and_exit", "seed_everything", "windowed_fgd_val"]
