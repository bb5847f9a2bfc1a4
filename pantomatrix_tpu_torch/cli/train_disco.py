"""DisCo trainer (counterpart of ``pantomatrix_tpu/cli/train_disco.py``): the geodesic and
contrastive disentanglement objective, class-balanced sampling over the content labels
(the reference's WeightedRandomSampler), windowed validation FGD with best checkpoints,
on one card or several processes (``cli/_train_common.py``).

Usage: python -m pantomatrix_tpu_torch.cli.train_disco [--config <yaml>] [--debug]
       [--device cuda|cpu] [k=v ...]
"""
from __future__ import annotations

import numpy as np


class _WeightedLoader:
    """Class-balanced batches, reshuffled each epoch. ``batch_size`` is the global batch:
    every process draws the same weighted index stream (seeded by the epoch) and takes
    rows [p*lb, (p+1)*lb) of each global batch, as ``data.beat2.DataLoader`` shards."""

    def __init__(self, dataset, batch_size: int, seed: int = 42, process_index: int = 0,
                 process_count: int = 1):
        from ..data.beat2 import collate

        if batch_size % process_count:
            raise ValueError(f"global batch_size={batch_size} must divide evenly over "
                             f"process_count={process_count} processes")
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.epoch = 0
        self.process_index = process_index
        self.process_count = process_count
        self.labels = np.asarray([m["content_label"] for m in dataset.data_list])
        self._collate = collate

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def index_batches(self):
        """Per-batch dataset indices (``DataLoader.index_batches``'s contract)."""
        from ..data.beat2 import weighted_indices

        idx = weighted_indices(self.labels, len(self.dataset), self.seed + self.epoch)
        lb = self.batch_size // self.process_count
        idx = idx[: len(self) * self.batch_size].reshape(
            len(self), self.process_count, lb)[:, self.process_index].reshape(-1)
        for b in range(len(self)):
            yield idx[b * lb: (b + 1) * lb]

    def __iter__(self):
        for chunk in self.index_batches():
            yield self._collate([self.dataset[int(i)] for i in chunk])


def build_training(cfg, device, mesh=None):
    """(model, optimizer, step_fn, train_loader) of a run of ``cfg``, placed on ``mesh``
    (None: one process): what ``main`` trains and scripts/torch_replay_check.py
    replays."""
    import torch

    from ..data.beat2 import BEAT2Dataset
    from ..models.configs import DiscoAudioConfig
    from ..models.disco import DiscoAudio
    from ..train.mesh import make_mesh, place_train_state
    from ..train.steps import make_disco_train_step
    from . import _train_common as common

    mesh = make_mesh(1) if mesh is None else mesh
    common.seed_everything(cfg.seed)
    model_cfg = DiscoAudioConfig.from_dict(cfg.model.to_dict())
    model = DiscoAudio(model_cfg, generator=torch.Generator().manual_seed(cfg.seed)).to(device)
    model, optimizer = place_train_state(model, common.optimizer_from_config(cfg, model), mesh)
    step_fn = make_disco_train_step(model, optimizer,
                                    compute_dtype=cfg.solver.get("compute_dtype"), seed=cfg.seed,
                                    mesh=mesh)
    train_ds = BEAT2Dataset(cfg.data.meta_paths, "train", model_cfg.pose_fps,
                            model_cfg.audio_sr, model_cfg.joint_mask, variant="disco")
    train_loader = _WeightedLoader(train_ds, cfg.data.train_bs, seed=cfg.seed,
                                   process_index=mesh.rank, process_count=mesh.world)
    return model, optimizer, step_fn, train_loader


def main():
    from ..core.masking import MASK_DICT
    from ..data.beat2 import BEAT2Dataset, DataLoader
    from ..eval.test_flow import make_disco_generate
    from . import _train_common as common

    cfg, device, mesh = common.init_env("disco_audio.yaml")
    model, optimizer, step_fn, train_loader = build_training(cfg, device, mesh)
    model_cfg = model.config
    val_ds = BEAT2Dataset(cfg.data.test_meta_paths, "val", model_cfg.pose_fps,
                          model_cfg.audio_sr, model_cfg.joint_mask)
    val_fn = None
    if len(val_ds):
        val_loader = DataLoader(val_ds, min(cfg.data.train_bs, len(val_ds)), shuffle=False)
        val_fn = common.windowed_fgd_val(
            val_loader, common.masked_rot6d_predictor(MASK_DICT[model_cfg.joint_mask]), device)
    test_fn = common.build_test_fn(cfg, make_disco_generate, model_cfg.pose_fps, device)
    if common.run_test_and_exit(cfg, test_fn, model):
        return
    common.run(cfg, device, model, step_fn, optimizer, train_loader, val_fn, test_fn,
               mesh)


if __name__ == "__main__":
    main()
