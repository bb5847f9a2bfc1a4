"""The step-indexed training loop (counterpart of ``pantomatrix_tpu/train/loop.py``): steps
to ``max_train_steps``, a validation every ``validation_steps`` that keeps the best
checkpoint, an optional test pass every ``test_steps``, resume with the data
fast-forwarded inside the epoch, running loss means and a background thread that
prepares the next batches.

Multi-process (``mesh``): every process steps on its rows; the logged losses are the
means over the processes, reduced once a log period; every process validates (as the
JAX package does); the test pass and every checkpoint write are the main process's.
Under FSDP every process gathers the full state before them (a collective).
"""
from __future__ import annotations

import os
import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from ..io.hf_checkpoint import save_checkpoint
from .ckpt import BestKeeper, load_train_state
from .mesh import fsdp_state, gather_replicated, mean_over_processes


PREFETCH_DEPTH = 2


def prefetch(iterable, fn):
    """Yield ``fn(item)`` for each item, computed up to ``PREFETCH_DEPTH`` items ahead on a
    background thread so that batch preparation overlaps the steps. An exception in the
    thread is raised here, at the item it failed on."""
    q: "queue.Queue" = queue.Queue(maxsize=PREFETCH_DEPTH)
    done = object()

    def worker():
        try:
            for item in iterable:
                q.put((fn(item), None))
        except Exception as e:  # handed to the consumer, which raises it
            q.put((None, e))
        finally:
            q.put((done, None))

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item, err = q.get()
        if err is not None:
            raise err
        if item is done:
            return
        yield item


class Meters:
    """Running means of the losses over a log period."""

    def __init__(self):
        self.sums: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    def update(self, losses: Dict[str, Any]) -> None:
        for k, v in losses.items():
            self.sums[k] = self.sums.get(k, 0.0) + float(v)
            self.counts[k] = self.counts.get(k, 0) + 1

    def means(self) -> Dict[str, float]:
        return {k: self.sums[k] / self.counts[k] for k in self.sums}

    def reset(self) -> None:
        self.sums.clear()
        self.counts.clear()


@dataclass
class TrainLoopConfig:
    max_train_steps: int = 1000
    validation_steps: int = 500
    # every test_steps, the full test pass (generate -> npz -> metrics) on the main
    # process, keeping a test_best/ checkpoint keyed on its FGD; 0 disables
    test_steps: int = 0
    log_period: int = 50
    ckpt_dir: str = "./outputs/ckpt"
    resume_from_checkpoint: Optional[str] = None
    # the JAX package fuses this many steps into one device program; here they run one
    # by one, with the same iterations. It must still divide the log, validation, test
    # and stop periods, as there.
    steps_per_dispatch: int = 1


def _check_dispatch(loop_cfg: TrainLoopConfig, iteration: int) -> None:
    k = loop_cfg.steps_per_dispatch
    if k <= 1:
        return
    checked = ["log_period", "validation_steps", "max_train_steps"]
    if loop_cfg.test_steps:
        checked.append("test_steps")
    for name in checked:
        if getattr(loop_cfg, name) % k:
            raise ValueError(f"steps_per_dispatch={k} must divide {name}="
                             f"{getattr(loop_cfg, name)}")
    if iteration % k:
        raise ValueError(f"resumed iteration {iteration} is not a multiple of "
                         f"steps_per_dispatch={k}")


def run_training(loop_cfg: TrainLoopConfig, step_fn: Callable, model: nn.Module, optimizer,
                 train_loader, place_batch: Callable[[dict], dict],
                 val_fn: Optional[Callable] = None, model_config=None,
                 log_fn: Optional[Callable[[int, Dict[str, float]], None]] = None,
                 is_main_process: bool = True, test_fn: Optional[Callable] = None,
                 mesh=None) -> int:
    """Run ``step_fn(batch, iteration)`` to ``max_train_steps``; returns the final
    iteration. The model and the optimizer are updated in place.

    ``val_fn(model, iteration) -> metric`` (lower is better) runs every
    ``validation_steps``; ``test_fn(model, iteration) -> metric dict`` (its ``fgd`` keys
    the ``test_best/`` checkpoint) every ``test_steps``. Both see the model in eval mode.
    Checkpoints are written by the main process. ``mesh``: the run's process mesh
    (``train/mesh.py``); every process calls this with the same configuration.

    Resume loads the checkpoint on every process, and an FSDP optimizer re-shards the
    loaded state as the fresh run placed it (``FsdpOptimizer.load_state_dict``)."""
    iteration = 0
    best_test, best_test_embedder = float("inf"), ""
    if loop_cfg.resume_from_checkpoint:
        iteration, extra = load_train_state(loop_cfg.resume_from_checkpoint, model, optimizer)
        # without these the first test pass after a resume would replace test_best/
        # with arbitrary weights (anything beats a fresh inf)
        best_test = float(extra.get("best_test", float("inf")))
        best_test_embedder = str(extra.get("best_test_embedder", ""))
        print(f"resumed from {loop_cfg.resume_from_checkpoint} at step {iteration}")
    if len(train_loader) == 0:
        raise ValueError("train_loader yields no batches (dataset smaller than the batch size "
                         "with drop_last): the step loop would never advance")
    _check_dispatch(loop_cfg, iteration)
    keeper = BestKeeper(loop_cfg.ckpt_dir, model_config)
    fsdp = fsdp_state(optimizer)
    device = next(model.parameters()).device
    meters = Meters()
    steps_per_epoch = len(train_loader)
    epoch, skip = divmod(iteration, steps_per_epoch)  # deterministic resume

    def batch_stream():
        nonlocal epoch, skip
        while True:
            train_loader.set_epoch(epoch)
            for i, batch in enumerate(prefetch(train_loader, place_batch)):
                if i >= skip:
                    yield batch
            skip = 0
            epoch += 1

    def extra():
        return {"best_test": best_test, "best_test_embedder": best_test_embedder}

    data_time = net_time = 0.0
    pending = []
    last_saved = -1
    stream = batch_stream()
    while iteration < loop_cfg.max_train_steps:
        t0 = time.time()
        batch = next(stream)
        data_time += time.time() - t0
        t0 = time.time()
        pending.append(step_fn(batch, iteration))
        iteration += 1
        logging_now = iteration % loop_cfg.log_period == 0
        if logging_now:
            for losses in pending:  # reading the losses waits for the card
                meters.update(losses)
            pending.clear()
        net_time += time.time() - t0

        if logging_now:
            means = mean_over_processes(meters.means(), mesh, device)
            if is_main_process:
                msg = " ".join(f"{k}={v:.4f}" for k, v in sorted(means.items()))
                print(f"step {iteration}: {msg} (data {data_time:.1f}s net {net_time:.1f}s)")
                if log_fn:
                    log_fn(iteration, means)
            meters.reset()

        if val_fn is not None and iteration % loop_cfg.validation_steps == 0:
            saved = gather_replicated(model, optimizer, mesh)
            model.eval()
            metric = float(val_fn(model, iteration))
            last_saved = iteration
            if is_main_process:
                improved = keeper.update(metric, model, saved, iteration, extra())
                print(f"val @ {iteration}: metric={metric:.4f}"
                      + (" (new best)" if improved else ""))
                if log_fn:
                    log_fn(iteration, {"val/metric": metric})

        if test_fn is not None and loop_cfg.test_steps and iteration % loop_cfg.test_steps == 0:
            if fsdp is not None:
                fsdp.gather()  # a collective: every process takes part
            if is_main_process:
                model.eval()
                tmetrics = test_fn(model, iteration)
                msg = " ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                               for k, v in sorted(tmetrics.items()))
                tmetric = float(tmetrics.get("fgd", float("inf")))
                # FGD values of two embedders are not comparable (eval/metrics.py FGD)
                embedder = str(tmetrics.get("fgd_embedder", ""))
                if embedder != best_test_embedder:
                    if best_test != float("inf"):
                        print(f"test: fgd embedder changed {best_test_embedder!r} -> "
                              f"{embedder!r}; resetting test_best tracking")
                        best_test = float("inf")
                    best_test_embedder = embedder
                if tmetric < best_test:
                    best_test = tmetric
                    save_checkpoint(os.path.join(loop_cfg.ckpt_dir, "test_best"),
                                    model.state_dict(), model_config)
                    msg += " (new test best)"
                print(f"test @ {iteration}: {msg}")
                if log_fn:
                    log_fn(iteration, {f"test/{k}": float(v) for k, v in tmetrics.items()
                                       if isinstance(v, (int, float))})

    if last_saved != iteration:
        saved = gather_replicated(model, optimizer, mesh)
        if is_main_process:
            # the final state is always kept (an inf metric never displaces the best)
            keeper.update(float("inf"), model, saved, iteration, extra())
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return iteration


__all__ = ["Meters", "TrainLoopConfig", "prefetch", "run_training"]
