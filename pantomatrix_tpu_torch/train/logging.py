"""Run records: wandb (opt-in), metrics.jsonl and the throughput line (counterpart of
``pantomatrix_tpu/train/logging.py``)."""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class WandbLogger:
    """Does nothing unless wandb is importable and enabled."""

    def __init__(self, enabled: bool, project: str = "", entity: str = "", name: str = "",
                 config: Optional[dict] = None, api_key: str = ""):
        self.run = None
        if not enabled:
            return
        if api_key:  # cfg.wandb_key -> environment, as the reference does
            os.environ["WANDB_API_KEY"] = api_key
        try:
            import wandb
        except ImportError:
            print("wandb requested but not installed; continuing without it")
            return
        self.run = wandb.init(project=project or None, entity=entity or None,
                              name=name or None, config=config)

    def log(self, metrics: Dict[str, float], step: Optional[int] = None) -> None:
        if self.run is not None:
            self.run.log(metrics, step=step)

    def finish(self) -> None:
        if self.run is not None:
            self.run.finish()


class JsonlLogger:
    """Append-only ``metrics.jsonl``: one line per call of the loop's log_fn (train means
    per log period, ``val/metric`` per validation, ``test/*`` per test pass)."""

    def __init__(self, path: str):
        self.path = path

    def log(self, metrics: Dict[str, float], step: Optional[int] = None) -> None:
        rec = {"step": step, **{k: float(v) for k, v in metrics.items()}}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")


class ThroughputMeter:
    """Seconds of motion per second of wall time (the reference's headline line)."""

    def __init__(self, fps: int = 30):
        self.fps = fps
        self.frames = 0
        self.start = time.time()

    def add_frames(self, n: int) -> None:
        self.frames += n

    def report(self) -> str:
        wall = time.time() - self.start
        motion_s = self.frames / self.fps
        rtf = motion_s / wall if wall > 0 else float("inf")
        return (f"cost {wall:.2f}s to generate {motion_s:.2f}s of motion "
                f"({rtf:.1f}x real-time)")


__all__ = ["JsonlLogger", "ThroughputMeter", "WandbLogger"]
