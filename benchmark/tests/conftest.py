"""CPU tests of the benchmark (``python -m pytest benchmark/tests -q``).

Tests that need a CUDA card carry the ``card`` marker and skip inside the test where
there is none; on a card: ``python -m pytest benchmark/tests -q -m card``.
"""
import copy
import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
for p in (str(BENCH_DIR), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


# the cells' models at widths a CPU test holds: EMAGE keeps the tokenizers' published
# widths (its latents feed them), CaMN two LSTM layers at h 32
TINY_MODEL = {
    "emage": dict(audio_f=32, motion_f=16, hidden_size=32, pose_length=8, seed_frames=2),
    "camn": dict(hidden_size=32, n_layer=2),
}
TINY_MIX = {
    "emage": dict(batch=2, clip_seconds=1.0, trace_calls=1),
    "camn": dict(batch=2, clip_seconds=2.0, trace_calls=1),
}


def tiny_cell(name: str, root: Path = ROOT) -> dict:
    """Cell ``name`` as ``BENCHMARK.json`` defines it, at a size a CPU test holds."""
    from harness import common

    cell = copy.deepcopy(common.find_cell(common.load_spec(root), name, root / "benchmark"))
    family = cell["config_file"]["family"]
    cell["config_file"]["model"].update(TINY_MODEL[family])
    cell["mix"].update(TINY_MIX[family])
    return cell


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")
