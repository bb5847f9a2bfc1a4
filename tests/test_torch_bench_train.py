"""The port's training benchmark over several processes (pantomatrix_tpu_torch/cli/
bench_train.py) on the CPU: the FLOPs it adds for K2's forward launches, the process
count of a plain start, and two gloo processes against one on the same global batch.

K2's forward is a ctypes launch that ``FlopCounterMode`` cannot see; ``ops/lstm_cuda.
layer_flops`` stands for it and must equal the counter's count of the plain version's
forward at the same shape. Two processes hold the one-process run's ``last_loss`` within
5e-5 relative (the DisCo bound of tests/_torch_mp_runs.py: its clamped arccos makes the
step ill-conditioned) and its FLOP count within 1% (the row-gathered contrastive terms
are counted on each process).
"""
import json
import math
import os
import subprocess
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from pantomatrix_tpu_torch.ops import lstm_cuda
from pantomatrix_tpu_torch.train.mesh import data_axis_size, run_processes

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("t,b,h", [(5, 3, 8), (7, 1, 16), (3, 4, 32)])
def test_layer_flops_equal_the_counter_on_the_plain_forward(t, b, h):
    g = torch.Generator().manual_seed(t * b * h)
    x_proj = torch.randn(t, b, 8 * h, generator=g)
    w_hh = torch.randn(2, 4 * h, h, generator=g)
    with FlopCounterMode(display=False) as counter:
        lstm_cuda.lstm_bidirectional_plain(x_proj, w_hh, h)
    assert lstm_cuda.layer_flops(t, b, h) == counter.get_total_flops()
    with FlopCounterMode(display=False) as counter:
        lstm_cuda.lstm_direction_plain(x_proj[..., :4 * h], w_hh[0], h)
    assert lstm_cuda.layer_flops(t, b, h, directions=1) == counter.get_total_flops()


@pytest.mark.parametrize("name,peak", [("NVIDIA H100 80GB HBM3", 989.4), ("cpu", None)])
def test_peak_bf16_tflops_by_card_name(name, peak):
    """The dense bf16 peak that bench_train's MFU divides by; an unknown card raises."""
    from pantomatrix_tpu_torch.utils.device import peak_bf16_tflops

    if peak is None:
        with pytest.raises(ValueError, match="no dense bf16 peak"):
            peak_bf16_tflops(name)
    else:
        assert peak_bf16_tflops(name) == peak


def test_cpu_layers_leave_the_launch_counters_alone():
    before = (lstm_cuda.launches, lstm_cuda.forward_flops)
    lstm_cuda.lstm_bidirectional(torch.zeros(4, 2, 64), torch.zeros(2, 32, 8), 8)
    assert (lstm_cuda.launches, lstm_cuda.forward_flops) == before


@pytest.mark.parametrize("batch,devices,want", [
    (64, 1, 1), (64, 8, 8), (56, 8, 8), (6, 4, 3), (7, 4, 1), (2, 8, 2), (12, 5, 4),
    (9, 9, 9), (10, 0, 1),
])
def test_data_axis_size_is_the_largest_divisor_up_to_the_cards(batch, devices, want):
    assert data_axis_size(batch, devices) == want


def test_run_processes_raises_when_a_process_fails():
    with pytest.raises(RuntimeError, match="exit codes"):
        run_processes(math.sqrt, 2, "cpu", (-1.0,), timeout_s=120)


def _bench(*flags):
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-m", "pantomatrix_tpu_torch.cli.bench_train",
                        "--device", "cpu", "--family", "disco", "--batch", "2", "--frames",
                        "8", "--k", "1", "--repeats", "1", *flags],
                       cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    lines = []
    for text in r.stdout.splitlines():
        try:
            lines.append(json.loads(text))
        except ValueError:
            continue
    assert len(lines) == 1, r.stdout
    return lines[0]


def test_two_gloo_processes_match_one():
    one, two = _bench("--cards", "1"), _bench("--cards", "2")
    assert (one["processes"], one["local_batch"], one["backend"]) == (1, 2, None)
    assert (two["processes"], two["local_batch"], two["backend"]) == (2, 1, "gloo")
    assert one["batch"] == two["batch"] == 2 and one["cards"] == two["cards"] == 0
    assert one["mfu"] is None and two["mfu"] is None
    assert one["k2_forward_flops"] == two["k2_forward_flops"] == 0  # no launch on the CPU
    assert abs(two["flops_per_step"] - one["flops_per_step"]) <= 0.01 * one["flops_per_step"]
    assert math.isfinite(two["last_loss"])
    assert abs(two["last_loss"] - one["last_loss"]) <= 5e-5 * abs(one["last_loss"])
