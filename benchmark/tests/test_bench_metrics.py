"""The arithmetic of the metrics: the rate over the whole window, the idle share from an
interval union, K2's work formula, the peak rule, the readers, and the one-line result."""
import json
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import BENCH_DIR, tiny_cell
from harness import common, peaks, trace, weights
from harness.adapter import Adapter
from kinds import closed_loop
from reference.layers import LSTM


def reader(name):
    return common.load_module(BENCH_DIR / "metrics" / f"{name}.py", "t_" + name.replace(".", "_"))


class SleepyAdapter(Adapter):
    """Each call takes ~20 ms of host time and is worth 3 motion-seconds."""

    motion_seconds_per_call = 3.0

    def setup(self):
        self.calls = []

    def call(self, i):
        time.sleep(0.02)
        self.calls.append(i)
        return {"x": torch.zeros(2)}

    def free_program(self):
        pass

    def check(self, i, out, count_flops=False):
        return {"judged": float(i)}, None


def test_rate_is_all_work_over_all_time():
    a = SleepyAdapter({"model": {}}, {"warmup_calls": 2, "judge_one_of_first": 1}, 0, "cpu")
    res = closed_loop.run(a, 0, 0.2, False, time.time())
    n = res["calls"]
    assert a.calls == list(range(2 + n))  # the warm-up, then the window
    assert res["window_s"] >= 0.2 and res["attempted"] == n and res["failed"] == 0
    assert res["end_to_end"]["motion_s_per_s"] == pytest.approx(3.0 * n / res["window_s"])
    assert 0.02 * n <= res["window_s"] < 0.02 * (n + 3) + 0.1


def test_the_judged_call_is_drawn_from_the_seed():
    mix = {"judge_one_of_first": 5}
    picks = {closed_loop.sample_index(s, mix) for s in range(2**31, 2**31 + 40)}
    assert picks == set(range(5))
    assert closed_loop.sample_index(2**40 + 3, mix) == closed_loop.sample_index(2**40 + 3, mix)


def test_union_and_idle_share():
    iv = [(0, 10), (5, 15), (20, 30), (29, 31), (40, 41)]
    assert trace.merge(iv) == [(0, 15), (20, 31), (40, 41)]
    assert trace.gaps(trace.merge(iv), -5, 50) == [(-5, 0), (15, 20), (31, 40), (41, 50)]
    stretch = {"kernels": [("k", s * 1e6, e * 1e6) for s, e in [(0, 1), (0.5, 2), (3, 4)]],
               "host": [("aten::mm", 0, 4e6), ("cudaStreamSynchronize", 2e6, 3e6)],
               "wall_s": 4.0}
    s = trace.summarize(stretch)
    assert s["busy_s"] == pytest.approx(3.0) and s["window_s"] == 4.0
    assert s["idle_gaps"] == [["cudaStreamSynchronize", pytest.approx(1.0)]]
    assert s["device_ops"] == [["k", pytest.approx(3.5)]]
    assert reader("device_idle.offline").read({"summary": s}) == pytest.approx(25.0)


def test_k2_formula_counts_the_reference_recurrence():
    t, b, c, h = 9, 3, 5, 16
    lstm = weights.build(lambda: LSTM(c, h, 1), 1, "cpu")
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        lstm(torch.randn(b, t, c))
    projection = 2 * t * b * c * 4 * h * 2
    assert counter.get_total_flops() - projection == peaks.lstm_layer_flops(t, b, h)
    assert peaks.lstm_layer_bytes(t, b, h, 2) == 2 * (t * b * 8 * h + 8 * h * h + t * b * 2 * h)


def test_peak_rule():
    assert peaks.peak_flops("bfloat16") == 989.4e12
    assert peaks.peak_flops("float32") == 494.7e12  # TF32: what a float32-accurate split reaches
    assert peaks.PEAK_BYTES_PER_S == 3.35e12
    assert peaks.roofline_seconds(989.4e12, 1.0, "bfloat16") == pytest.approx(1.0)
    assert peaks.roofline_seconds(1.0, 3.35e12, "float32") == pytest.approx(1.0)


def test_mfu_and_k2_readers():
    ctx = {"result": {"flops_per_call": 494.7e12, "calls": 4, "window_s": 8.0},
           "peaks": peaks, "precision": "float32"}
    assert reader("mfu.offline").read(ctx) == pytest.approx(50.0)
    ctx["result"]["flops_per_call"] = None
    assert reader("mfu.offline").read(ctx) is None

    class K2:
        def k2_shape(self):
            return {"t": 421, "b": 64, "h": 512}

    bound = peaks.roofline_seconds(peaks.lstm_layer_flops(421, 64, 512),
                                   peaks.lstm_layer_bytes(421, 64, 512, 2), "bfloat16")
    kernels = [("lstm_layer_kernel", 0.0, 2 * bound * 1e6), ("gemm", 0.0, 1.0)]
    ctx = {"adapter": K2(), "result": {"profile": {"kernels": kernels}}, "peaks": peaks,
           "precision": "bfloat16"}
    assert reader("k2_roofline.offline").read(ctx) == pytest.approx(50.0)
    ctx["result"]["profile"]["kernels"] = kernels[1:]
    assert reader("k2_roofline.offline").read(ctx) is None  # nothing to read: no metric


def test_flops_counted_once_a_shape(tmp_path, monkeypatch):
    from harness import flops

    monkeypatch.setattr(flops, "CACHE_DIR", tmp_path)
    runs = []

    def work():
        runs.append(1)
        return torch.ones(4, 8) @ torch.ones(8, 16)

    key = {"family": "x", "batch": 4}
    assert flops.cached(key, work) == 2 * 4 * 8 * 16
    assert flops.cached(key, work) == 2 * 4 * 8 * 16 and len(runs) == 1
    assert flops.cached(dict(key, batch=5), work) == 2 * 4 * 8 * 16 and len(runs) == 2


def test_one_line_result(capsys):
    import run

    cell = tiny_cell("camn-offline-bf16")
    out = run.run_cell(cell, 2**31 + 11, 0.0, False, time.time(), device="cpu")
    common.emit(out["line"], out["checks"])
    captured = capsys.readouterr()
    line = json.loads(captured.out.strip().splitlines()[-1])
    assert list(line)[:3] == ["correct", "attempted", "failed"] and list(line)[-1] == "checks"
    assert {"metrics", "device"} <= set(line)
    assert set(line["metrics"]) == {"motion_s_per_s", "setup_s"}
    assert all(m["value"] > 0 and m["unit"] for m in line["metrics"].values())
    assert set(line["checks"]) == set(cell["mix"]["limits"]) | set(out["checks"])
    err = captured.err.strip().splitlines()
    assert all(e.startswith("check ") for e in err[-len(line["checks"]):])
