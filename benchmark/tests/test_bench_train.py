"""The training cell ``camn-train-bf16``, held back from ``BENCHMARK.json`` (its entries in
``held/camn-train-bf16.json``), on the CPU at small widths: the plain reference's step
equals the program's, the check passes a sound run and fails the control and each
planted fault (``tools/faults_train.py``), the harness finds the cell's files by name,
and the readers give the right numbers on synthetic readings.

The tiny cell runs in float32: at widths of 32 and a batch of 4, bfloat16's rounding
moves the gradients by far more than at the cell's own size, where the limits were read
in bfloat16; the control and the faults still fail them in float32."""
import copy
import json
import subprocess
import sys
import time

import pytest

import run
from conftest import BENCH_DIR, ROOT
from harness import common, peaks
from kinds import train_loop
from tools.faults_train import FAULTS
from tools.held import with_held

CELL = "camn-train-bf16"
SEED = 2**31 + 4321


def spec() -> dict:
    return with_held(common.load_spec(ROOT))


def tiny_cell() -> dict:
    cell = copy.deepcopy(common.find_cell(spec(), CELL, BENCH_DIR))
    cell["config_file"]["model"].update(hidden_size=32, n_layer=2)
    cell["mix"].update(batch=4, frames=16, compute_dtype="float32", trace_calls=1)
    return cell


def judged(program="port", traced=False):
    out = run.run_cell(tiny_cell(), SEED, 0.5, traced, time.time(), device="cpu",
                       program=program)
    return out, {k: c["value"] for k, c in out["checks"].items()}


def adapter_module():
    return common.load_module(BENCH_DIR / "models" / "camn_train.py", "t_camn_train")


def test_reference_step_equals_program():
    """Three steps of the program from the seed, each recomputed by the reference from
    the program's state (the first from the seed's own), and the reference's own three
    steps from the seed: the same losses, gradients, updates and running statistics, to
    float32 rounding. The gradients agree to about 1e-2 only: the few frames whose
    predicted rotation lies near pi from the target carry much of the gradient through
    arccos's steep slope there, and float32 rounding moves them. The reference's own
    steps part from the program's where Adam's first updates (about lr * sign(g)) take
    the sign of an element whose gradient is that rounding, so the start's later losses
    and its change agree less closely."""
    cell = tiny_cell()
    a = adapter_module().Adapter(cell["config_file"], cell["mix"], SEED, "cpu")
    a.setup()
    for i in range(3):
        a.before(i, own=i == 0)
        out = a.call(i)
        a.after(i, out)
        a.warmed(i, out, last=i == 2)
    a.free_program()
    start = a.judge_start(a.snaps[0])
    assert start["start_loss_err"] < 1e-3, start
    assert start["start_grad_gap"] < 2e-2 and start["start_change_gap"] < 0.1, start
    for i in range(3):
        got = a.judge_step(i, a.snaps.pop(i))
        assert got["loss_err"] < 1e-6, got
        assert got["grad_err_median"] < 2e-2 and got["grad_err_leaf_max"] < 5e-2, got
        assert got["grad_cos_err_median"] < 1e-4 and got["grad_norm_gap_max"] < 2e-2, got
        assert got["update_err"] < 1e-4 and got["bn_stats_err"] < 1e-5, got


def test_sound_run_passes():
    out, numbers = judged()
    assert out["line"]["correct"], numbers
    assert set(numbers) == set(adapter_module().NUMBERS)


def test_control_fails():
    out, numbers = judged("control")
    assert not out["line"]["correct"], numbers


@pytest.mark.parametrize("fault", sorted(FAULTS[CELL]))
def test_fault_fails(fault, monkeypatch):
    FAULTS[CELL][fault](monkeypatch.setattr)
    out, numbers = judged()
    assert not out["line"]["correct"], numbers


def test_rate_and_judged_steps_of_a_cpu_run():
    out, _ = judged()
    res = out["result"]
    n, motion = res["calls"], 4 * 16 / 15.0  # 4 clips of 16 frames (16 x 1066 samples)
    assert res["attempted"] == n and res["failed"] == 0 and res["window_s"] >= 0.5
    assert res["end_to_end"]["train_motion_s_per_s"] == pytest.approx(
        n * motion / res["window_s"])
    assert set(out["line"]["metrics"]) == {"train_motion_s_per_s", "setup_s"}
    assert set(out["result"]["checks"]) == set(adapter_module().NUMBERS)


def test_judged_steps_follow_the_seed():
    mix = {"judge_first_of": 3, "judged_steps": 4}
    firsts = {train_loop.judged_steps(s, mix, 90)[0] for s in range(2**31, 2**31 + 40)}
    assert firsts == {0, 1, 2}
    for s in (1, 2**31 + 7, 2**40 + 3):
        picks = train_loop.judged_steps(s, mix, 90)
        assert picks == train_loop.judged_steps(s, mix, 90)
        assert len(picks) == 4 and picks == sorted(picks) and picks[-1] < 81
        assert picks[1] < 30 <= picks[2] < 56 <= picks[3]  # one in each third of the rest
    assert train_loop.judged_steps(5, mix, 0) == [0]  # a window of one step
    assert train_loop.judged_steps(5, mix, 2)[0] <= 1


def test_discovery_finds_the_held_cell_by_name():
    cell = common.find_cell(spec(), CELL)
    assert cell["mix"]["kind"] == "train_loop" and cell["config"] == "camn"
    family = cell["config_file"]["family"]
    assert (BENCH_DIR / "kinds" / "train_loop.py").is_file()
    assert (BENCH_DIR / "models" / f"{family}_train.py").is_file()
    assert {m["name"] for m in cell["end_to_end"]} == {"train_motion_s_per_s", "setup_s"}
    layers = {m["name"] for m in cell["per_layer"]}
    assert layers == {"mfu.train", "device_idle.train", "launches.train",
                      "lstm_backward_ms.train"}
    assert all((BENCH_DIR / "metrics" / f"{n}.py").is_file() for n in layers)
    assert all(m["moves"] == "train_motion_s_per_s" for m in cell["per_layer"])


@pytest.mark.parametrize("name,end_to_end,per_layer", [
    ("emage-offline-bf16", ["motion_s_per_s", "setup_s"],
     ["mfu.offline", "device_idle.offline", "ar_loop_ms.offline", "decode_ms.offline",
      "window_ms.offline", "remainder_ms.offline", "ar_self_ms.offline",
      "vq_parts_ms.offline"]),
    ("camn-offline-bf16", ["motion_s_per_s", "setup_s"],
     ["mfu.offline", "device_idle.offline", "k2_roofline.offline", "wav_encoder_ms.offline",
      "lstm_ms.offline"]),
])
def test_offline_cells_are_found_as_before(name, end_to_end, per_layer):
    cell = common.find_cell(spec(), name)
    assert cell == common.find_cell(common.load_spec(ROOT), name)
    assert cell["mix"]["kind"] == "closed_loop"
    assert [m["name"] for m in cell["end_to_end"]] == end_to_end
    assert [m["name"] for m in cell["per_layer"]] == per_layer


def reader(name):
    return common.load_module(BENCH_DIR / "metrics" / f"{name}.py", "t_" + name.replace(".", "_"))


def synthetic_profile():
    """Two profiled steps of kernels (a copy among them) and the runtime's calls."""
    host = [("cudaLaunchKernel", 110.0, 112.0), ("cudaLaunchKernel", 2120.0, 2122.0)]
    kernels = [("k1", 115.0, 130.0), ("k2", 190.0, 260.0), ("k3", 330.0, 340.0),
               ("late", 900.0, 1900.0), ("k5", 2140.0, 2400.0),
               ("Memcpy DtoH (Device -> Pinned)", 2500.0, 2510.0)]
    return {"kernels": kernels, "host": host, "wall_s": 3e-3}


def test_lstm_backward_reader_sums_a_step_and_takes_the_median():
    steps = [[10.0, 20.0], [5.0], [40.0, 1.0, 1.0]]
    ctx = {"result": {"node_ms": {"lstm_backward": steps}}}
    assert reader("lstm_backward_ms.train").read(ctx) == pytest.approx(30.0)
    for empty in ({}, {"lstm_backward": []}):
        assert reader("lstm_backward_ms.train").read({"result": {"node_ms": empty}}) is None


def test_launches_idle_and_mfu_readers():
    from harness import trace

    prof = synthetic_profile()
    summary = trace.summarize(prof)
    ctx = {"result": {"profile": prof, "profile_calls": 2, "flops_per_call": 989.4e12,
                      "calls": 3, "window_s": 6.0, "step_s_median": 2e-3},
           "summary": summary, "peaks": peaks, "precision": "bfloat16"}
    assert reader("launches.train").read(ctx) == pytest.approx(5 / 2)  # the copy left out
    busy = 15 + 70 + 10 + 1000 + 260 + 10
    assert summary["busy_s"] == pytest.approx(busy / 1e6)
    # the busy time of a profiled step over an unprofiled step's time
    assert reader("device_idle.train").read(ctx) == pytest.approx(100 * (1 - busy / 2 / 2000))
    assert reader("mfu.train").read(ctx) == pytest.approx(50.0)
    ctx["summary"] = dict(summary, kernel_count=0)
    assert reader("mfu.train").read(ctx) is None and reader("device_idle.train").read(ctx) is None


def test_tail_losses_are_judged_and_the_copies_left_out_of_the_peak():
    """The last steps' losses are judged from the ring; the peak reader subtracts the
    bytes held through each stretch."""
    out, numbers = judged()
    res = out["result"]
    a = adapter_module()
    assert res["memory_peak_bytes"] == 0  # no card
    cell = tiny_cell()
    t = a.Adapter(cell["config_file"], cell["mix"], SEED, "cpu")
    t.setup()
    t.keep_tail(2)
    assert t.held_bytes() == 2 * 4 * sum(t.numels)
    for i in range(3):
        t.keep(i)
        t.kept(i, t.call(i))
    assert sorted(i for i, _ in t.ring_loss.values()) == [1, 2]
    t.free_program()
    for slot, (i, loss) in t.ring_loss.items():
        assert t.judge_loss(i, t.ring[slot], loss) < 1e-6
        assert t.judge_loss(i, t.ring[slot], 0.5 * loss) > 0.4


def test_traced_cpu_run_reads_no_device_metric():
    out, numbers = judged(traced=True)
    assert out["line"]["correct"], numbers
    assert out["line"]["metrics"] == {}  # no kernel ran on a card
    assert out["result"]["profile_calls"] == 1 and out["result"]["flops_per_call"] > 0


def test_a_run_loads_no_jax():
    """A whole CPU run of the cell, in a fresh process, leaves no JAX module loaded, and
    the reference's training step alone loads nothing of the program."""
    code = f"""
import sys
sys.path[:0] = [{str(BENCH_DIR / 'tests')!r}, {str(BENCH_DIR)!r}, {str(ROOT)!r}]
import reference.camn_train
assert not any(m.split('.')[0] == 'pantomatrix_tpu_torch' for m in sys.modules)
import time, run
from test_bench_train import tiny_cell
from harness.common import forbidden_modules
run.run_cell(tiny_cell(), 7, 0.0, False, time.time(), device='cpu')
assert 'pantomatrix_tpu_torch' in sys.modules
print(forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1].replace("'", '"')) == []
