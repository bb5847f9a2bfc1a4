"""A training loop: one optimizer step after another on one card, each forced to complete
(a host copy of its loss, as a training loop's logging reads it), over a few distinct
batches made on the card and cycled, as researchers train a model step after step.

The mix (``traffic/<mix>.json``) gives the batch, the clip length, the compute dtype, the
optimizer's settings, the number of distinct batches, the warm-up steps, the steps judged,
the profiled steps and the limits of the check. The training adapter is
``models/<family>_train.py`` (the configuration's family with ``_train``): it makes the
weights, the batches, the program's step and the reference, copies the program's state
around each judged step, and judges those steps once the window has closed. (The adapter
that ``run.py`` builds from ``models/<family>.py`` only carries the cell's settings here.)

Judged: the warm-up steps as a start the reference follows from the seed on its own; the
first warm-up step (from the seed's own state), then ``judged_steps`` steps of the window:
one of its first ``judge_first_of``, the others one in each equal stretch of the rest of
the window (to nine tenths of the steps the last warm-up step's time predicts), each drawn
from the seed; and the losses of the window's last ``judged_tail`` steps, from the
parameters each started from (copied on the card into a ring of that many slots before
every step of the window).

The copies are made inside the window: their host and device time is logged, and the
memory peak leaves them out (the peak of each stretch between two changes to the copies
held, less the bytes then held).

``--trace 0``: steps until ``--seconds`` have passed at a step's end; the rate is the
motion of every step completed over the whole window. Each step's host time goes to
standard error, with the process's CPU seconds a second over the window (how much of the
window it held a core).
``--trace 1``: a stretch of synchronised steps (``--seconds`` long), in which the adapter
may time parts of a step with CUDA events (``node_ms``); then ``trace_calls`` steps under
the profiler, with the device and the runtime's calls alone (the busy time, the
breakdown and the kernels a step).
"""
from __future__ import annotations

import contextlib
import gc
import random
import statistics
import sys
import time

import torch

from harness import common


def judged_steps(seed: int, mix: dict, expected: int) -> list:
    """The window's steps (counted from 0) to judge, drawn from the seed."""
    rng = random.Random(int(seed))
    first = min(rng.randrange(int(mix["judge_first_of"])), max(expected - 1, 0))
    picks = [first]
    rest = int(mix["judged_steps"]) - 1
    end = int(0.9 * expected)
    width = (end - first - 1) / rest if rest else 0
    for j in range(rest):
        lo, hi = first + 1 + int(j * width), first + 1 + int((j + 1) * width)
        if hi > lo:
            picks.append(rng.randrange(lo, hi))
    return sorted(set(picks))


class Peak:
    """The device memory peak less the check's copies: each stretch between two changes
    to the copies held is closed with the bytes held through it."""

    def __init__(self, device):
        self.cuda, self.device, self.bytes = device.type == "cuda", device, 0

    def close(self, held: int) -> None:
        if self.cuda:
            self.bytes = max(self.bytes, torch.cuda.max_memory_allocated(self.device) - held)
            torch.cuda.reset_peak_memory_stats(self.device)


class Copies:
    """Host seconds and device events of the copies made in the window."""

    def __init__(self, trainer, peak: Peak):
        self.trainer, self.peak, self.host_s, self.events = trainer, peak, [], []

    def __call__(self, fn, *args):
        t = self.trainer
        self.peak.close(t.held_bytes())
        cuda = t.device.type == "cuda"
        if cuda:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
        t0 = time.perf_counter()
        fn(*args)
        self.host_s.append(time.perf_counter() - t0)
        if cuda:
            b.record()
            self.events.append((a, b))
        self.peak.close(t.held_bytes())

    def summary(self) -> str:
        dev = [a.elapsed_time(b) for a, b in self.events]
        if not self.host_s:
            return "none"
        return (f"{len(self.host_s)}, host ms median {1e3 * statistics.median(self.host_s):.3f}"
                f" max {1e3 * max(self.host_s):.3f}"
                + (f", device ms median {statistics.median(dev):.3f} max {max(dev):.3f}"
                   if dev else ""))


def profile(fn) -> dict:
    """Run ``fn`` (which ends in a device synchronisation) under the profiler with the
    device and the runtime's calls alone: kernels (name, start us, end us), the runtime's
    calls as host events, and the stretch's host wall time. Recording each of a step's
    host operations as well would take the profiler some microseconds each, several times
    a step of ~60k launches. The profiler's raw events are read, not its Python event
    tree, which takes minutes to build over a step of tens of thousands of kernels; the
    device's copies of host ranges (user annotations) are not kernels."""
    acts = [torch.profiler.ProfilerActivity.CUDA] if torch.cuda.is_available() else \
        [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    raw = prof.profiler.kineto_results
    base = raw.trace_start_ns()
    kernels, host = [], []
    for e in raw.events():
        name, start, end = e.name(), (e.start_ns() - base) / 1e3, (e.end_ns() - base) / 1e3
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                kernels.append((name, start, end))
        else:
            host.append((name, start, end))
    return {"kernels": kernels, "host": host, "wall_s": wall}


def run(adapter, seed: int, seconds: float, traced: bool, t_process: float) -> dict:
    family = adapter.config["family"]
    module = common.load_module(common.BENCH_DIR / "models" / f"{family}_train.py",
                                f"bench_model_{family}_train")
    trainer = module.Adapter(adapter.config, adapter.mix, seed, adapter.device,
                             adapter.program)
    mix = trainer.mix
    peak = Peak(trainer.device)
    t_setup = time.perf_counter()
    trainer.setup()
    trainer.sync()
    peak.close(0)
    tail = int(mix.get("judged_tail", 0))
    trainer.keep_tail(tail)
    copies, ring = Copies(trainer, peak), Copies(trainer, peak)
    t_warm = time.perf_counter()
    warmup = int(mix["warmup_calls"])
    step_s = 0.0
    for i in range(warmup):
        t0 = time.perf_counter()
        if i == 0:
            copies(trainer.before, 0, True)
        if tail:  # the ring's first copy is slow (tens of ms): make it here
            trainer.keep(i)
        out = trainer.call(i)
        trainer.complete(out)
        if i == 0:
            copies(trainer.after, 0, out)
        trainer.warmed(i, out, last=i == warmup - 1)
        step_s = time.perf_counter() - t0
    trainer.sync()
    parts = ", ".join(f"{name} {t - t0:.3f}" for (_, t0), (name, t) in
                      zip(trainer.phases, trainer.phases[1:]))
    log(f"setup: {time.perf_counter() - t_warm:.3f} s warm-up after "
        f"{t_warm - t_setup:.3f} s of weights, inputs and program ({parts} s)")
    judged = judged_steps(seed, mix, int(seconds / step_s) if step_s > 0 else 0)
    copies.host_s.clear()
    copies.events.clear()
    gc.collect()
    gc.freeze()
    spans = {"call": []}
    ends = []
    timing = trainer.timing() if traced else contextlib.nullcontext()
    cpu_s = time.process_time()
    t0 = time.perf_counter()
    setup_s = time.time() - t_process
    n = 0
    with timing:
        while True:
            i = warmup + n
            # every step up to the first judged one is copied, and the one before dropped,
            # so that a window that ends before that step judges its last
            copied = n in judged or n < judged[0]
            if copied:
                copies(trainer.before, i)
            if tail:
                ring(trainer.keep, i)
            if traced:
                out = trainer.timed_call(i, spans)
            else:
                out = trainer.call(i)
                trainer.complete(out)
            if tail:
                trainer.kept(i, out)
            if copied:
                copies(trainer.after, i, out)
                if 0 < n <= judged[0]:
                    copies(trainer.snaps.pop, i - 1)
            n += 1
            ends.append(time.perf_counter())
            if ends[-1] - t0 >= seconds:
                break
    window_s = ends[-1] - t0
    cpu_s = (time.process_time() - cpu_s) / window_s
    del out
    gc.unfreeze()
    times = [b - a for a, b in zip([t0] + ends, ends)]
    log(f"window: {n} steps in {window_s:.3f} s; judged steps {sorted(trainer.snaps)} "
        f"({warmup} warm-up) and the last {tail}; step host s: median "
        f"{statistics.median(times):.4f} min {min(times):.4f} max {max(times):.4f}, each "
        + " ".join(f"{t:.4f}" for t in times))
    log(f"copies in the window: {copies.summary()}; into the ring: {ring.summary()}")
    log(f"host in the window: process CPU s a second {cpu_s:.3f}")
    result = {"attempted": n, "failed": 0, "window_s": window_s, "setup_s": setup_s,
              "calls": n, "spans": spans, "step_s_median": statistics.median(times),
              "node_ms": trainer.node_ms if traced else {},
              "end_to_end": {trainer.rate_metric:
                             n * trainer.motion_seconds_per_call / window_s}}
    if traced:
        calls = int(mix.get("trace_calls", 1))

        def stretch():
            for k in range(calls):
                trainer.complete(trainer.call(warmup + n + k))
            trainer.sync()

        result["profile"] = profile(stretch)
        result["profile_calls"] = calls
    peak.close(trainer.held_bytes())
    result["memory_peak_bytes"] = peak.bytes
    log(f"memory peak {peak.bytes} bytes without the check's copies "
        f"({trainer.held_bytes()} bytes of them held at the end)")
    trainer.free_program()
    t_check, judged = time.perf_counter(), len(trainer.snaps)
    result["checks"], result["flops_per_call"] = trainer.check(count_flops=traced)
    log(f"check of {judged} steps and the last {tail}: {time.perf_counter() - t_check:.3f} s")
    return result


def log(msg: str) -> None:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
