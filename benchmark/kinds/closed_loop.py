"""A closed loop: one caller sends work back to back, each call forced to complete before
the next starts, as an animation pipeline runs a model over batches of takes.

The mix (``traffic/<mix>.json``) gives the batch, the clip length, the serving mode, the
number of distinct input batches the loop cycles through, the calls that warm up every
shape, the traced stretch and the limits of the correctness check. The model's adapter
(``models/<family>.py``, named by the configuration's file) makes the weights, the
inputs, the program and the reference, and judges a call's outputs.

``--trace 0``: the window runs calls until ``--seconds`` have passed at a call's end;
the adapter's rate (its ``rate_metric``, ``motion_s_per_s`` for generation) is the
motion of every call completed over the whole window.
``--trace 1``: a stretch of calls with synchronised spans (``--seconds`` long), then a
few calls under the profiler; the per-layer metrics read both.
"""
from __future__ import annotations

import random
import sys
import time

import torch

from harness import trace


def sample_index(seed: int, mix: dict) -> int:
    """Which call of the window is judged, drawn from the seed."""
    return random.Random(int(seed)).randrange(int(mix.get("judge_one_of_first", 3)))


def run(adapter, seed: int, seconds: float, traced: bool, t_process: float) -> dict:
    mix = adapter.mix
    t_setup = time.perf_counter()
    adapter.setup()
    adapter.sync()
    t_warm = time.perf_counter()
    warmup = int(mix["warmup_calls"])
    for i in range(warmup):
        adapter.complete(adapter.call(i))
    adapter.sync()
    parts = ", ".join(f"{name} {t - t0:.3f}" for (_, t0), (name, t) in
                      zip(adapter.phases, adapter.phases[1:]))
    log(f"setup: {time.perf_counter() - t_warm:.3f} s warm-up after "
        f"{t_warm - t_setup:.3f} s of weights, inputs and program ({parts} s)")
    judged = sample_index(seed, mix)
    kept = None
    spans = {"call": []}
    t0 = time.perf_counter()
    setup_s = time.time() - t_process
    n = 0
    while True:
        # calls are numbered on from the warm-up's: call i takes input i (cycled)
        if traced:
            out = adapter.timed_call(warmup + n, spans)
        else:
            out = adapter.call(warmup + n)
            adapter.complete(out)
        if n == judged or kept is None and n > judged:
            kept = (warmup + n, out)
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    if kept is None:  # the window ended before the judged call: judge the last
        kept = (warmup + n - 1, out)
    del out
    result = {"attempted": n, "failed": 0, "window_s": window_s, "setup_s": setup_s,
              "calls": n, "spans": spans,
              "end_to_end": {adapter.rate_metric: n * adapter.motion_seconds_per_call / window_s}}
    if traced:
        calls = int(mix.get("trace_calls", 1))

        def stretch():
            for i in range(calls):
                adapter.complete(adapter.call(warmup + n + i))
            adapter.sync()

        prof = trace.profile(stretch)
        result["profile"] = prof
        result["profile_calls"] = calls
    result["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(adapter.device)
                                   if adapter.device.type == "cuda" else 0)
    index, outputs = kept
    adapter.free_program()
    t_check = time.perf_counter()
    result["checks"], result["flops_per_call"] = adapter.check(index, outputs,
                                                               count_flops=traced)
    log(f"window: {n} calls in {window_s:.3f} s; check of call {index}: "
        f"{time.perf_counter() - t_check:.3f} s")
    return result


def log(msg: str) -> None:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
