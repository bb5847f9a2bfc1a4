"""What the port's profiling scripts share: the card's name, importing the port from another
checkout, record functions around modules, kernels put down to the record functions open
at their launch, and CUDA-event timing. Imports nothing of JAX or pantomatrix_tpu.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

SCOPES = ("mod|", "fn|")


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    query = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    return subprocess.run(query, capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]


def import_root(root: str) -> str:
    """Import ``pantomatrix_tpu_torch`` from the checkout at ``root`` (a parent commit
    unpacked with ``git archive``, say); returns its resolved path."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this script measures the port on an NVIDIA GPU")
    path = str(Path(root).resolve())
    sys.path.insert(0, path)
    return path


def scope_modules(model: torch.nn.Module, prefix: str = "", strides: dict | None = None):
    """A record function ``mod|<prefix><qualified name>|<class>`` around every module's
    forward, and, given ``strides``, each module's first input shape and strides there by
    qualified name. Returns the hooks' undo callables."""
    stack, undo = [], []

    def pre(name):
        def hook(mod, args):
            if strides is not None and name not in strides and args and isinstance(
                    args[0], torch.Tensor):
                strides[name] = {"class": type(mod).__name__, "shape": list(args[0].shape),
                                 "stride": list(args[0].stride())}
            rf = torch.autograd.profiler.record_function(
                f"mod|{prefix}{name}|{type(mod).__name__}")
            rf.__enter__()
            stack.append(rf)
        return hook

    def post(mod, args, out):
        stack.pop().__exit__(None, None, None)

    for name, mod in model.named_modules():
        undo += [mod.register_forward_pre_hook(pre(name or "<root>")).remove,
                 mod.register_forward_hook(post).remove]
    return undo


def attribute(prof, key, fields: tuple) -> list:
    """Device ms and kernel count of each ``key(scopes, outer, op, kernel_name)``, a tuple
    named by ``fields``, largest first. ``scopes`` are the ``mod|``/``fn|`` record functions
    around the launching op ``op``, innermost first (the op itself where it is one);
    ``outer`` is the op just inside the innermost scope."""
    rows = {}
    for e in prof.events():
        if not e.kernels:
            continue
        scopes, outer, node = [], e.name, e
        while node is not None:
            if node.name.startswith(SCOPES):
                scopes.append(node.name)
            elif not scopes:
                outer = node.name
            node = node.cpu_parent
        for k in e.kernels:
            r = rows.setdefault(key(scopes, outer, e.name, k.name[:90]), [0.0, 0])
            r[0] += k.duration / 1e3
            r[1] += 1
    out = [dict(zip(fields, k), ms=ms, count=n) for k, (ms, n) in rows.items()]
    return sorted(out, key=lambda r: -r["ms"])


def summarize(rows: list, key) -> dict:
    """Device ms of the rows by ``key(row)``, largest first."""
    total = {}
    for r in rows:
        total[key(r)] = total.get(key(r), 0.0) + r["ms"]
    return dict(sorted(total.items(), key=lambda kv: -kv[1]))


def profiled(fn, warmup: int = 0):
    """``fn`` once under ``torch.profiler`` (CPU and CUDA), after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return prof


def time_ms(fn, reps: int) -> float:
    """Mean ms of ``fn`` over ``reps`` back-to-back calls between two CUDA events, after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
