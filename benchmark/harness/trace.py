"""Reading a ``torch.profiler`` trace of a bounded stretch: device kernels, busy time as
the union of kernel intervals, the top device operations, and the longest idle gaps
labelled by what the host was running then."""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch


def merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of [start, end) intervals, as sorted disjoint intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(busy: List[Tuple[float, float]], start: float, end: float):
    """Idle intervals inside [start, end) between the merged busy intervals."""
    out, cur = [], start
    for s, e in busy:
        if s > cur:
            out.append((cur, min(s, end)))
        cur = max(cur, e)
    if end > cur:
        out.append((cur, end))
    return [(s, e) for s, e in out if e > s]


def profile(fn: Callable[[], None]) -> dict:
    """Run ``fn`` (which ends in a device synchronisation) under the profiler and return
    the stretch: kernel events as (name, start_us, end_us), host events likewise, and
    the stretch's host wall time."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    kernels, host = [], []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((e.name, float(tr.start), float(tr.end)))
        else:
            host.append((e.name, float(tr.start), float(tr.end)))
    return {"kernels": kernels, "host": host, "wall_s": wall}


def summarize(stretch: dict, top: int = 10) -> Dict[str, object]:
    """busy_s, window_s, and the breakdown: device operations by total time and idle gaps
    summed by the innermost host operation running at each gap's middle."""
    kernels, host = stretch["kernels"], stretch["host"]
    busy_iv = merge([(s, e) for _, s, e in kernels])
    busy_s = sum(e - s for s, e in busy_iv) / 1e6
    by_name: Dict[str, float] = {}
    for name, s, e in kernels:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = []
    if host:
        starts = np.array([s for _, s, _ in host])
        ends = np.array([e for _, _, e in host])
        longest = sorted(gaps(busy_iv, starts.min(), ends.max()),
                         key=lambda g: g[0] - g[1])[:200]
        by_host: Dict[str, float] = {}
        for gs, ge in longest:
            mid = 0.5 * (gs + ge)
            inside = np.flatnonzero((starts <= mid) & (ends > mid))
            label = (host[inside[np.argmin(ends[inside] - starts[inside])]][0]
                     if inside.size else "(no host operation)")
            by_host[label] = by_host.get(label, 0.0) + (ge - gs) / 1e6
        idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": busy_s, "window_s": stretch["wall_s"], "kernel_count": len(kernels),
            "device_ops": [[n, v] for n, v in ops], "idle_gaps": [[n, v] for n, v in idle]}

