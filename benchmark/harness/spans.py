"""The program's own spans of the profiled stretch (``pantomatrix_tpu_torch/utils/trace.py``),
as the per-layer readers of ``program_span`` metrics take them.

The program records spans only while a profiler records, so what its store holds after a
``--trace 1`` run is the profiled stretch's spans: 1 EMAGE call, 5 CaMN calls. Each span
is a dict with its ``name``, ``attrs``, ``parent`` and ``call`` (its root's id) and its
device time ``device_ms``, between CUDA events on the stream it ran on. A program without
the recorder (an older checkout) gives None, and so does every reader then."""
from __future__ import annotations

import statistics
from typing import List, Optional


def recorded() -> Optional[List[dict]]:
    """The program's spans, or None where the program records none."""
    try:
        from pantomatrix_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.spans() or None


def named(spans: Optional[List[dict]], name: str) -> List[dict]:
    return [s for s in spans or () if s["name"] == name]


def device_ms(span_list: List[dict]) -> Optional[List[float]]:
    """The spans' device ms, or None if any span was timed on no device."""
    out = [s["device_ms"] for s in span_list]
    return None if not out or any(v is None for v in out) else out


def median_ms(spans: Optional[List[dict]], name: str, **attrs) -> Optional[float]:
    """The median device ms of the spans ``name`` whose attributes hold ``attrs``."""
    times = device_ms([s for s in named(spans, name)
                       if all(s["attrs"].get(k) == v for k, v in attrs.items())])
    return statistics.median(times) if times else None


def median_sum_ms(spans: Optional[List[dict]], root: str, child: str,
                  direct: bool = False) -> Optional[float]:
    """The median over the spans ``root`` of the summed device ms of the spans ``child``
    of the root's call, or with ``direct`` of those whose parent it is; None where a root
    has none."""
    sums = []
    for r in named(spans, root):
        times = device_ms([s for s in named(spans, child)
                           if (s["parent"] if direct else s["call"]) == r["id"]])
        if times is None:
            return None
        sums.append(sum(times))
    return statistics.median(sums) if sums else None
