"""Spans at the layer boundaries of the port's paths, on the profiler's clock.

``span(name, tensor=None, **attrs)`` is a context manager that records only while a
``torch.profiler`` is recording; otherwise it makes one check and does nothing. There is
no other switch: an operator who profiles a run gets the spans in the trace, and
``spans()`` gives them to a program that profiled itself.

When on, a span
- enters a host-only record function (``torch._C._profiler._RecordFunctionFast``, not a
  user annotation, of which the profiler would also put a device-typed copy among the
  kernels), so it lies on the profiler's clock beside the kernels and a device idle gap
  can be put down to the span open at that moment;
- where ``tensor`` is a CUDA tensor and the current stream is not capturing a CUDA graph,
  records a pair of timing CUDA events on the current stream of ``tensor``'s device, for
  the span's device time;
- keeps its name, its attributes, its parent span, the call id shared by every span under
  one root, and its host start and end (``time.perf_counter_ns``).

While a CUDA graph is captured a span does nothing, since a replay runs none of it.
``annotate(name, **attrs)`` adds attributes to the innermost open span if it is ``name``
(what a span learns only inside, such as whether a window's graph was replayed).

The store is per process and holds at most ``MAX_SPANS`` spans; ``dropped()`` counts the
spans that found it full. ``spans()`` synchronises on each span's end event, resolves its
device ms and returns plain dicts; ``clear()`` empties the store. Nothing is written to
disk.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import List, Optional

import torch

MAX_SPANS = 100_000

_profiling = torch._C._autograd._profiler_enabled
_record_function = getattr(torch._C._profiler, "_RecordFunctionFast", None)
_ids = itertools.count(1)
_local = threading.local()  # the open spans of each thread
_lock = threading.Lock()
_store: list = []
_dropped = 0


class _Off:
    """What ``span`` returns while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _capturing() -> bool:
    return torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing()


def _open() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("id", "name", "attrs", "parent", "call", "host_start_ns", "host_end_ns",
                 "device_ms", "_stream", "_events", "_record")

    def __init__(self, name: str, tensor: Optional[torch.Tensor], attrs: dict):
        self.name, self.attrs, self.device_ms = name, attrs, None
        self._stream = (torch.cuda.current_stream(tensor.device)
                        if tensor is not None and tensor.is_cuda else None)
        self._events = None
        self._record = None

    def __enter__(self):
        stack = _open()
        parent = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = parent.id if parent is not None else None
        self.call = parent.call if parent is not None else self.id
        stack.append(self)
        if _record_function is not None:
            self._record = _record_function(self.name)
            self._record.__enter__()
        self.host_start_ns = time.perf_counter_ns()
        if self._stream is not None:
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record(self._stream)
        return self

    def __exit__(self, *exc):
        if self._events is not None:
            self._events[1].record(self._stream)
        self.host_end_ns = time.perf_counter_ns()
        if self._record is not None:
            self._record.__exit__(None, None, None)
            self._record = None
        _open().pop()
        _keep(self)
        return False


def _keep(s: _Span) -> None:
    global _dropped
    with _lock:
        if len(_store) < MAX_SPANS:
            _store.append(s)
        else:
            _dropped += 1


def span(name: str, tensor: Optional[torch.Tensor] = None, **attrs):
    """A span named ``name`` with ``attrs``, timed on the device of ``tensor`` when that
    is a CUDA tensor; a no-op unless a profiler records and no graph is being captured."""
    if not _profiling() or _capturing():
        return _OFF
    return _Span(name, tensor, attrs)


def annotate(name: str, **attrs) -> None:
    """Add ``attrs`` to the innermost open span, if it is named ``name``."""
    stack = getattr(_local, "stack", None) if _profiling() else None
    if stack and stack[-1].name == name:
        stack[-1].attrs.update(attrs)


def spans() -> List[dict]:
    """Every span kept, oldest first: ``id``, ``name``, ``attrs``, ``parent`` (an id or
    None), ``call`` (its root's id), ``host_start_ns``, ``host_end_ns`` and ``device_ms``
    (None for a span timed on no CUDA tensor)."""
    with _lock:
        kept = list(_store)
    out = []
    for s in kept:
        if s._events is not None:
            s._events[1].synchronize()
            s.device_ms = s._events[0].elapsed_time(s._events[1])
            s._events = s._stream = None
        out.append({"id": s.id, "name": s.name, "attrs": dict(s.attrs), "parent": s.parent,
                    "call": s.call, "host_start_ns": s.host_start_ns,
                    "host_end_ns": s.host_end_ns, "device_ms": s.device_ms})
    return out


def dropped() -> int:
    """Spans not kept because the store held ``MAX_SPANS``."""
    return _dropped


def clear() -> None:
    """Empty the store and its count of dropped spans."""
    global _dropped
    with _lock:
        _store.clear()
        _dropped = 0


__all__ = ["MAX_SPANS", "annotate", "clear", "dropped", "span", "spans"]
