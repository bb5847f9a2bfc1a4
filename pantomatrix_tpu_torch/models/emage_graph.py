"""The EMAGE window step as CUDA graphs: the port's counterpart of the JAX package's
``jax.jit(_window_step)`` (``pantomatrix_tpu/serve.py::_jit_window_callables``) and of
the AR loop it compiles into one program (``pantomatrix_tpu/models/emage.py``).

Run eagerly, one full-width window step issues about 1,500 kernel launches from Python,
and at a small batch the host's launches bound the call. :class:`WindowStepGraphs`
captures a step once per key and replays it: the inputs are copied into the graph's
static buffers, the graph is replayed, and its static outputs hold the result until the
next replay of that graph overwrites them, so the caller consumes or copies them first.

- *Key* (:func:`step_key`, :func:`decode_key`): the module as called (after
  ``cast_once``, so new weights in the bf16 mode give a new module and a new key), the
  suite, the device, the dtype, the batch, the window length and whether the
  WavEncoder features are an input. A graph reads the weights where they lay when it
  was captured, so each graph also keeps the weights' storage and versions
  (``utils/precision._weights_key``): a replaced or rewritten tensor gives a fresh
  capture. One graph is kept per key without the modules' identity, so a new module
  replaces the graphs of the old one.
- *Capture*: warm-up calls on a side stream, as ``torch.cuda.graphs`` asks, then one
  capture under ``strict_fp32()`` (the TF32 and reduced-precision flags choose the
  cuBLAS and cuDNN kernels at capture time). All graphs of one cache share one memory
  pool (``torch.cuda.graph_pool_handle()``); their static inputs lie outside it, and
  every output is consumed before the next replay, so any replay order is safe.
- *Launch counters*: a kernel launched during a capture adds to its wrapper's
  ``captured`` count, not to ``launches``; each replay adds the launches its capture
  recorded, so ``launches`` counts executions on the device (warm-ups count as they
  run). The window span open around a step (``utils/trace.py``) learns whether its
  graph was replayed or captured anew.
- A failed capture or replay raises; nothing falls back to the eager step. The cache is
  not thread-safe: callers that share a model serialize their device work
  (``serve_http.MotionServer`` holds one lock for it).
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from ..nn.layers import strict_fp32
from ..ops import lstm_cuda, vq_cuda
from ..utils import trace
from ..utils.precision import _weights_key

GRAPHS_ATTR = "_window_step_graphs"  # where a model keeps its cache
WARMUP_CALLS = 2
_KERNELS = (vq_cuda, lstm_cuda)  # wrappers whose launches a replay adds to


def step_key(module, suite, motion: torch.Tensor, has_features: bool) -> tuple:
    """Key of a window step's graph: (slot, owner ids), where the slot is what the
    graph's shapes and mode depend on and the owners are the module as called and the
    suite."""
    return (("step", str(motion.device), motion.dtype, motion.shape[0], motion.shape[1],
             has_features), (id(module), id(suite)))


def decode_key(suite, net_out: Dict[str, torch.Tensor], keep: int) -> tuple:
    """Key of a chunk decode's graph: the batch, the frames kept and the latents' dtype."""
    x = net_out["rec_face"]
    return (("decode", str(x.device), x.dtype, x.shape[0], x.shape[1], keep), (id(suite),))


class _Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    owners: tuple          # ids of the modules the graph reads
    weights: tuple         # their _weights_key at capture
    inputs: Tuple[Optional[torch.Tensor], ...]
    outputs: object        # fn's result, made of the graph's static tensors
    launches: Tuple[int, ...]  # kernel launches per replay, per _KERNELS


class WindowStepGraphs:
    """One model's captured graphs, by slot (see the module docstring)."""

    def __init__(self):
        self._graphs: Dict[tuple, _Graph] = {}
        self._pool = None

    def __deepcopy__(self, memo):
        # a copy of the model (utils/precision.cast_floating) starts with no graphs
        return WindowStepGraphs()

    def __len__(self) -> int:
        return len(self._graphs)

    def run(self, key: tuple, fn: Callable, inputs: Sequence[Optional[torch.Tensor]],
            owners: Sequence[torch.nn.Module]):
        """``fn(*inputs)`` by replaying its graph, captured first when the key's slot
        holds none, or one of other owners or weights. ``inputs`` are CUDA tensors (or
        None, passed through); ``owners`` the modules ``fn`` reads. Returns the graph's
        static outputs."""
        slot, owner_ids = key
        weights = tuple(_weights_key(m) for m in owners)
        g = self._graphs.get(slot)
        captured = g is None or g.owners != owner_ids or g.weights != weights
        if captured:
            self._graphs.pop(slot, None)  # free the old graph's memory before capturing
            g = self._graphs[slot] = self._capture(fn, inputs, owner_ids, weights)
        trace.annotate("emage.window", graph="captured" if captured else "replayed")
        with torch.inference_mode(False), torch.no_grad():
            for buf, x in zip(g.inputs, inputs):
                if buf is not None:
                    buf.copy_(x)
            g.graph.replay()
        for kernel, n in zip(_KERNELS, g.launches):
            kernel.launches += n
        return g.outputs

    def _capture(self, fn, inputs, owner_ids, weights) -> _Graph:
        device = next(x.device for x in inputs if x is not None)
        with torch.inference_mode(False), torch.no_grad():
            # static inputs outside the pool, holding the first call's values
            static = tuple(None if x is None else x.clone() for x in inputs)
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with strict_fp32(), torch.cuda.stream(side):
                for _ in range(WARMUP_CALLS):
                    fn(*static)
            torch.cuda.current_stream(device).wait_stream(side)
            before = tuple(k.captured for k in _KERNELS)
            graph = torch.cuda.CUDAGraph()
            with strict_fp32(), torch.cuda.graph(graph, pool=self._pool):
                outputs = fn(*static)
        launches = tuple(k.captured - b for k, b in zip(_KERNELS, before))
        return _Graph(graph, owner_ids, weights, static, outputs, launches)


def graphs_of(model: torch.nn.Module) -> WindowStepGraphs:
    """The model's graph cache, made on first use and kept on the model."""
    cache = model.__dict__.get(GRAPHS_ATTR)
    if cache is None:
        cache = model.__dict__[GRAPHS_ATTR] = WindowStepGraphs()
    return cache


__all__ = ["GRAPHS_ATTR", "WARMUP_CALLS", "WindowStepGraphs", "decode_key", "graphs_of",
           "step_key"]
