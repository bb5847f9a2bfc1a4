"""Process meshes and the placement of the train state over them (counterpart of
``pantomatrix_tpu/train/mesh.py``), over ``torch.distributed``: one card a process, NCCL
between cards, gloo on the CPU (and where processes share a card).

Data parallel: every process holds the whole model, reads its own block of each global
batch (``data.train_bs`` is the global batch; the loaders take ``process_index`` and
``process_count``), and the step averages the gradients over the processes with a few
flattened all-reduces (:func:`reduce_gradients`) between the backward and the update. The
train steps call the model through ``torch.func.functional_call``, under which
``DistributedDataParallel``'s hooks never arm, so the reduction is the port's own
collective. BatchNorm, dropout and the terms that couple rows see the global batch
inside the step's :func:`data_sharding` scope (``utils/distributed.py``), so the job
computes what one process computes on the global batch.

FSDP (``solver.fsdp_model_axis = M > 1``): a 2-D ``("data", "model")`` mesh of
``(world // M, M)``. :class:`FsdpOptimizer` holds each parameter that :func:`fsdp_spec`
shards, and its optimizer moments, as this process's slice along the model axis; the
step gathers the parameters for the forward, averages the full gradients over every
process, clips them as one process would, keeps its slices, updates them and frees the
gathered parameters. Every process still reads its own rows, so the model axis adds
no data replicas. What is sharded is the state at rest, the parameters between steps
and the optimizer moments; the gradients are not: every process computes and all-reduces
the full gradients and then keeps its slices, so peak memory holds the full parameters,
the full gradients and the gather's buffer. The gather is an all-reduce of a zero-filled
(M x numel) buffer plus a copy out, and the gradients' all-reduce stands in for a
reduce-scatter, so each collective carries about twice the bytes of its native form.
That keeps to the two collectives gloo serves for CUDA tensors; NCCL's
``all_gather_into_tensor`` / ``reduce_scatter_tensor`` wait for a multi-card
measurement of this path.

Without a process group everything here is the single-process path: no collective runs.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..utils.distributed import BatchShard, flat_all_reduce, local_rows


def maybe_init_distributed(device="cuda") -> Tuple[int, int]:
    """Start the process group when the launch asks for one; returns (rank, world).

    Launch modes, checked in order:
    - ``PANTO_COORDINATOR=<host:port> PANTO_NUM_PROCESSES=<n> PANTO_PROCESS_ID=<rank>``
      (the JAX package's variables);
    - torchrun's ``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/``MASTER_ADDR``/``MASTER_PORT``,
      also what ``PANTO_DISTRIBUTED=1`` reads;
    - otherwise one process: nothing starts and (0, 1) is returned.

    ``device`` is the CLI's ``--device``: a CPU run talks gloo, a CUDA run takes its card
    and backend from :func:`backend_and_card`.
    """
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = os.environ
    if env.get("PANTO_COORDINATOR") and env.get("PANTO_NUM_PROCESSES"):
        init = f"tcp://{env['PANTO_COORDINATOR']}"
        world, rank = int(env["PANTO_NUM_PROCESSES"]), int(env["PANTO_PROCESS_ID"])
    elif env.get("PANTO_DISTRIBUTED") or ("RANK" in env and "WORLD_SIZE" in env):
        init = "env://"
        world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
    else:
        return 0, 1
    cuda = torch.device(device).type == "cuda"
    backend, card = backend_and_card(cuda, world, rank, env,
                                     torch.cuda.device_count() if cuda else 0)
    if card is not None:
        torch.cuda.set_device(card)
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank)
    where = f"cuda:{card}" if card is not None else "cpu"
    print(f"process group: rank {rank} of {world}, backend {backend}, device {where}")
    return rank, world


def backend_and_card(cuda: bool, world: int, rank: int, env, cards: int
                     ) -> Tuple[str, Optional[int]]:
    """(backend, card index) of a process of ``world`` on a host with ``cards`` cards.

    On the CPU: gloo, no card. On CUDA: NCCL on card ``LOCAL_RANK``, one card a process.
    The launch may say that this host runs more processes than it has cards
    (``LOCAL_WORLD_SIZE`` > ``cards``, with ``LOCAL_RANK``): then they share the cards
    (``LOCAL_RANK`` modulo the cards) and talk gloo, which NCCL refuses. Without
    ``LOCAL_WORLD_SIZE`` a job of at most ``cards`` processes is taken to run on this
    host, ``LOCAL_RANK`` defaulting to the rank; a larger one raises, since it cannot
    tell several hosts from processes sharing cards."""
    if not cuda:
        return "gloo", None
    if cards == 0:
        raise RuntimeError("device 'cuda' requested but CUDA is not available; "
                           "pass --device cpu to train on the CPU")
    local_world, local_rank = env.get("LOCAL_WORLD_SIZE"), env.get("LOCAL_RANK")
    if local_world is None:
        if world > cards:
            raise RuntimeError(
                f"{world} processes and {cards} card(s) on this host: set LOCAL_RANK and "
                "LOCAL_WORLD_SIZE (this host's processes) for a job over several hosts "
                "or for processes that share cards")
        return "nccl", int(local_rank if local_rank is not None else rank)
    if local_rank is None:
        raise RuntimeError("LOCAL_WORLD_SIZE is set but LOCAL_RANK is not")
    local_world, local_rank = int(local_world), int(local_rank)
    if local_world > cards:
        return "gloo", local_rank % cards
    return "nccl", local_rank


def data_axis_size(batch_size: int, devices: int) -> int:
    """The largest process count up to ``devices`` that divides the global batch: every
    process must read an equal block (the JAX package's ``make_data_mesh`` shrinks its
    mesh so)."""
    n = max(int(devices), 1)
    while n > 1 and batch_size % n:
        n -= 1
    return n


def _process_main(rank: int, world: int, port: int, device: str, threads: int, fn, args,
                  results) -> None:
    torch.set_num_threads(threads)
    # every process runs on this host: with fewer cards than processes they share them
    os.environ.update(PANTO_COORDINATOR=f"localhost:{port}", PANTO_NUM_PROCESSES=str(world),
                      PANTO_PROCESS_ID=str(rank), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    maybe_init_distributed(device)
    try:
        results.put((rank, fn(*args)))
    finally:
        dist.destroy_process_group()


def run_processes(fn, world: int, device: str, args=(), timeout_s: float = 600.0,
                  threads: int = 1, what: str = "run_processes") -> list:
    """``fn(*args)`` in ``world`` spawned processes of one process group on this host
    (the ``PANTO_*`` variables on a free localhost port; :func:`maybe_init_distributed`
    picks NCCL or gloo and each process's card), each at ``threads`` CPU threads.
    Returns every rank's return value, in rank order (``fn`` and the values must
    pickle). Raises as soon as a process fails, or when they have not all returned
    within ``timeout_s``; every process is stopped before it returns."""
    import queue as queue_mod
    import socket
    import time

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_process_main,
                         args=(r, world, port, device, threads, fn, tuple(args), q))
             for r in range(world)]
    for p in procs:
        p.start()
    results, deadline = {}, time.monotonic() + timeout_s
    try:
        while len(results) < world:
            try:
                rank, out = q.get(timeout=1.0)
                results[rank] = out
                continue
            except queue_mod.Empty:
                pass
            codes = [p.exitcode for p in procs]
            if any(c not in (None, 0) for c in codes):
                raise RuntimeError(f"{what}: a process failed, exit codes {codes}")
            if time.monotonic() > deadline:
                raise RuntimeError(f"{what}: {len(results)} of {world} processes returned "
                                   f"within {timeout_s} s")
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise RuntimeError(f"{what}: exit codes {codes}")
    return [results[r] for r in range(world)]


def _visible_devices() -> int:
    """The devices a mesh can span: one card (or CPU) a process."""
    return dist.get_world_size() if dist.is_initialized() else 1


class Mesh:
    """A grid of processes with named axes, the counterpart of ``jax.sharding.Mesh``:
    ``shape`` maps each axis to its size, ``coord(axis)`` is this process's position on
    it, ``group(axis)`` the process group along it through this process (from a
    ``torch.distributed.device_mesh.DeviceMesh``) and ``world_group`` all processes.
    Without a process group (one process) the groups are None and nothing is
    communicated. Ranks fill the grid in row-major order."""

    def __init__(self, axis_names: Sequence[str], axis_sizes: Sequence[int],
                 device_mesh=None, rank: int = 0):
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, (int(s) for s in axis_sizes)))
        self.device_mesh = device_mesh
        self.rank = rank
        self.world = 1
        for s in self.shape.values():
            self.world *= s

    @property
    def distributed(self) -> bool:
        return self.device_mesh is not None

    @property
    def world_group(self):
        return dist.group.WORLD if self.distributed else None

    def group(self, axis: str):
        return self.device_mesh.get_group(axis) if self.distributed else None

    def coord(self, axis: str) -> int:
        stride = 1
        for name in reversed(self.axis_names):
            if name == axis:
                return (self.rank // stride) % self.shape[name]
            stride *= self.shape[name]
        raise KeyError(axis)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def make_mesh(n_devices: Optional[int] = None, axis_names: Sequence[str] = ("data",),
              axis_sizes: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh over the processes (one device each). Under a process group it spans them
    all and holds a DeviceMesh whose groups are the axes' (``init_device_mesh``: NCCL
    groups for a NCCL job, gloo ones otherwise)."""
    visible = _visible_devices()
    if n_devices is None:
        n_devices = visible
    if n_devices > visible:
        raise ValueError(f"asked for {n_devices} devices, only {visible} visible")
    if dist.is_initialized() and n_devices != visible:
        raise ValueError(f"a mesh spans every process: asked for {n_devices} of {visible}")
    if axis_sizes is None:
        axis_sizes = [n_devices] + [1] * (len(axis_names) - 1)
    total = 1
    for s in axis_sizes:
        total *= int(s)
    if total != n_devices:
        raise ValueError(
            f"axis_sizes {tuple(axis_sizes)} (product {total}) must multiply out to "
            f"the device count {n_devices} — e.g. 8 devices support (4, 2) or (2, 4), "
            f"not (3, 2)"
        )
    if not dist.is_initialized():
        return Mesh(axis_names, axis_sizes)
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(device_type, tuple(int(s) for s in axis_sizes),
                          mesh_dim_names=tuple(axis_names))
    return Mesh(axis_names, axis_sizes, dm, dist.get_rank())


def make_data_mesh(batch_size: int, axis: str = "data") -> Mesh:
    """A 1-D mesh over the processes; the global batch must divide over them (every
    process reads ``batch_size // world`` rows)."""
    n = _visible_devices()
    if n > 1 and batch_size % n:
        raise ValueError(
            f"multi-process runs need global batch_size={batch_size} divisible by "
            f"the global device count {n}"
        )
    return make_mesh(n, (axis,))


def make_train_mesh(batch_size: int, model_axis: int = 1) -> Mesh:
    """Training mesh from config: 1-D ``("data",)`` when ``model_axis <= 1``, else
    ``("data", "model")`` of ``(world // model_axis, model_axis)`` for FSDP
    (``solver.fsdp_model_axis``)."""
    if model_axis <= 1:
        return make_data_mesh(batch_size)
    n = _visible_devices()
    if n % model_axis:
        raise ValueError(f"fsdp_model_axis={model_axis} must divide the device "
                         f"count {n}")
    dp = n // model_axis
    if batch_size % dp:
        raise ValueError(f"global batch_size={batch_size} must divide over the "
                         f"data axis ({dp} of {n} devices at "
                         f"fsdp_model_axis={model_axis})")
    return make_mesh(n, ("data", "model"), (dp, model_axis))


def fsdp_enabled(mesh: Mesh) -> bool:
    """A mesh trains FSDP iff it has a model axis of size > 1."""
    return "model" in mesh.axis_names and mesh.shape["model"] > 1


def data_sharding(mesh: Optional[Mesh]) -> Optional[BatchShard]:
    """The rows this process holds: its block of the global batch over every process
    (None without a process group). The train steps run inside this scope."""
    if mesh is None or not mesh.distributed:
        return None
    return BatchShard(mesh.world_group, mesh.rank, mesh.world)


def fsdp_spec(shape, mesh: Mesh, axis: str = "model") -> Tuple[Optional[str], ...]:
    """FSDP placement rule for one tensor, as a tuple of axis names (the JAX
    ``PartitionSpec``'s entries): shard the largest dim that the model-axis size divides;
    replicate small or indivisible tensors (``()``)."""
    size = mesh.shape[axis]
    if size == 1 or not shape:
        return ()
    dims = [d for d in range(len(shape)) if shape[d] % size == 0 and shape[d] >= size]
    if not dims:
        return ()
    best = max(dims, key=lambda d: shape[d])
    spec = [None] * len(shape)
    spec[best] = axis
    return tuple(spec)


def replicated(mesh: Mesh) -> Tuple[Optional[str], ...]:
    """The spec of a tensor every process holds whole."""
    return ()


class _Entry:
    """A trainable parameter and what this process holds of it: ``held`` is the slice
    along ``dim`` (the whole parameter where ``dim`` is None)."""

    def __init__(self, param: nn.Parameter, dim: Optional[int], held: torch.Tensor):
        self.param, self.dim, self.held = param, dim, held
        self.full_shape = param.shape


class FsdpOptimizer:
    """Parameters and optimizer moments sharded over a mesh's model axis (full gradients:
    see the module's docstring): the optimizer of :func:`shard_tree_fsdp`. It steps a copy
    of the given :class:`~.optim.TrainOptimizer` over the slices this process holds, so
    the moments are sharded as the parameters are.

    ``gather()`` (a collective over the model axis) materializes the full parameters in
    the module; ``step()`` takes the full gradients, already averaged over every process
    by :func:`reduce_gradients`, clips them by their global norm (the ``"fixed"`` clip,
    as one process would), keeps this process's slices, updates them and frees the full
    parameters. ``state_dict()`` gathers the moments (a collective) into the state of the
    one-card optimizer, which a one-card run loads; ``load_state_dict`` slices such a
    state and re-shards the parameters from the module (load the model first, as
    ``train/ckpt.load_train_state`` does)."""

    def __init__(self, optimizer, mesh: Mesh, axis: str = "model"):
        self.size, self.index, self.group = mesh.shape[axis], mesh.coord(axis), mesh.group(axis)
        self.clip = optimizer.clip
        self.entries = []
        for p in optimizer.params:
            spec = fsdp_spec(tuple(p.shape), mesh, axis)
            if axis in spec:
                d = spec.index(axis)
                held = nn.Parameter(self._part(p.detach(), d).clone())
            else:
                d, held = None, p
            self.entries.append(_Entry(p, d, held))
        self.params = [e.param for e in self.entries]
        self.optimizer = optimizer.like([e.held for e in self.entries], max_grad_norm=0.0)
        self._sharded = [e for e in self.entries if e.dim is not None]

    def _part(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        return t.chunk(self.size, dim)[self.index].contiguous()

    def _gather(self, parts, dims, shapes):
        """The full tensors of this process's ``parts`` (sliced along ``dims``)."""
        numel = sum(p.numel() for p in parts)
        buf = parts[0].new_zeros((self.size, numel))
        torch.cat([p.reshape(-1) for p in parts], out=buf[self.index])
        dist.all_reduce(buf, group=self.group)
        out, off = [], 0
        for p, d, shape in zip(parts, dims, shapes):
            n = p.numel()
            out.append(torch.cat([buf[m, off:off + n].view(p.shape) for m in range(self.size)],
                                 d).view(shape))
            off += n
        return out

    @property
    def lr(self) -> float:
        return self.optimizer.lr

    @torch.no_grad()
    def gather(self) -> None:
        """The full parameters into the module, from every process's slices."""
        if not self._sharded:
            return
        full = self._gather([e.held for e in self._sharded], [e.dim for e in self._sharded],
                            [e.full_shape for e in self._sharded])
        for e, f in zip(self._sharded, full):
            e.param.data = f

    def release(self) -> None:
        """Free the gathered parameters: at rest a process holds its slices only."""
        for e in self._sharded:
            e.param.data = e.param.data.new_empty(0)
            e.param.grad = None

    def zero_grad(self) -> None:
        self.optimizer.zero_grad()
        for e in self.entries:
            e.param.grad = None

    def step(self) -> None:
        if self.clip:
            torch.nn.utils.clip_grad_norm_(self.params, self.clip)
        for e in self._sharded:
            e.held.grad = None if e.param.grad is None else self._part(e.param.grad, e.dim)
        self.optimizer.step()
        self.release()

    def held(self, param: nn.Parameter) -> Tuple[torch.Tensor, Callable]:
        """What this process holds of ``param`` and the function that takes the same
        slice of a full-shaped tensor."""
        for e in self.entries:
            if e.param is param:
                if e.dim is None:
                    return e.held, lambda t: t
                return e.held, lambda t, d=e.dim: self._part(t, d)
        raise KeyError("not a parameter of this optimizer")

    def _moments(self, state: dict, fn) -> dict:
        """``state`` (the inner optimizer's) with every sharded parameter's moment
        tensors mapped through ``fn(indices, tensors)``, in one call."""
        inner = state["optimizer"]
        per_param = {}
        for i, e in enumerate(self.entries):
            if e.dim is not None and i in inner["state"]:
                keys = [k for k, v in inner["state"][i].items()
                        if torch.is_tensor(v) and v.dim() > 0]
                per_param[i] = keys
        new_state = {i: dict(s) for i, s in inner["state"].items()}
        todo = [(i, k) for i, keys in per_param.items() for k in keys]
        if todo:
            outs = fn([i for i, _ in todo], [new_state[i][k] for i, k in todo])
            for (i, k), t in zip(todo, outs):
                new_state[i][k] = t
        return {**state, "optimizer": {**inner, "state": new_state}}

    def state_dict(self) -> dict:
        """The one-card optimizer's state: every moment gathered (a collective)."""
        def gather(idx, tensors):
            return self._gather(tensors, [self.entries[i].dim for i in idx],
                                [self.entries[i].full_shape for i in idx])

        return self._moments(self.optimizer.state_dict(), gather)

    def load_state_dict(self, state: dict) -> None:
        with torch.no_grad():
            for e in self._sharded:
                e.held.copy_(self._part(e.param.detach(), e.dim))

        def part(idx, tensors):
            return [self._part(t, self.entries[i].dim) for i, t in zip(idx, tensors)]

        self.optimizer.load_state_dict(self._moments(state, part))


def fsdp_state(optimizer) -> Optional[FsdpOptimizer]:
    """The :class:`FsdpOptimizer` inside ``optimizer`` (a wrapper's ``.optimizer``
    chain), or None."""
    while optimizer is not None and not isinstance(optimizer, FsdpOptimizer):
        optimizer = getattr(optimizer, "optimizer", None)
    return optimizer


def shard_tree_fsdp(optimizer, mesh: Mesh, axis: str = "model"):
    """Shard ``optimizer``'s parameters and moments over ``axis`` by :func:`fsdp_spec`:
    the :class:`FsdpOptimizer` that replaces it. Every process must hold the same full
    model when it is called (:func:`replicate`)."""
    return FsdpOptimizer(optimizer, mesh, axis)


def replicate(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Make every process's parameters and buffers rank 0's, by one broadcast per
    tensor (a collective); the identity without a process group."""
    if mesh.distributed:
        with torch.no_grad():
            for t in list(model.parameters()) + list(model.buffers()):
                dist.broadcast(t.data, src=0, group=mesh.world_group)
    return model


def place_train_state(model: nn.Module, optimizer, mesh: Mesh):
    """(model, optimizer) placed on a training mesh: replicated from rank 0, and under
    FSDP (:func:`fsdp_enabled`) with the optimizer replaced by its sharded form."""
    replicate(model, mesh)
    if fsdp_enabled(mesh):
        optimizer = shard_tree_fsdp(optimizer, mesh)
    return model, optimizer


def gather_replicated(model: nn.Module, optimizer, mesh: Optional[Mesh]):
    """The full train state of an FSDP run on every process (a collective: every process
    calls it): the parameters gathered into ``model`` and an optimizer whose
    ``state_dict()`` is the one-card state, for the validation, the test pass and the
    checkpoint writes. Without FSDP it returns ``optimizer`` as it is."""
    fsdp = fsdp_state(optimizer)
    if fsdp is None:
        return optimizer
    fsdp.gather()
    return _SavedState(optimizer.state_dict())


class _SavedState:
    def __init__(self, state: dict):
        self._state = state

    def state_dict(self) -> dict:
        return self._state


def shard_batch(batch: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This process's block of rows of a global batch that every process holds (as the
    dry run builds it). The train CLIs need none: each process's loader yields only its
    rows (``batch_size // world``, block-ordered as the single-process batch)."""
    shard = data_sharding(mesh)
    return {k: local_rows(v, shard) for k, v in batch.items()}


def reduce_gradients(params, mesh: Optional[Mesh]) -> int:
    """Average the gradients of ``params`` over every process, in place, through one
    flattened all-reduce per dtype: the gradient of the global batch's mean loss, as
    each process's loss is the mean over its equal block. Returns the bytes reduced
    (0 without a process group)."""
    if mesh is None or not mesh.distributed:
        return 0
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return 0
    return flat_all_reduce(grads, mesh.world_group, divide=mesh.world)


def mean_over_processes(values: Dict[str, float], mesh: Optional[Mesh],
                        device) -> Dict[str, float]:
    """``values`` averaged over every process (one all-reduce; the same keys on every
    process)."""
    if mesh is None or not mesh.distributed or not values:
        return values
    keys = sorted(values)
    t = torch.tensor([float(values[k]) for k in keys], dtype=torch.float64, device=device)
    dist.all_reduce(t, group=mesh.world_group)
    return {k: float(v) / mesh.world for k, v in zip(keys, t.tolist())}


__all__ = ["FsdpOptimizer", "Mesh", "backend_and_card", "data_axis_size", "data_sharding",
           "fsdp_enabled", "fsdp_spec", "fsdp_state", "gather_replicated", "make_data_mesh",
           "make_mesh", "make_train_mesh", "maybe_init_distributed", "mean_over_processes",
           "place_train_state", "reduce_gradients", "replicate", "replicated",
           "run_processes", "shard_batch", "shard_tree_fsdp"]
