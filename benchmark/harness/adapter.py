"""What the model adapters (``models/<family>.py``) share: seeds, forced completion, the
device, and the lower-precision control put in the program's place."""
from __future__ import annotations

import hashlib
import math
import time

import torch


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for one stream (weights, inputs) of a run's ``--seed``."""
    return int(hashlib.sha256(f"{int(seed)}:{tag}".encode()).hexdigest()[:15], 16)


def speech_like(gen: torch.Generator, n: int, batch: int, samples: int, device) -> torch.Tensor:
    """(n, batch, samples) of 16 kHz audio in [-1, 1] from ``gen``: per row a voiced tone
    (a pitch of 90-250 Hz gliding by +-10%, six harmonics falling as 1/k) under a
    syllable envelope of 2-6 Hz, at a loudness of 0.05-0.5, with a little noise. Rows differ
    in pitch, rhythm and loudness, as takes of different speakers do; white noise would
    give every row the same statistics."""
    u = lambda: torch.rand(n, batch, 1, generator=gen, device=device)
    t = torch.arange(samples, device=device, dtype=torch.float32) / 16000.0
    f0, glide, rate = 90 + 160 * u(), 0.3 + 0.4 * u(), 2 + 4 * u()
    phase = 2 * math.pi * f0 * (t - 0.1 / (2 * math.pi * glide)
                                * torch.cos(2 * math.pi * glide * t))
    audio = torch.zeros(n, batch, samples, device=device)
    for k in range(1, 7):
        audio += torch.sin(k * phase + 2 * math.pi * u()) / k
    envelope = (0.5 - 0.5 * torch.cos(2 * math.pi * rate * t + 2 * math.pi * u())) ** 2
    audio *= envelope * (0.05 + 0.45 * u()) / 2.45
    audio += 0.02 * (2 * torch.rand(n, batch, samples, generator=gen, device=device) - 1)
    return audio.clamp_(-1, 1)


def port_module(factory, reference: torch.nn.Module) -> torch.nn.Module:
    """The program's module, built by ``factory(device)`` on ``meta`` with its random
    initialisers skipped, then given a copy of ``reference``'s tensors, made on their
    device. (On ``meta``, ``uniform_`` and ``normal_`` would run torch's Python reference
    kernels, whose first call imports ``torch._dynamo``: seconds of set-up for values
    that are overwritten.)"""
    skipped = {name: getattr(torch.Tensor, name) for name in ("uniform_", "normal_")}
    try:
        for name in skipped:
            setattr(torch.Tensor, name, lambda self, *a, **k: self)
        with torch.device("meta"):
            module = factory("meta")
    finally:
        for name, fn in skipped.items():
            setattr(torch.Tensor, name, fn)
    state = {k: v.detach().clone() for k, v in reference.state_dict().items()}
    module.load_state_dict(state, strict=True, assign=True)
    return module


def leaves(out):
    if isinstance(out, dict):
        for v in out.values():
            yield from leaves(v)
    elif isinstance(out, torch.Tensor):
        yield out


class Adapter:
    """``program`` is ``"port"`` (the system under test) or ``"control"`` (the reference
    computed in the next precision below the configuration's, for the check's control)."""

    rate_metric = "motion_s_per_s"

    def __init__(self, config: dict, mix: dict, seed: int, device, program: str = "port"):
        if program not in ("port", "control"):
            raise ValueError(program)
        self.config, self.mix, self.seed = config, mix, int(seed)
        self.model_cfg = dict(config["model"])
        self.device = torch.device(device)
        self.program = program
        self.precision = mix.get("compute_dtype", "float32")
        self.phases = [("start", time.perf_counter())]

    def mark(self, name: str) -> None:
        """The end of a part of set-up, on the host's clock once the device is done."""
        self.sync()
        self.phases.append((name, time.perf_counter()))

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def complete(self, out) -> None:
        """Forced completion: a host copy of a slice of every output, which cannot finish
        before the call has."""
        for t in leaves(out):
            t[(-1,) * t.dim()].cpu()

    def timed_call(self, i: int, spans: dict):
        self.sync()
        t0 = time.perf_counter()
        out = self.call(i)
        self.complete(out)
        spans.setdefault("call", []).append(time.perf_counter() - t0)
        return out

    def generator(self, tag: str) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(derive(self.seed, tag))
        return g
