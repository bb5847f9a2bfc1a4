"""CaMN's training step: the program's ``make_camn_train_step`` with its
``TrainOptimizer`` (Adam) over ``CamnAudioModel``'s float32 master weights, against the
plain step of ``reference/camn_train.py``.

The start: the reference follows the program's three warm-up steps from the seed on its
own (the seed's weights, Adam from zeros, the same three batches). Compared: each step's
loss, the first gradient as the optimizer got it (the program's first moment after one
step over 1 - beta1) and the parameters' change over the three steps, as the window's
first step finds them; the last two by each leaf's norm.

The window: around each judged step the adapter copies, on the card and without a
synchronisation, the state before it (parameters, Adam's moments and update count,
BatchNorm's running statistics) and after it (the gradients the optimizer read, which the
step leaves in place, the parameters and the running statistics, and the returned loss).
Once the window has closed and the program is freed, the reference recomputes each
judged step from its copy: the gradient at the program's own state, so that nothing
drifts, and plain Adam on the program's own gradient and moments, so that the update is
judged alone. The first warm-up step is judged so too, from the seed's own state. The
window's last steps (``judged_tail``, one for each distinct batch) keep only the
parameters they started from and their loss, copied into a ring; the reference's loss at
those parameters judges the program's (late in the window a step that leaves rows out of
its loss has fitted the rows it kept, so the loss it returns lies below the whole
batch's).

In the traced run, ``timing`` puts a pair of CUDA events around each
``LstmLayerFunction`` backward that autograd runs (``node_ms``): the device's stream
reaches the first when the node starts, if the device is idle, and the second once the
last kernel the node launched has ended.

Numbers (each the worst over the steps it covers; "leaf" is one parameter tensor, and
leaves whose reference gradient is under a thousandth of the median leaf's, as the convs'
biases before a BatchNorm, whose gradient is 0 but for rounding, are left out):
- ``start_loss_err``: the three warm-up steps' losses against the reference's own,
  relative;
- ``start_grad_gap``: the worst leaf's gap between the first gradient's norms, over the
  larger of the reference's norm of that leaf and of the median leaf;
- ``start_change_gap``: the same gap for the parameters' change over the three steps;
- ``first_bn_err``: ``bn_stats_err`` of the first step, from the seed's own state;
- ``loss_err``: the step's returned loss against the reference's, relative (the judged
  steps and the window's last ``judged_tail``);
- ``update_err``: the worst leaf's parameter change against plain Adam applied to the
  parameters, the program's gradient and the program's moments, rounded to float32 as
  the master weights are kept (a step that hands its state back unchanged reads 1);
- ``grad_err_median``: the median over leaves of the gradient's relative L2 error;
- ``grad_cos_err_median``: the median over leaves of one minus the gradients' cosine;
- ``grad_norm_gap_max``: the worst leaf's gap between the gradients' norms, as above;
- ``grad_err_leaf_max``: the worst leaf's relative L2 error;
- ``bn_stats_err``: the running statistics' change over the step, all BatchNorms
  together, against the reference's, relative L2.
The traffic mix gives the limits; a number without one is shown, not compared (the
gradients at the program's state: the few frames whose rotation lies near 0 or pi from
its target carry the geodesic's steep arccos, and any rounding, bfloat16's or the float8
control's alike, scrambles their share, so these numbers cannot tell the two apart).
"""
from __future__ import annotations

import contextlib
import statistics
import sys

import torch

from harness import flops, weights
from harness.adapter import Adapter as Base
from harness.adapter import derive, port_module, speech_like
from harness.common import relative_error
from reference.camn import Camn
from reference.camn_train import Trainer, adam, loss_and_gradient, loss_at, set_step_numerics
from reference.layers import BatchNorm1d, exact_fp32

SMALL_LEAF = 1e-3  # of the median leaf's reference gradient norm
NUMBERS = ("start_loss_err", "start_grad_gap", "start_change_gap", "first_bn_err", "loss_err",
           "update_err", "grad_err_median", "grad_cos_err_median", "grad_norm_gap_max",
           "grad_err_leaf_max", "bn_stats_err")


def encoder_frames(ref: Camn, samples: int) -> int:
    """Frames the WavEncoder makes of ``samples`` (each block's first conv strides; the
    second keeps the length)."""
    n = samples
    for block in ref.audio_encoder.feat_extractor:
        c = block.conv1
        n = (n + 2 * c.padding - c.weight.shape[-1]) // c.stride + 1
    return n


def flat(tensors, numels, device):
    """One float32 copy of ``tensors`` end to end (a missing tensor as zeros)."""
    return torch.cat([torch.zeros(k, device=device) if t is None
                      else t.detach().reshape(-1).float() for t, k in zip(tensors, numels)])


class Adapter(Base):
    rate_metric = "train_motion_s_per_s"

    def setup(self):
        mix, dev = self.mix, self.device
        cfg = self.model_cfg = dict(self.model_cfg, **mix.get("model", {}))
        self.batch = int(mix["batch"])
        self.samples = int(mix["frames"]) * int(mix["samples_per_frame"])
        self.ref = weights.build(lambda: Camn(cfg), derive(self.seed, "camn"), dev)
        self.frames = encoder_frames(self.ref, self.samples)
        self.mark("weights")
        g = self.generator("inputs")
        n = int(mix["distinct_inputs"])
        audio = speech_like(g, n, self.batch, self.samples, dev)
        joints = cfg["pose_dims"] // 6
        # each clip's axis-angles uniform in +-energy/2, its energy drawn from the mix's
        # range: calm and lively takes, as a batch of BEAT2 clips holds
        low, high = mix["motion_energy"]
        energy = low + (high - low) * torch.rand(n, self.batch, 1, 1, generator=g,
                                                 device=dev)
        motion = (torch.rand(n, self.batch, self.frames, 3 * joints, generator=g,
                             device=dev) - 0.5) * energy
        self.inputs = [{"audio": audio[i], "motion": motion[i]} for i in range(n)]
        self.speaker = torch.zeros(self.batch, 1, dtype=torch.long, device=dev)
        self.mark("inputs")
        opt = mix["optimizer"]
        self.hyper = tuple(float(opt[k]) for k in ("learning_rate", "beta1", "beta2", "eps"))
        self.names = [name for name, _ in self.ref.named_parameters()]
        self.numels = [p.numel() for _, p in self.ref.named_parameters()]
        self.norms = [name for name, m in self.ref.named_modules() if isinstance(m, BatchNorm1d)]
        self.snaps, self.start = {}, {"loss": []}
        self.ring, self.ring_loss, self.node_ms, self._nodes = [], {}, {}, None
        if self.program == "port":
            from pantomatrix_tpu_torch.models.api import CamnAudioModel
            from pantomatrix_tpu_torch.models.configs import CamnAudioConfig
            from pantomatrix_tpu_torch.train.optim import TrainOptimizer
            from pantomatrix_tpu_torch.train.steps import make_camn_train_step

            self.model = port_module(
                lambda d: CamnAudioModel(CamnAudioConfig(**cfg), device=d), self.ref)
            lr, beta1, beta2, eps = self.hyper
            self.optimizer = TrainOptimizer(self.model.parameters(), learning_rate=lr,
                                            beta1=beta1, beta2=beta2, eps=eps,
                                            lr_scheduler=opt["lr_scheduler"])
            self.step = make_camn_train_step(self.model, self.optimizer,
                                             compute_dtype=mix.get("compute_dtype"),
                                             seed=derive(self.seed, "steps"))
        else:
            control = weights.build(lambda: Camn(cfg), derive(self.seed, "camn"), dev)
            self.trainer = Trainer(set_step_numerics(control), *self.hyper)
        self.mark("program")

    @property
    def motion_seconds_per_call(self) -> float:
        return self.batch * self.frames / float(self.model_cfg["pose_fps"])

    def call(self, i: int):
        batch = self.inputs[i % len(self.inputs)]
        if self.program == "port":
            return self.step(batch, i)
        with exact_fp32():
            return {"loss": self.trainer.step(batch["audio"], self.speaker, batch["motion"])}

    # --- the state around a judged step -------------------------------------------

    def _state(self, own: bool = False) -> dict:
        """The program's state by the reference's names; ``own``: the seed's (the
        reference's weights and running statistics, Adam's zeros) instead."""
        if own:
            params, modules = dict(self.ref.named_parameters()), dict(self.ref.named_modules())
            moments, steps = [None] * len(self.names), torch.zeros(())
            state = {"param": [params[n] for n in self.names],
                     "exp_avg": moments, "exp_avg_sq": moments, "steps": steps}
        elif self.program == "port":
            params, modules = dict(self.model.named_parameters()), dict(self.model.named_modules())
            held = self.optimizer.optimizer.state
            opt = [held.get(params[n], {}) for n in self.names]
            steps = next((s["step"] for s in opt if "step" in s), torch.zeros(()))
            state = {"param": [params[n] for n in self.names],
                     "grad": [params[n].grad for n in self.names],
                     "exp_avg": [s.get("exp_avg") for s in opt],
                     "exp_avg_sq": [s.get("exp_avg_sq") for s in opt],
                     "steps": torch.as_tensor(steps).clone()}
        else:
            t = self.trainer
            params, modules = t.params, dict(t.ref.named_modules())
            state = {"param": [params[n] for n in self.names],
                     "grad": [t.grad.get(n) for n in self.names],
                     "exp_avg": [t.exp_avg[n] for n in self.names],
                     "exp_avg_sq": [t.exp_avg_sq[n] for n in self.names],
                     "steps": torch.tensor(float(t.steps))}
        state["bn"] = [b for n in self.norms
                       for b in (modules[n].running_mean, modules[n].running_var)]
        return state

    def _flat(self, tensors):
        return flat(tensors, self.numels, self.device)

    def before(self, i: int, own: bool = False) -> None:
        """Copy the state step ``i`` starts from (``own``: the seed's)."""
        s = self._state(own)
        self.snaps[i] = {"param": self._flat(s["param"]), "exp_avg": self._flat(s["exp_avg"]),
                         "exp_avg_sq": self._flat(s["exp_avg_sq"]), "steps": s["steps"],
                         "bn": torch.cat([b.detach().float() for b in s["bn"]])}

    def after(self, i: int, out: dict) -> None:
        """Copy what step ``i`` made: its gradients, parameters, statistics and loss."""
        s = self._state()
        self.snaps[i].update(grad=self._flat(s["grad"]), param_after=self._flat(s["param"]),
                             bn_after=torch.cat([b.detach().float() for b in s["bn"]]),
                             loss=out["loss"].detach().float().clone())

    def keep_tail(self, n: int) -> None:
        """A ring of ``n`` flat copies of the parameters, for the window's last steps."""
        total = sum(self.numels)
        self.ring = [torch.empty(total, device=self.device) for _ in range(n)]
        self._views = [list(buf.split(self.numels)) for buf in self.ring]
        self._live = [p.detach().reshape(-1) for p in self._state()["param"]]

    def keep(self, i: int) -> None:
        """Copy the parameters step ``i`` starts from into its slot of the ring."""
        torch._foreach_copy_(self._views[i % len(self.ring)], self._live)

    def kept(self, i: int, out: dict) -> None:
        self.ring_loss[i % len(self.ring)] = (i, out["loss"].detach().float().clone())

    def held_bytes(self) -> int:
        """Bytes of the check's copies on the card."""
        tensors = [t for snap in self.snaps.values() for t in snap.values()] + self.ring
        return sum(t.numel() * t.element_size() for t in tensors if torch.is_tensor(t))

    def timed_call(self, i: int, spans: dict):
        if self._nodes is not None:
            self._nodes.append([])
        return super().timed_call(i, spans)

    @contextlib.contextmanager
    def timing(self):
        """CUDA events around each LSTM backward node of the steps run inside;
        ``node_ms["lstm_backward"]`` is then each step's list of node milliseconds."""
        if self.program != "port" or self.device.type != "cuda":
            yield
            return
        from pantomatrix_tpu_torch.ops.lstm_cuda import LstmLayerFunction

        backward = LstmLayerFunction.backward
        nodes = self._nodes = []

        def timed(ctx, *grads):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = backward(ctx, *grads)
            b.record()
            if nodes:
                nodes[-1].append((a, b))
            return out

        LstmLayerFunction.backward = staticmethod(timed)
        try:
            yield
        finally:
            LstmLayerFunction.backward = staticmethod(backward)
            torch.cuda.synchronize(self.device)
            self.node_ms = {"lstm_backward": [[a.elapsed_time(b) for a, b in step]
                                              for step in nodes if step]}
            self._nodes = None

    def warmed(self, i: int, out: dict, last: bool) -> None:
        """After warm-up step ``i``: its loss; after the first, the first moments; after
        the last, the parameters the window starts from."""
        self.start["loss"].append(out["loss"].detach().float().clone())
        if i == 0:
            self.start["exp_avg"] = self._flat(self._state()["exp_avg"])
        if last:
            self.start["param"] = self._flat(self._state()["param"])

    def free_program(self):
        for name in ("model", "optimizer", "step", "trainer", "_live"):
            if hasattr(self, name):
                delattr(self, name)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # --- the judgement ---------------------------------------------------------------

    def _load(self, snap: dict) -> None:
        """The reference at a copy's parameters and running statistics."""
        params = dict(self.ref.named_parameters())
        modules = dict(self.ref.named_modules())
        with torch.no_grad():
            for n, chunk in zip(self.names, snap["param"].split(self.numels)):
                params[n].copy_(chunk.view_as(params[n]))
            at = 0
            for n in self.norms if "bn" in snap else ():
                for b in (modules[n].running_mean, modules[n].running_var):
                    b.copy_(snap["bn"][at:at + b.numel()])
                    at += b.numel()

    def judge_step(self, i: int, snap: dict) -> dict:
        """The numbers of step ``i`` from its copies."""
        batch = self.inputs[i % len(self.inputs)]
        self._load(snap)
        with torch.enable_grad():
            loss, grads, stats = loss_and_gradient(self.ref, batch["audio"], self.speaker,
                                                   batch["motion"])
        split = lambda key: snap[key].split(self.numels)
        g_port, theta, after = split("grad"), split("param"), split("param_after")
        m, v = split("exp_avg"), split("exp_avg_sq")
        g_ref = [grads[n].reshape(-1) for n in self.names]
        norm = torch.stack([g.double().norm() for g in g_ref]).tolist()
        port_norm = torch.stack([g.double().norm() for g in g_port]).tolist()
        median = statistics.median(norm)
        kept = [j for j, x in enumerate(norm) if x >= SMALL_LEAF * median]
        err, cos, gap, upd = [], [], [], []
        steps = int(float(snap["steps"]))
        for j in kept:
            p, r = g_port[j].double(), g_ref[j].double()
            err.append(relative_error(p, r))
            cos.append(1.0 - float(torch.dot(p, r)) / max(port_norm[j] * norm[j], 1e-300))
            gap.append(abs(port_norm[j] - norm[j]) / max(norm[j], median))
            new, _, _ = adam(theta[j].double(), p, m[j].double(), v[j].double(), steps,
                             *self.hyper)
            want = new.float().double() - theta[j].double()
            got = after[j].double() - theta[j].double()
            upd.append(relative_error(got, want) if float(want.norm()) > 0
                       else (0.0 if float(got.norm()) == 0 else float("inf")))
        ref_bn = torch.cat([x for n in self.norms for x in stats[n]])
        out = {"loss_err": abs(float(snap["loss"]) - float(loss)) / abs(float(loss)),
               "grad_err_median": statistics.median(err),
               "grad_cos_err_median": statistics.median(cos),
               "grad_norm_gap_max": max(gap), "grad_err_leaf_max": max(err),
               "update_err": max(upd),
               "bn_stats_err": relative_error(snap["bn_after"] - snap["bn"],
                                              ref_bn - snap["bn"])}
        print(f"benchmark: judged step {i} (Adam update {steps + 1}, {len(kept)} of "
              f"{len(norm)} leaves): " + ", ".join(f"{k} {v!r}" for k, v in out.items()),
              file=sys.stderr, flush=True)
        return out

    def judge_loss(self, i: int, params: torch.Tensor, loss: torch.Tensor) -> float:
        """``loss_err`` of step ``i`` from the parameters it started from."""
        batch = self.inputs[i % len(self.inputs)]
        self._load({"param": params})
        want = float(loss_at(self.ref, batch["audio"], self.speaker, batch["motion"]))
        err = abs(float(loss) - want) / abs(want)
        print(f"benchmark: last steps' step {i}: loss_err {err!r}", file=sys.stderr, flush=True)
        return err

    def judge_start(self, seed_state: dict) -> dict:
        """The start's numbers: the reference's own three steps from ``seed_state`` (the
        copy taken before the first warm-up step) against the program's."""
        self._load(seed_state)
        trainer = Trainer(self.ref, *self.hyper)
        losses, first = [], None
        for i in range(len(self.start["loss"])):
            batch = self.inputs[i % len(self.inputs)]
            with torch.enable_grad():
                losses.append(float(trainer.step(batch["audio"], self.speaker,
                                                 batch["motion"])))
            if first is None:
                first = [trainer.grad[n].reshape(-1).double() for n in self.names]
        change = [(trainer.params[n].reshape(-1).double() - p.double())
                  for n, p in zip(self.names, seed_state["param"].split(self.numels))]
        beta1 = self.hyper[1]
        g_port = (self.start["exp_avg"] / (1.0 - beta1)).split(self.numels)
        d_port = (self.start["param"] - seed_state["param"]).split(self.numels)
        norm = [float(g.norm()) for g in first]
        median = statistics.median(norm)
        kept = [j for j, x in enumerate(norm) if x >= SMALL_LEAF * median]

        def gap(port, ref):
            ref_norm = [float(ref[j].norm()) for j in kept]
            floor = statistics.median(ref_norm)
            return max(abs(float(port[j].double().norm()) - r) / max(r, floor)
                       for j, r in zip(kept, ref_norm))

        out = {"start_loss_err": max(abs(float(p) - r) / abs(r)
                                     for p, r in zip(self.start["loss"], losses)),
               "start_grad_gap": gap(g_port, first), "start_change_gap": gap(d_port, change)}
        print(f"benchmark: start ({len(losses)} steps from the seed, {len(kept)} of "
              f"{len(norm)} leaves): " + ", ".join(f"{k} {v!r}" for k, v in out.items()),
              file=sys.stderr, flush=True)
        return out

    def check(self, count_flops: bool = False):
        """The numbers compared, each the worst over the judged steps, and (when asked)
        the FLOPs of one step's forward and backward, counted over the reference once a
        shape."""
        worst = dict.fromkeys(NUMBERS, 0.0)
        with exact_fp32():
            first = min(self.snaps)
            worst.update(self.judge_start(self.snaps[first]))
            for i in sorted(self.snaps):
                got = self.judge_step(i, self.snaps.pop(i))
                if i == first:
                    worst["first_bn_err"] = got["bn_stats_err"]
                for k, v in got.items():
                    worst[k] = max(worst[k], v)
            for slot, (i, loss) in sorted(self.ring_loss.items(), key=lambda kv: kv[1][0]):
                worst["loss_err"] = max(worst["loss_err"], self.judge_loss(i, self.ring[slot],
                                                                           loss))
            count = None
            if count_flops:
                key = {"family": "camn_train", "model": self.model_cfg, "batch": self.batch,
                       "samples": self.samples}
                batch = self.inputs[0]
                with torch.enable_grad():
                    count = flops.cached(key, lambda: loss_and_gradient(
                        self.ref, batch["audio"], self.speaker, batch["motion"]))
        return worst, count
