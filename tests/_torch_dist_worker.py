"""One process of the two-process gloo job of tests/test_torch_distributed.py: each check
takes this process's rows of a global input made from a numpy seed, runs the port's
multi-process code on them, and saves what the parent compares (``rank<r>.pt``). It
imports no JAX: the parent holds the results against JAX and against one process."""
import os

import numpy as np
import torch

from pantomatrix_tpu_torch.nn import layers
from pantomatrix_tpu_torch.train import mesh as M
from pantomatrix_tpu_torch.train.losses import contrastive_loss
from pantomatrix_tpu_torch.train.optim import make_optimizer
from pantomatrix_tpu_torch.train.steps import (
    RestartingOptimizer,
    make_camn_train_step,
    make_vq_train_step,
    vq_usage_init,
)
from pantomatrix_tpu_torch.utils.distributed import (
    batch_shard,
    flat_all_reduce,
    gather_rows,
    local_rows,
)

WORLD = 2
BN_SHAPE = (4, 9, 12)
VQ_THRESH = 1.0  # codes used less than 1/K of the time are dead: the step restarts some


def bn_inputs(seed=0, shape=BN_SHAPE):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    p = {"weight": rng.uniform(0.5, 1.5, c).astype(np.float32),
         "bias": rng.normal(0, 0.3, c).astype(np.float32),
         "running_mean": rng.normal(0, 0.2, c).astype(np.float32),
         "running_var": rng.uniform(0.5, 2.0, c).astype(np.float32),
         "num_batches_tracked": np.asarray(3, np.int64)}
    x = rng.normal(1.5, 2.0, shape).astype(np.float32)
    cot = rng.normal(0, 1, shape).astype(np.float32)
    return p, x, cot


def bn_check(shard):
    """Train-mode BatchNorm1d on this process's rows: output, input and parameter
    gradients of sum(y * cot), running statistics."""
    p, x, cot = bn_inputs()
    bn = layers.BatchNorm1d(BN_SHAPE[-1])
    bn.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in p.items()})
    bn.train()
    xt = local_rows(torch.from_numpy(x), shard).clone().requires_grad_()
    with batch_shard(shard):
        y = bn(xt)
        (y * local_rows(torch.from_numpy(cot), shard)).sum().backward()
    return {"y": y.detach(), "x_grad": xt.grad, "weight_grad": bn.weight.grad,
            "bias_grad": bn.bias.grad, "running_mean": bn.running_mean.clone(),
            "running_var": bn.running_var.clone(), "count": bn.num_batches_tracked.clone()}


def contrastive_inputs():
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.normal(0, 1, (6, 7, 5)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 0.5, (5, 4)).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, 3, (6, 1)))
    return x, w, labels


def contrastive(x, w, labels, shard):
    """DisCo's contrastive term through a linear map: the loss and the weight's
    gradient averaged over the processes (as the step averages it)."""
    w = w.clone().requires_grad_()
    loss = contrastive_loss(gather_rows(x @ w, shard), gather_rows(labels, shard))
    loss.backward()
    if shard is not None:
        flat_all_reduce([w.grad], shard.group, divide=shard.count)
    return {"loss": loss.detach(), "w_grad": w.grad}


def tiny_vq_suite(seed=19):
    from pantomatrix_tpu_torch.models import configs, emage_vq

    g = torch.Generator().manual_seed(seed)
    part = lambda dim: emage_vq.EmageVQVAE(configs.EmageVQVAEConvConfig(
        vae_test_dim=dim, vae_length=16, vae_codebook_size=16), generator=g)
    return emage_vq.EmageVQSuite(
        face=part(106), upper=part(78), hands=part(180), lower=part(61),
        global_motion=emage_vq.EmageVAE(configs.EmageVAEConvConfig(
            vae_length=24, vae_test_dim=61), generator=g))


def vq_batch(bs=4, t=16):
    rng = np.random.RandomState(5)
    b = {"motion": rng.uniform(-0.5, 0.5, (bs, t, 165)),
         "expressions": rng.uniform(-1, 1, (bs, t, 100)), "trans": rng.uniform(-1, 1, (bs, t, 3)),
         "foot_contact": rng.uniform(size=(bs, t, 4)) < 0.5}
    return {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in b.items()}


def vq_restart(mesh, shard):
    """One SGD step of the tiny tokenizer suite with dead-code restarts (iteration 1)."""
    suite = tiny_vq_suite()
    opt = make_optimizer(suite.parameters(), learning_rate=0.1, optimizer="sgd")
    if mesh is not None:
        suite, opt = M.place_train_state(suite, opt, mesh)
    opt = RestartingOptimizer(opt, vq_usage_init(suite))
    step = make_vq_train_step(suite, opt, restart_dead_codes=True, restart_thresh=VQ_THRESH,
                              seed=2, mesh=mesh)
    batch = {k: local_rows(v, shard) for k, v in vq_batch().items()}
    losses = step(batch, 1)
    M.gather_replicated(suite, opt, mesh)
    return {"restarted": {k: float(v) for k, v in losses.items() if k.startswith("restarted")},
            "dead": {k: v.clone() for k, v in opt.dead.items()},
            "usage": {k: v.clone() for k, v in opt.usage.items()},
            "params": {k: v.detach().clone() for k, v in suite.state_dict().items()}}


def camn_batch(bs=4, t=16):
    rng = np.random.RandomState(11)
    return {"motion": torch.from_numpy(rng.uniform(-0.5, 0.5, (bs, t, 129)).astype(np.float32)),
            "audio": torch.from_numpy(rng.uniform(-1, 1, (bs, 2 * t * 533)).astype(np.float32))}


def tiny_camn():
    from pantomatrix_tpu_torch.models.camn import CamnAudio
    from pantomatrix_tpu_torch.models.configs import CamnAudioConfig

    return CamnAudio(CamnAudioConfig(hidden_size=32, n_layer=1, dropout_prob=0.0),
                     generator=torch.Generator().manual_seed(1))


def grads_seen(mesh, shard, compute_dtype, optimizer="sgd", steps=1, float64=False):
    """The flat gradient the optimizer sees at each step of tiny CaMN (through
    ``functional_call`` under a compute dtype), on this process's rows; ``float64``: the
    same weights and batch in float64."""
    model = tiny_camn().to(torch.float64 if float64 else torch.float32)
    opt = make_optimizer(model.parameters(), learning_rate=1e-3, optimizer=optimizer)
    if mesh is not None:
        model, opt = M.place_train_state(model, opt, mesh)
    seen, inner = [], opt.step

    def spy():
        seen.append(torch.cat([p.grad.reshape(-1) for p in opt.params]).clone())
        inner()

    opt.step = spy
    step = make_camn_train_step(model, opt, compute_dtype=compute_dtype, seed=4, mesh=mesh)
    batch = {k: local_rows(v.double() if float64 else v, shard)
             for k, v in camn_batch().items()}
    for i in range(steps):
        step(batch, i)
    return model, opt, seen


def fsdp_adam(mesh, shard):
    """Two Adam steps of tiny CaMN under FSDP: what each process holds, and the gathered
    one-card optimizer state, which loads back into a fresh FSDP optimizer."""
    model, opt, _ = grads_seen(mesh, shard, None, optimizer="adam", steps=2)
    fsdp = M.fsdp_state(opt)
    sharded = [e for e in fsdp.entries if e.dim is not None]
    out = {"held_numel": sum(e.held.numel() for e in sharded),
           "full_numel": sum(int(np.prod(e.full_shape)) for e in sharded),
           "released": all(e.param.numel() == 0 for e in sharded)}
    state = M.gather_replicated(model, opt, mesh).state_dict()
    again = M.shard_tree_fsdp(make_optimizer(model.parameters(), optimizer="adam"), mesh)
    again.load_state_dict(state)
    reloaded = again.state_dict()
    out["reload_equal"] = all(
        torch.equal(reloaded["optimizer"]["state"][i][k], v)
        for i, s in state["optimizer"]["state"].items() for k, v in s.items())
    out["state"] = state
    out["params"] = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return out


def run(rank, out_dir, port):
    torch.set_num_threads(1)
    os.environ.update(PANTO_COORDINATOR=f"localhost:{port}", PANTO_NUM_PROCESSES=str(WORLD),
                      PANTO_PROCESS_ID=str(rank))
    M.maybe_init_distributed("cpu")
    try:
        mesh = M.make_mesh(WORLD)
        mesh2 = M.make_mesh(WORLD, ("data", "model"), (1, WORLD))
        shard = M.data_sharding(mesh)
        out = {"bn": bn_check(shard), "contrastive": contrastive(*contrastive_inputs(), shard),
               "vq": vq_restart(mesh, shard), "vq_fsdp": vq_restart(mesh2, shard)}
        for mode in ("float32", "bfloat16"):
            dtype = None if mode == "float32" else mode
            out[f"grads_{mode}"] = grads_seen(mesh, shard, dtype)[2][0]
            out[f"grads_local_{mode}"] = grads_seen(None, shard, dtype)[2][0]
        out["fsdp_adam"] = fsdp_adam(mesh2, shard)
        model, opt, _ = grads_seen(mesh, shard, None, optimizer="adam", steps=2)
        out["dp_adam"] = {"state": opt.state_dict(),
                          "params": {k: v.detach().clone() for k, v in model.state_dict().items()}}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()
