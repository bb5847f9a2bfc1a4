"""The port's collectives and their users over two real gloo processes on the CPU
(tests/_torch_dist_worker.py, one job for every check), against the JAX package and
against one process on the whole batch:

- synced train-mode BatchNorm (each process holds half the rows) against the JAX
  ``batch_norm1d`` in train mode on the whole batch: outputs, input gradients and
  running statistics within 1e-6, the weight and bias gradients (summed over the
  processes) within 1e-5 (sums of 36 terms of magnitude ~1, in another order);
- DisCo's contrastive term through a linear map: loss within 1e-6 relative and the
  averaged weight gradient within 1e-6 of one process;
- the VQ restarts (data parallel and FSDP): the same dead codes and restart counts,
  usage within 1e-7 and SGD-stepped parameters within 1e-6 of one process;
- the gradient the optimizer sees (tiny CaMN, float32 and through
  ``torch.func.functional_call`` in bfloat16): bitwise equal on both processes, while
  each process's own rows alone give different gradients (the replicas would diverge,
  as they do under DDP hooks that never arm); in float32 no further from the float64
  gradient of the same weights on the whole batch than twice one float32 process's
  distance plus 1e-6 (this step is ill-conditioned: one float32 process is ~6e-4 from
  float64, so the two processes' other summation order shows at ~1e-4);
- FSDP: each process holds half of every sharded tensor and frees the gathered ones
  after the step; after two Adam steps the gathered optimizer state has the one-card
  layout, equals the data-parallel run's within 1e-7 (the same reduced gradients,
  updated in slices), and loads back bitwise.
"""
import socket

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.multiprocessing as mp

import _torch_dist_worker as W
from pantomatrix_tpu.nn import layers as jlayers

torch.set_num_threads(2)
TIMEOUT = 300


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_dist")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=W.run, args=(r, str(out), port)) for r in range(W.WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=TIMEOUT)
    alive = [p.is_alive() for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    assert not any(alive) and codes == [0] * W.WORLD, f"alive {alive}, exit codes {codes}"
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(W.WORLD)]


def _cat(results, key, field):
    return torch.cat([r[key][field] for r in results]).numpy()


def test_synced_batch_norm_matches_jax_on_the_whole_batch(results):
    p, x, cot = W.bn_inputs()
    jp = {k: jnp.asarray(v) for k, v in p.items()}

    def f(x, w, b):
        ctx = jlayers.Ctx(train=True, bn_updates={})
        y = jlayers.batch_norm1d({**jp, "weight": w, "bias": b}, x, ctx, ("bn",))
        return jnp.sum(y * cot), (y, ctx.bn_updates[("bn",)])

    (_, (y, upd)), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jp["weight"], jp["bias"])
    np.testing.assert_allclose(_cat(results, "bn", "y"), np.asarray(y), rtol=0, atol=1e-6)
    np.testing.assert_allclose(_cat(results, "bn", "x_grad"), np.asarray(grads[0]), rtol=0,
                               atol=1e-6)
    for i, name in ((1, "weight_grad"), (2, "bias_grad")):
        got = sum(r["bn"][name] for r in results).numpy()
        np.testing.assert_allclose(got, np.asarray(grads[i]), rtol=0, atol=1e-5, err_msg=name)
    for r in results:
        for k in ("running_mean", "running_var"):
            np.testing.assert_allclose(r["bn"][k].numpy(), np.asarray(upd[k]), rtol=0,
                                       atol=1e-6, err_msg=k)
        assert int(r["bn"]["count"]) == int(upd["num_batches_tracked"]) == 4


def test_contrastive_over_two_processes_equals_one(results):
    want = W.contrastive(*W.contrastive_inputs(), None)
    for r in results:
        got = r["contrastive"]
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-6)
        np.testing.assert_allclose(got["w_grad"].numpy(), want["w_grad"].numpy(), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("key", ["vq", "vq_fsdp"])
def test_vq_restarts_equal_one_process(results, key):
    want = W.vq_restart(None, None)
    assert sum(want["restarted"].values()) > 0  # the check restarts codes
    for r in results:
        got = r[key]
        assert got["restarted"] == want["restarted"]
        for part, dead in want["dead"].items():
            assert torch.equal(got["dead"][part], dead), part
            np.testing.assert_allclose(got["usage"][part].numpy(), want["usage"][part].numpy(),
                                       rtol=0, atol=1e-7)
        for k, v in want["params"].items():
            np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=k)


@pytest.mark.parametrize("mode", ["float32", "bfloat16"])
def test_gradients_equal_on_every_process_after_the_reduction(results, mode):
    a, b = (r[f"grads_{mode}"] for r in results)
    assert torch.equal(a, b)
    local_a, local_b = (r[f"grads_local_{mode}"] for r in results)
    assert not torch.equal(local_a, local_b)  # without the reduction the replicas diverge
    if mode == "float32":
        single = W.grads_seen(None, None, None)[2][0].double()
        exact = W.grads_seen(None, None, None, float64=True)[2][0]
        bound = 2 * float((single - exact).abs().max()) + 1e-6
        assert float((a.double() - exact).abs().max()) <= bound


def test_fsdp_holds_slices_and_gathers_the_one_card_state(results):
    one_card = W.grads_seen(None, None, None, optimizer="adam", steps=2)[1].state_dict()
    for r in results:
        got, dp = r["fsdp_adam"], r["dp_adam"]
        assert got["held_numel"] * W.WORLD == got["full_numel"] > 0
        assert got["released"] and got["reload_equal"]
        assert got["state"]["scheduler"] == dp["state"]["scheduler"] == one_card["scheduler"]
        gs, ws = got["state"]["optimizer"]["state"], dp["state"]["optimizer"]["state"]
        assert gs.keys() == ws.keys() == one_card["optimizer"]["state"].keys()
        for i in ws:
            for k, v in ws[i].items():
                assert gs[i][k].shape == v.shape == one_card["optimizer"]["state"][i][k].shape
                np.testing.assert_allclose(gs[i][k].numpy(), v.numpy(), rtol=0, atol=1e-7,
                                           err_msg=f"{i} {k}")
        for k, v in dp["params"].items():
            np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(), rtol=0, atol=1e-7,
                                       err_msg=k)
