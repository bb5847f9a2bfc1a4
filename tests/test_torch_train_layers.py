"""Train-mode layers of the port (pantomatrix_tpu_torch/nn/layers.py BatchNorm1d and
dropout) and K2 under autograd (ops/lstm_cuda.LstmLayerFunction, nn/lstm.LSTM) on the
CPU, against the JAX package's functions. Inputs come from numpy seeds.

Tolerances: train-mode BatchNorm within 1e-6 in float32 (the batch mean and variance are
summed in another order than XLA's) and within one bfloat16 ulp in bfloat16; the LSTM
gradients within 2e-5, the forward tolerance of tests/test_torch_lstm.py at
(T, B, H) = (20, 16, 512) (measured: 1.6e-5 on the bias gradients, which sum 320 terms
of magnitude ~0.1).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pantomatrix_tpu.nn import layers as jlayers
from pantomatrix_tpu.nn.lstm import init_lstm, lstm as jlstm
from pantomatrix_tpu_torch.convert import load_jax_params
from pantomatrix_tpu_torch.nn import layers
from pantomatrix_tpu_torch.nn.attention import TransformerDecoder
from pantomatrix_tpu_torch.nn.lstm import LSTM
from pantomatrix_tpu_torch.ops import lstm_cuda
from pantomatrix_tpu_torch.train.steps import call

torch.set_num_threads(2)


def _bn_inputs(dtype, seed=0, shape=(4, 9, 12)):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    p = {"weight": rng.uniform(0.5, 1.5, c).astype(np.float32),
         "bias": rng.normal(0, 0.3, c).astype(np.float32),
         "running_mean": rng.normal(0, 0.2, c).astype(np.float32),
         "running_var": rng.uniform(0.5, 2.0, c).astype(np.float32),
         "num_batches_tracked": np.asarray(3, np.int64)}
    x = (rng.normal(1.5, 2.0, shape)).astype(np.float32)
    return p, x


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bfloat16 numbers at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 1e-30)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_batch_norm_matches_jax(dtype):
    """Outputs, running statistics and the count after one train-mode call; in bfloat16
    the activations, weight and bias are bfloat16 and the running statistics float32, as
    in the train steps' compute dtype."""
    p, x = _bn_inputs(dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jp["weight"], jp["bias"] = jp["weight"].astype(jdt), jp["bias"].astype(jdt)
    ctx = jlayers.Ctx(train=True, bn_updates={})
    want = jlayers.batch_norm1d(jp, jnp.asarray(x).astype(jdt), ctx, ("bn",))
    upd = ctx.bn_updates[("bn",)]

    bn = load_jax_params(layers.BatchNorm1d(12), p)
    assert not bn.training  # built in eval mode
    bn.train()
    tdt = getattr(torch, dtype)
    got = call(bn, {"weight": bn.weight.to(tdt), "bias": bn.bias.to(tdt)},
               torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt and bn.running_mean.dtype == torch.float32
    if dtype == "float32":
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-6)
    else:
        w = np.asarray(want.astype(jnp.float32))
        diff = np.abs(got.detach().float().numpy() - w)
        assert (diff <= _bf16_ulp(w)).all(), diff.max()
    for k in ("running_mean", "running_var"):
        np.testing.assert_allclose(getattr(bn, k).numpy(), np.asarray(upd[k]), rtol=0, atol=1e-6)
    assert int(bn.num_batches_tracked) == int(upd["num_batches_tracked"]) == 4


def test_train_batch_norm_eval_mode_and_frozen_statistics():
    p, x = _bn_inputs("float32", seed=1)
    bn = load_jax_params(layers.BatchNorm1d(12), p)
    xt = torch.from_numpy(x)
    eval_out = bn(xt)
    np.testing.assert_allclose(
        eval_out.detach().numpy(),
        np.asarray(jlayers.batch_norm1d({k: jnp.asarray(v) for k, v in p.items()},
                                        jnp.asarray(x))), rtol=0, atol=1e-6)
    assert torch.equal(bn.running_mean, torch.from_numpy(p["running_mean"]))  # untouched
    bn.train()
    with layers.frozen_running_stats():
        frozen = bn(xt)
    assert torch.equal(bn.running_mean, torch.from_numpy(p["running_mean"]))
    assert int(bn.num_batches_tracked) == 3
    assert torch.equal(frozen, bn(xt))  # same normalization, and now an update
    assert int(bn.num_batches_tracked) == 4


def test_dropout_rate_scaling_identity_and_generator():
    x = torch.ones(200, 500)
    assert layers.dropout(x, 0.3, training=False) is x
    with layers.dropout_rng(None):
        assert layers.dropout(x, 0.0, training=True) is x  # rate 0 needs no generator
    with pytest.raises(ValueError, match="generator"):
        layers.dropout(x, 0.3, training=True)
    with layers.dropout_rng(layers.DropoutRng(7)):
        y = layers.dropout(x, 0.3, training=True)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.01
    assert torch.allclose(y[kept], torch.tensor(1 / 0.7))  # inverted scaling
    with layers.dropout_rng(layers.DropoutRng(7)):
        assert torch.equal(layers.dropout(x, 0.3, training=True), y)  # same seed, same mask
    with layers.dropout_rng(layers.DropoutRng(8)):
        assert not torch.equal(layers.dropout(x, 0.3, training=True), y)
    # children split in call order, each with a seed of its own
    a, b = layers.DropoutRng(7), layers.DropoutRng(7)
    assert [a.split().seed, a.split().seed] == [b.split().seed, b.split().seed]
    assert len({a.seed, a.split().seed, layers.DropoutRng(7).split().seed}) == 3


def test_transformer_dropout_only_in_train_mode():
    g = torch.Generator().manual_seed(0)
    dec = TransformerDecoder(2, 16, 32, 4, generator=g, dropout=0.5)
    tgt, mem = torch.randn(2, 5, 16, generator=g), torch.randn(2, 7, 16, generator=g)
    eval_out = dec(tgt, mem)
    assert torch.equal(eval_out, dec(tgt, mem))
    dec.train()
    with layers.dropout_rng(layers.DropoutRng(1)):
        a = dec(tgt, mem)
    with layers.dropout_rng(layers.DropoutRng(1)):
        b = dec(tgt, mem)
    with layers.dropout_rng(layers.DropoutRng(2)):
        c = dec(tgt, mem)
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, eval_out)


def test_lstm_layer_function_gradcheck():
    """K2's autograd.Function, its CPU forward being the plain version: the recompute
    backward against finite differences in float64."""
    g = torch.Generator().manual_seed(3)
    t, b, h = 4, 2, 3
    xp = torch.randn(t, b, 8 * h, generator=g, dtype=torch.float64, requires_grad=True)
    w = (0.5 * torch.randn(2, 4 * h, h, generator=g, dtype=torch.float64)).requires_grad_()
    assert torch.autograd.gradcheck(lambda a, c: lstm_cuda.LstmLayerFunction.apply(a, c, h),
                                    (xp, w))
    # and it is the plain version, forward and backward
    out = lstm_cuda.LstmLayerFunction.apply(xp, w, h)
    want = lstm_cuda.lstm_bidirectional_plain(xp, w, h)
    assert torch.equal(out, want)
    ct = torch.randn(out.shape, generator=g, dtype=torch.float64)
    got = torch.autograd.grad(out, (xp, w), ct)
    ref = torch.autograd.grad(want, (xp, w), ct)
    assert all(torch.equal(a, c) for a, c in zip(got, ref))


def test_lstm_gradients_match_jax_vjp():
    """The LSTM module's gradients (input and every parameter) against jax.vjp of the JAX
    ``lstm`` at T = 20, B = 16, H = 512, two bidirectional layers, the same weights."""
    t, b, h, c, n = 20, 16, 512, 128, 2
    params = init_lstm(jax.random.PRNGKey(0), c, h, n)
    rng = np.random.RandomState(3)
    x = rng.normal(0, 1, (b, t, c)).astype(np.float32)
    ct = rng.normal(0, 1, (b, t, 2 * h)).astype(np.float32)
    _, vjp = jax.vjp(lambda p, xx: jlstm(p, xx, h, n), params, jnp.asarray(x))
    gp, gx = jax.jit(vjp)(jnp.asarray(ct))

    module = load_jax_params(LSTM(c, h, n, generator=torch.Generator()),
                             jax.tree_util.tree_map(np.asarray, params))
    module.train()  # dropout 0: train mode changes nothing here
    xt = torch.from_numpy(x).requires_grad_()
    module(xt).backward(torch.from_numpy(ct))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=0, atol=2e-5)
    for name, prm in module.named_parameters():
        np.testing.assert_allclose(prm.grad.numpy(), np.asarray(gp[name]), rtol=0, atol=2e-5,
                                   err_msg=name)


def test_lstm_inter_layer_dropout_not_after_the_last_layer():
    g = torch.Generator().manual_seed(4)
    one = LSTM(6, 5, 1, generator=g, dropout=0.9)
    x = torch.randn(2, 3, 6, generator=g)
    want = one(x)
    one.train()
    with layers.dropout_rng(layers.DropoutRng(0)):
        assert torch.equal(one(x), want)  # one layer: no dropout at all
    two = LSTM(6, 5, 2, generator=g, dropout=0.9)
    want = two(x)
    two.train()
    with layers.dropout_rng(layers.DropoutRng(0)):
        assert not torch.equal(two(x), want)
