"""The port's CaMN and DisCo train steps (pantomatrix_tpu_torch/train/steps.py) against the
JAX package's on the CPU: tiny configs without dropout, weights from the JAX init carried
by convert.load_jax_params, inputs from numpy seeds, plain SGD, iteration 1. One JAX
step per family, shared by the tests of this file.

The JAX step is run through its un-jitted body (``step.raw``, op by op). Jitted, the
DisCo step's gradient is wrong: XLA computes the batch's time-mean features twice, in two
reduction orders, so each sample's distance to itself comes out ~1.6e-15 instead of 0,
and the contrastive loss's sqrt turns that into a spurious gradient (0.05 on audio
encoder weights whose gradient is 0.3, measured on this fixture). The op-by-op body, the
port and the reference's eager torch all give the self-pairs a zero distance.

Tolerances: losses within 1e-5 relative, updated parameters and BatchNorm buffers within
1e-5 (float32 through a conv stack and LSTMs, summed in other orders). The bf16 CaMN
trajectory is held to the bounds of tests/test_train_steps.py's
test_bf16_training_loss_trajectory_bounded against the port's own float32 trajectory.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pantomatrix_tpu.models import camn as jcamn
from pantomatrix_tpu.models import configs as jcfgs
from pantomatrix_tpu.models import disco as jdisco
from pantomatrix_tpu.nn.blocks import wav_encoder_out_len
from pantomatrix_tpu.train import steps as jsteps
from pantomatrix_tpu.train.optim import make_optimizer as jmake_optimizer
from pantomatrix_tpu_torch.convert import load_jax_params
from pantomatrix_tpu_torch.io.hf_checkpoint import flatten_params
from pantomatrix_tpu_torch.models import camn, configs, disco
from pantomatrix_tpu_torch.train.optim import make_optimizer
from pantomatrix_tpu_torch.train.steps import make_camn_train_step, make_disco_train_step

torch.set_num_threads(2)

TINY = dict(hidden_size=32, n_layer=1, dropout_prob=0.0)
LR = 0.1
FAMILIES = {
    "camn": (jcamn.init_camn, jsteps.make_camn_train_step, jcfgs.CamnAudioConfig,
             camn.CamnAudio, make_camn_train_step, configs.CamnAudioConfig),
    "disco": (jdisco.init_disco, jsteps.make_disco_train_step, jcfgs.DiscoAudioConfig,
              disco.DiscoAudio, make_disco_train_step, configs.DiscoAudioConfig),
}


def _batch(family, bs=4, samples=16000, seed=0):
    rng = np.random.RandomState(seed)
    t = wav_encoder_out_len(samples, 128, "camn")
    batch = {"motion": rng.uniform(-0.5, 0.5, (bs, t, 129)).astype(np.float32),
             "audio": rng.uniform(-1, 1, (bs, samples)).astype(np.float32)}
    if family == "disco":
        batch["rhythm_label"] = np.asarray([[0], [1], [0], [2]], np.int64)[:bs]
        batch["content_label"] = np.asarray([[1], [1], [0], [2]], np.int64)[:bs]
    return batch


@pytest.fixture(scope="module", params=list(FAMILIES))
def jax_step(request):
    """Per family: the JAX params before the step, and after one SGD step with its losses."""
    family = request.param
    init, make_step, jcls = FAMILIES[family][:3]
    cfg = jcls(**TINY)
    params = jax.jit(lambda k: init(k, cfg))(jax.random.PRNGKey(1))
    host = jax.tree_util.tree_map(np.asarray, params)
    opt = jmake_optimizer(learning_rate=LR, optimizer="sgd")
    step = make_step(cfg, opt)
    batch = {k: jnp.asarray(v) for k, v in _batch(family).items()}
    new, _, losses = step.raw(params, jsteps.init_opt_state(opt, params), batch,
                              jax.random.PRNGKey(0), jnp.asarray(1.0))
    return family, host, flatten_params(jax.tree_util.tree_map(np.asarray, new)), \
        {k: float(v) for k, v in losses.items()}


def _port(family, host, compute_dtype=None):
    _, _, _, mod_cls, make_step, tcls = FAMILIES[family]
    model = load_jax_params(mod_cls(tcls(**TINY), generator=torch.Generator()), host)
    opt = make_optimizer(model.parameters(), learning_rate=LR, optimizer="sgd")
    return model, make_step(model, opt, compute_dtype=compute_dtype)


def test_step_matches_jax(jax_step):
    family, host, want, want_losses = jax_step
    model, step = _port(family, host)
    batch = {k: torch.from_numpy(v) for k, v in _batch(family).items()}
    losses = step(batch, 1)
    assert set(losses) == set(want_losses)
    for k, v in want_losses.items():
        np.testing.assert_allclose(float(losses[k]), v, rtol=1e-5, err_msg=k)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v, rtol=0, atol=1e-5, err_msg=k)
    # the step trained: weights and BatchNorm buffers moved, one batch counted
    flat_host = flatten_params(host)
    assert not np.allclose(got["body_out.fc2.weight"].numpy(), flat_host["body_out.fc2.weight"])
    bn = "audio_encoder.feat_extractor.0.bn1."
    assert not np.allclose(got[bn + "running_mean"].numpy(), flat_host[bn + "running_mean"])
    assert int(got[bn + "num_batches_tracked"]) == 1


def test_step_leaves_master_weights_float32_in_bf16(jax_step):
    family, host, _, want_losses = jax_step
    model, step = _port(family, host, compute_dtype="bfloat16")
    batch = {k: torch.from_numpy(v) for k, v in _batch(family).items()}
    losses = step(batch, 1)
    key = "all_loss"
    assert np.isfinite(float(losses[key]))
    assert abs(float(losses[key]) - want_losses[key]) / abs(want_losses[key]) < 0.02
    for name, t in model.state_dict().items():
        if t.is_floating_point():
            assert t.dtype == torch.float32, name
            assert torch.isfinite(t).all(), name


def test_bf16_training_loss_trajectory_bounded():
    """The bounds of tests/test_train_steps.py's test_bf16_training_loss_trajectory_bounded
    (bs 4 x 4000 samples, Adam 1e-3, on one batch): the first step within 2e-3 relative
    of float32, every step within 15%, the last 10 within 8%, bf16 converging below a
    third of its first loss; master weights and buffers stay float32. 50 steps instead
    of 100: a bfloat16 step takes 0.26 s on this CPU (its convolutions run without
    oneDNN, see train/steps.py), and by step 50 the loss is below a third of the first."""
    steps, ns = 50, 4000
    batch = {k: torch.from_numpy(v) for k, v in _batch("camn", samples=ns, seed=9).items()}

    def run(cdt):
        model = camn.CamnAudio(configs.CamnAudioConfig(hidden_size=32, n_layer=1,
                                                       dropout_prob=0.0),
                               generator=torch.Generator().manual_seed(1))
        opt = make_optimizer(model.parameters(), learning_rate=1e-3)
        step = make_camn_train_step(model, opt, compute_dtype=cdt, seed=7)
        return np.asarray([float(step(batch, i)["loss"]) for i in range(steps)]), model

    loss_f32, _ = run(None)
    loss_bf16, model = run("bfloat16")
    assert np.isfinite(loss_bf16).all()
    rel = np.abs(loss_f32 - loss_bf16) / np.abs(loss_f32)
    assert rel[0] < 2e-3, f"first-step deviation {rel[0]:.2e}"
    assert rel.max() < 0.15, f"trajectory diverged: max rel {rel.max():.3f}"
    f_tail, b_tail = loss_f32[-10:].mean(), loss_bf16[-10:].mean()
    assert abs(f_tail - b_tail) / f_tail < 0.08
    assert b_tail < loss_bf16[0] / 3
    for name, t in model.state_dict().items():
        if t.is_floating_point():
            assert t.dtype == torch.float32, name
