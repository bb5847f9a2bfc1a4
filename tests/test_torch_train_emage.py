"""The port's EMAGE train step (pantomatrix_tpu_torch/train/steps.py
make_emage_train_step) on the CPU: against the JAX package's step, and against itself
with share_audio_encoder off, with gradient checkpointing and in bfloat16. A tiny config
without dropout, weights and tokenizers from the JAX init (unit-scale codes, as in
tests/test_torch_emage.py), inputs from a numpy seed, plain SGD, iteration 1: under the
"reference" schedule the mask ratio is then above 1, so the random mask is all ones and
the step is deterministic. One jitted JAX step, shared by the tests of this file.

Tolerances: losses within 1e-5 relative, parameters and BatchNorm buffers within 1e-5;
the bfloat16 step's losses within 2% of float32.

The positional-encoding table is the one difference: the JAX step's trainable tree holds
``position_embeddings.pe``, so its optimizer moves it; in the reference and the port it is
a buffer and stays (see train/steps.py).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pantomatrix_tpu.models import configs as jcfgs
from pantomatrix_tpu.models import emage as jemage
from pantomatrix_tpu.models import emage_vq as jvq
from pantomatrix_tpu.train import steps as jsteps
from pantomatrix_tpu.train.optim import make_optimizer as jmake_optimizer
from pantomatrix_tpu_torch.convert import load_jax_params
from pantomatrix_tpu_torch.io.hf_checkpoint import flatten_params
from pantomatrix_tpu_torch.models import configs, emage, emage_vq
from pantomatrix_tpu_torch.models.api import EmageVQModel
from pantomatrix_tpu_torch.train.optim import make_optimizer
from pantomatrix_tpu_torch.train.steps import make_emage_train_step

torch.set_num_threads(2)

CB, T, BS, LR = 16, 8, 4, 0.1
KW = dict(audio_f=32, motion_f=16, hidden_size=32, speaker_dims=4, pose_length=T,
          seed_frames=2, vae_codebook_size=CB, vae_length=CB, dropout_prob=0.0)
PART_DIMS = {"face": 106, "upper": 78, "hands": 180, "lower": 61}
GLOBAL_KW = dict(vae_layer=4, vae_length=48, vae_test_dim=61)
PE = "position_embeddings.pe"
LOSSES = ("rec_seed", "cls_seed", "rec_audio", "cls_audio", "rec_mask", "cls_mask", "all")


def _jax_init(key):
    k_model, *ks = jax.random.split(key, 6)
    parts = {}
    for k, (name, dim) in zip(ks, PART_DIMS.items()):
        c = jcfgs.EmageVQVAEConvConfig(vae_test_dim=dim, vae_length=CB, vae_codebook_size=CB)
        p = jvq.init_emage_vqvae(k, c)
        p["quantizer"]["embedding"]["weight"] = jax.random.normal(k, (CB, CB))
        parts[name] = (p, c)
    gc = jcfgs.EmageVAEConvConfig(**GLOBAL_KW)
    suite = jvq.EmageVQSuite(global_motion=(jvq.init_emage_vae(ks[4], gc), gc), **parts)
    return jemage.init_emage(k_model, jcfgs.EmageAudioConfig(**KW)), suite


def _batch(seed=5):
    rng = np.random.RandomState(seed)
    return {
        "motion": rng.uniform(-0.5, 0.5, (BS, T, 165)).astype(np.float32),
        "audio": rng.uniform(-1, 1, (BS, T * 533)).astype(np.float32),
        "expressions": rng.uniform(-1, 1, (BS, T, 100)).astype(np.float32),
        "trans": rng.uniform(-1, 1, (BS, T, 3)).astype(np.float32),
        "foot_contact": (rng.uniform(size=(BS, T, 4)) < 0.5).astype(np.float32),
    }


@pytest.fixture(scope="module")
def ref():
    """The JAX params and suite (as numpy), and the params and losses after one step."""
    params, jsuite = jax.jit(_jax_init)(jax.random.PRNGKey(0))
    opt = jmake_optimizer(learning_rate=LR, optimizer="sgd")
    step = jsteps.make_emage_train_step(jcfgs.EmageAudioConfig(**KW), jsuite, opt)
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    new, _, losses = step(jax.tree_util.tree_map(jnp.array, params),
                          jsteps.init_opt_state(opt, params), batch, jax.random.PRNGKey(8),
                          jnp.asarray(1.0))
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    suite = {name: np_tree(getattr(jsuite, name)[0]) for name in (*PART_DIMS, "global_motion")}
    return (np_tree(params), suite, flatten_params(np_tree(new)),
            {k: float(v) for k, v in losses.items()})


def _port(ref, **kw):
    params, suite = ref[:2]
    g = torch.Generator().manual_seed(0)
    model = load_jax_params(emage.EmageAudio(configs.EmageAudioConfig(**KW), generator=g), params)
    parts = {name: load_jax_params(emage_vq.EmageVQVAE(configs.EmageVQVAEConvConfig(
        vae_test_dim=dim, vae_length=CB, vae_codebook_size=CB), generator=g), suite[name])
        for name, dim in PART_DIMS.items()}
    glob = load_jax_params(emage_vq.EmageVAE(configs.EmageVAEConvConfig(**GLOBAL_KW),
                                             generator=g), suite["global_motion"])
    vq = EmageVQModel(global_motion=glob, **parts)
    opt = make_optimizer(model.parameters(), learning_rate=LR, optimizer="sgd")
    step = make_emage_train_step(model, vq, opt, **kw)
    losses = step({k: torch.from_numpy(v) for k, v in _batch().items()}, 1)
    return model, {k: float(v) for k, v in losses.items()}


def _assert_state_close(got, want, skip=()):
    assert set(got) == set(want)
    for k, v in want.items():
        if k not in skip:
            np.testing.assert_allclose(np.asarray(got[k], np.float64), np.asarray(v, np.float64),
                                       rtol=0, atol=1e-5, err_msg=k)


def test_emage_step_matches_jax(ref):
    params, _, want, want_losses = ref
    model, losses = _port(ref)
    assert set(losses) == set(LOSSES) == set(want_losses)
    for k in LOSSES:
        np.testing.assert_allclose(losses[k], want_losses[k], rtol=1e-5, err_msg=k)
    got = {k: v.numpy() for k, v in model.state_dict().items()}
    _assert_state_close(got, want, skip=(PE,))
    before = flatten_params(params)
    # the PE table: a buffer here, untouched; trained by the JAX step
    assert np.array_equal(got[PE], before[PE]) and not np.allclose(want[PE], before[PE])
    # three passes of BatchNorm updates (the shared encoders' closed form), weights moved
    assert int(got["audio_encoder_body.feat_extractor.0.bn1.num_batches_tracked"]) == 3
    assert not np.allclose(got["moton_proj.weight"], before["moton_proj.weight"])


@pytest.mark.parametrize("variant", ["share_audio_encoder_off", "gradient_checkpointing",
                                     "gradient_checkpointing_share_off"])
def test_emage_step_variants_match_the_plain_step(ref, variant):
    """share_audio_encoder off (the encoders run in every pass, three sequential BatchNorm
    updates) and gradient checkpointing (activations recomputed in the backward pass,
    BatchNorm statistics updated once) against the default step: the same losses,
    parameters and buffers."""
    kw = {"share_audio_encoder_off": dict(share_audio_encoder=False),
          "gradient_checkpointing": dict(gradient_checkpointing=True),
          "gradient_checkpointing_share_off": dict(gradient_checkpointing=True,
                                                   share_audio_encoder=False)}[variant]
    base, base_losses = _port(ref)
    model, losses = _port(ref, **kw)
    for k in LOSSES:
        np.testing.assert_allclose(losses[k], base_losses[k], rtol=1e-5, err_msg=k)
    _assert_state_close({k: v.numpy() for k, v in model.state_dict().items()},
                        {k: v.numpy() for k, v in base.state_dict().items()})


def test_emage_step_gradient_checkpointing_matches(ref):
    """Checkpointing changes memory, not math, and the recomputation leaves the BatchNorm
    buffers as one forward leaves them (bitwise)."""
    base, base_losses = _port(ref)
    model, losses = _port(ref, gradient_checkpointing=True)
    assert losses == pytest.approx(base_losses, rel=1e-5)
    buffers = dict(base.named_buffers())
    for name, buf in model.named_buffers():
        assert torch.equal(buf, buffers[name]), name


def test_emage_bf16_step_within_2_percent_of_fp32(ref):
    base, base_losses = _port(ref)
    model, losses = _port(ref, compute_dtype="bfloat16")
    for k in LOSSES:
        assert np.isfinite(losses[k]), k
        assert abs(losses[k] - base_losses[k]) <= 0.02 * abs(base_losses[k]), k
    for name, t in model.state_dict().items():
        if t.is_floating_point():
            assert t.dtype == torch.float32, name
            assert torch.isfinite(t).all(), name
