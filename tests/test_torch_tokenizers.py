"""The encode side of the port's tokenizer suite (pantomatrix_tpu_torch.nn.vq,
models.emage_vq, models.api), EMAGE's no-audio pass and the BEAT npz load, against the
JAX package on the CPU.

Weights are drawn by the port's init from a seed and handed to the JAX package as its
param trees (the JAX init of these configs is slower); the codebooks are unit-scale
normal draws, so the decoded 6D rows are well conditioned (tests/test_torch_emage.py).
Inputs are made from a numpy seed. Tolerances: latents and network outputs 1e-5 absolute;
indices equal; the VQ loss and perplexity 1e-6 relative; the global translation 1e-5;
loaded npz arrays equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pantomatrix_tpu.core import masking as jmasking
from pantomatrix_tpu.io import beat_format as jbeat
from pantomatrix_tpu.models import api as japi
from pantomatrix_tpu.models import configs as jcfgs
from pantomatrix_tpu.models import emage as jemage
from pantomatrix_tpu.models import emage_vq as jvq
from pantomatrix_tpu.nn import vq as jnnvq
from pantomatrix_tpu_torch.core import masking
from pantomatrix_tpu_torch.io import beat_format
from pantomatrix_tpu_torch.io.hf_checkpoint import unflatten_params
from pantomatrix_tpu_torch.models import api, configs, emage_vq
from pantomatrix_tpu_torch.nn import vq

torch.set_num_threads(2)

ATOL = 1e-5
CB = 16
KW = dict(audio_f=32, motion_f=16, hidden_size=32, speaker_dims=4, pose_length=8,
          seed_frames=2, vae_codebook_size=CB, vae_length=CB, dropout_prob=0.0)
PART_DIMS = {"face": 106, "upper": 78, "hands": 180, "lower": 61}
GLOBAL_KW = dict(vae_length=24, vae_test_dim=61)
PART_KW = dict(vae_length=CB, vae_codebook_size=CB)


def np_tree(module):
    """A port module's weights as the JAX package's param tree of numpy arrays."""
    return unflatten_params({k: v.numpy() for k, v in module.state_dict().items()})


def _close(got, want, name, atol=ATOL):
    np.testing.assert_allclose(torch.as_tensor(got).detach().numpy(), np.asarray(want),
                               rtol=0, atol=atol, err_msg=name)


@pytest.fixture(scope="module")
def suites():
    """(JAX EmageVQModel, port EmageVQModel) with the same weights."""
    g = torch.Generator().manual_seed(1)
    parts = {}
    for i, (name, dim) in enumerate(PART_DIMS.items()):
        part = api.EmageVQVAEConv(configs.EmageVQVAEConvConfig(vae_test_dim=dim, **PART_KW),
                                  seed=10 + i, device="cpu")
        with torch.no_grad():
            part.quantizer.embedding.weight.copy_(torch.randn(CB, CB, generator=g))
        parts[name] = part
    glob = api.EmageVAEConv(configs.EmageVAEConvConfig(**GLOBAL_KW), seed=20, device="cpu")
    port = api.EmageVQModel(global_motion=glob, **parts)
    jax_vq = japi.EmageVQModel(
        global_motion=japi.EmageVAEConv(jcfgs.EmageVAEConvConfig(**GLOBAL_KW), np_tree(glob)),
        **{name: japi.EmageVQVAEConv(
            jcfgs.EmageVQVAEConvConfig(vae_test_dim=dim, **PART_KW), np_tree(parts[name]))
           for name, dim in PART_DIMS.items()})
    return jax_vq, port


def _motion(bs=2, t=12, seed=3):
    """rot6d (bs, t, 330) of random axis angles, expression, foot contact, translation."""
    from pantomatrix_tpu_torch.core.rotations import axis_angle_to_rotation_6d

    rng = np.random.RandomState(seed)
    aa = rng.uniform(-0.6, 0.6, (bs, t, 55, 3)).astype(np.float32)
    rot6d = axis_angle_to_rotation_6d(torch.from_numpy(aa)).reshape(bs, t, 330).numpy()
    return (rot6d, rng.uniform(-1, 1, (bs, t, 100)).astype(np.float32),
            (rng.uniform(size=(bs, t, 4)) < 0.5).astype(np.float32),
            rng.normal(0, 0.5, (bs, t, 3)).astype(np.float32))


@pytest.mark.parametrize("beta", [0.25, 1.0])
def test_quantize_and_map2index_match_jax(beta):
    rng = np.random.RandomState(0)
    cb = rng.normal(0, 1, (32, 8)).astype(np.float32)
    z = rng.normal(0, 1, (3, 20, 8)).astype(np.float32)
    q = vq.Quantizer(32, 8, generator=torch.Generator())
    with torch.no_grad():
        q.embedding.weight.copy_(torch.from_numpy(cb))
    p = {"embedding": {"weight": jnp.asarray(cb)}}
    loss, z_q, idx, perp = vq.quantize(q, torch.from_numpy(z), beta)
    jloss, jz_q, jidx, jperp = jnnvq.quantize(p, jnp.asarray(z), beta)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert idx.dtype == torch.int32
    _close(z_q, jz_q, "z_q")
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(perp.item(), float(jperp), rtol=1e-6)
    np.testing.assert_array_equal(vq.map2index(q, torch.from_numpy(z)).numpy(),
                                  np.asarray(jnnvq.map2index(p, jnp.asarray(z))))


def test_quantize_passes_the_gradient_straight_through():
    q = vq.Quantizer(16, 4, generator=torch.Generator().manual_seed(0))
    z = torch.randn(2, 5, 4, generator=torch.Generator().manual_seed(1), requires_grad=True)
    loss, z_q, _, _ = vq.quantize(q, z, 0.25)
    z_q.sum().backward()
    torch.testing.assert_close(z.grad, torch.ones_like(z))


@pytest.mark.parametrize("part", list(PART_DIMS))
def test_vqvae_forward_map2index_map2latent_match_jax(suites, part):
    jax_vq, port = suites
    jp, jc = getattr(jax_vq.suite, part)
    model = getattr(port, part)
    x = np.random.RandomState(4).normal(0, 1, (2, 12, PART_DIMS[part])).astype(np.float32)
    got = model(torch.from_numpy(x))
    want = jvq.vqvae_forward(jp, jc, jnp.asarray(x))
    assert set(got) == set(want)
    for k in ("poses_feat", "rec_pose", "pre_latent"):
        _close(got[k], want[k], k)
    np.testing.assert_array_equal(got["indices"].numpy(), np.asarray(want["indices"]))
    for k in ("embedding_loss", "perplexity"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-6, err_msg=k)
    np.testing.assert_array_equal(model.map2index(torch.from_numpy(x)).numpy(),
                                  np.asarray(jvq.vqvae_map2index(jp, jc, jnp.asarray(x))))
    _close(model.map2latent(torch.from_numpy(x)),
           jvq.vqvae_map2latent(jp, jc, jnp.asarray(x)), "map2latent")


def test_vae_forward_api_matches_jax(suites):
    jax_vq, port = suites
    x = np.random.RandomState(5).normal(0, 1, (2, 12, 61)).astype(np.float32)
    jp, jc = jax_vq.suite.global_motion
    _close(port.global_motion(torch.from_numpy(x))["rec_pose"],
           jvq.vae_forward(jp, jc, jnp.asarray(x))["rec_pose"], "rec_pose")


@pytest.mark.parametrize("with_foot", [False, True])
def test_split_inputs_match_jax(suites, with_foot):
    jax_vq, port = suites
    rot6d, expr, contact, trans = _motion()
    extra = (contact, trans) if with_foot else (None, None)
    got = port.spilt_inputs(torch.from_numpy(rot6d), torch.from_numpy(expr),
                            *[None if a is None else torch.from_numpy(a) for a in extra])
    want = jax_vq.spilt_inputs(jnp.asarray(rot6d), jnp.asarray(expr),
                               *[None if a is None else jnp.asarray(a) for a in extra])
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        "face": (2, 12, 106), "upper": (2, 12, 78), "hands": (2, 12, 180), "lower": (2, 12, 61)}
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert emage_vq.UPPER_JOINTS == np.flatnonzero(jmasking.JOINT_MASK_UPPER).tolist()
    assert emage_vq.LOWER_JOINTS == np.flatnonzero(jmasking.JOINT_MASK_LOWER).tolist()


def test_suite_map2index_map2latent_and_global_motion_match_jax(suites):
    jax_vq, port = suites
    rot6d, expr, contact, trans = _motion(seed=6)
    targs = [torch.from_numpy(a) for a in (rot6d, expr, contact, trans)]
    jargs = [jnp.asarray(a) for a in (rot6d, expr, contact, trans)]
    idx, jidx = port.map2index(*targs), jax_vq.map2index(*jargs)
    lat, jlat = port.map2latent(*targs), jax_vq.map2latent(*jargs)
    for part in PART_DIMS:
        np.testing.assert_array_equal(idx[part].numpy(), np.asarray(jidx[part]), err_msg=part)
        _close(lat[part], jlat[part], part)
        # the latents are codebook rows: the decode's re-quantization finds them again
        np.testing.assert_array_equal(
            vq.nearest_code(lat[part], getattr(port, part).quantizer.embedding.weight).numpy(),
            idx[part].numpy())
    lower = port.spilt_inputs(*targs)["lower"]
    ref = torch.from_numpy(trans[:, :1])
    _close(port.get_global_motion(lower, ref),
           jax_vq.get_global_motion(jnp.asarray(lower.numpy()), jnp.asarray(trans[:, :1])),
           "global motion")


def test_emage_forward_without_audio_matches_jax():
    model = api.EmageAudioModel(configs.EmageAudioConfig(**KW), seed=2, device="cpu")
    jmodel = japi.EmageAudioModel(jcfgs.EmageAudioConfig(**KW), np_tree(model))
    rng = np.random.RandomState(8)
    t = KW["pose_length"]
    audio = rng.uniform(-0.5, 0.5, (2, t * 533)).astype(np.float32)
    spk = np.array([[1], [3]], np.int32)
    motion = rng.normal(0, 1, (2, t, 337)).astype(np.float32)
    mask = (rng.uniform(size=(2, t, 337)) < 0.5).astype(np.float32)
    fwd = jax.jit(lambda p, a, s, m, k, use: jemage.emage_forward(
        p, jmodel.config, a, s, m, k, use), static_argnums=5)
    args = [torch.from_numpy(a) for a in (audio, spk.astype(np.int64), motion, mask)]
    for use_audio in (False, True):
        got = model(*args, use_audio=use_audio)
        want = fwd(jmodel.params, *[jnp.asarray(a) for a in (audio, spk, motion, mask)],
                   use_audio)
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], f"{k} use_audio={use_audio}", atol=1e-5)
    # the no-audio pass leaves the body stream without the cross-attention stack
    with_audio, without = model(*args), model(*args, use_audio=False)
    assert not torch.allclose(with_audio["rec_upper"], without["rec_upper"])
    torch.testing.assert_close(with_audio["rec_face"], without["rec_face"])


@pytest.mark.parametrize("mask_name", [None, "local_upper", "local_full"])
def test_beat_format_load_matches_jax(tmp_path, mask_name):
    rng = np.random.RandomState(9)
    path = str(tmp_path / "clip.npz")
    jbeat.beat_format_save(path, rng.uniform(-0.5, 0.5, (7, 165)).astype(np.float32),
                           betas=rng.normal(0, 1, (7, 300)).astype(np.float32),
                           expressions=rng.normal(0, 1, (7, 100)).astype(np.float32),
                           trans=rng.normal(0, 1, (7, 3)).astype(np.float32))
    got = beat_format.beat_format_load(path, masking.MASK_DICT[mask_name] if mask_name else None)
    want = jbeat.beat_format_load(path, jmasking.MASK_DICT[mask_name] if mask_name else None)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if mask_name == "local_upper":
        assert got["poses"].shape == (7, 43 * 3)
