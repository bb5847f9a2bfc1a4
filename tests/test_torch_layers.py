"""The port's layers and blocks (pantomatrix_tpu_torch.nn, .core) against the JAX
package's functions on the CPU: the same numpy-seeded inputs, JAX-initialised weights
carried across by convert.py. Tolerance: atol 1e-5 (float32 on both sides, sums taken
in another order); the joint-mask scatter is exact."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pantomatrix_tpu.core import integrate as jintegrate
from pantomatrix_tpu.core import masking as jmasking
from pantomatrix_tpu.core import rotations as jrot
from pantomatrix_tpu.nn import attention as jattn
from pantomatrix_tpu.nn import blocks as jblocks
from pantomatrix_tpu.nn import layers as jlayers
from pantomatrix_tpu_torch.convert import load_jax_params
from pantomatrix_tpu_torch.core import integrate, masking, rotations
from pantomatrix_tpu_torch.nn import attention, blocks, layers

torch.set_num_threads(2)

ATOL = 1e-5
GEN = torch.Generator().manual_seed(0)


def np_tree(p, rng=None):
    """JAX tree -> numpy tree; with ``rng``, BatchNorm running stats and affine params
    are randomized so that eval-mode BN is not the identity."""
    tree = jax.tree_util.tree_map(np.asarray, p)
    if rng is not None:
        def walk(node):
            if "running_mean" in node:
                c = node["running_mean"].shape
                node["running_mean"] = rng.normal(0, 0.5, c).astype(np.float32)
                node["running_var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
                node["weight"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
                node["bias"] = rng.normal(0, 0.2, c).astype(np.float32)
                return
            for v in node.values():
                if isinstance(v, dict):
                    walk(v)
        walk(tree)
    return tree


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=atol)


def rand(rng, *shape, scale=1.0):
    return (rng.normal(0, scale, shape)).astype(np.float32)


@pytest.mark.parametrize("stride,padding", [(1, 1), (5, 7), (3, 0)])
def test_conv1d(stride, padding):
    rng = np.random.RandomState(0)
    p = np_tree(jlayers.init_conv1d(jax.random.PRNGKey(0), 6, 10, 5))
    x = rand(rng, 2, 37, 6)
    conv = load_jax_params(layers.Conv1d(6, 10, 5, generator=GEN, stride=stride,
                                         padding=padding), p)
    close(conv(torch.from_numpy(x)), jlayers.conv1d(p, jnp.asarray(x), stride, padding))


def test_batch_norm1d_eval():
    rng = np.random.RandomState(1)
    p = np_tree(jlayers.init_batch_norm1d(12), rng)
    x = rand(rng, 3, 9, 12, scale=2.0)
    bn = load_jax_params(layers.BatchNorm1d(12), p)
    close(bn(torch.from_numpy(x)), jlayers.batch_norm1d(p, jnp.asarray(x)))


def test_layer_norm_and_linear_and_log_softmax():
    rng = np.random.RandomState(2)
    pl = np_tree(jlayers.init_layer_norm(16))
    pl["weight"] = rand(rng, 16)
    pl["bias"] = rand(rng, 16)
    x = rand(rng, 2, 5, 16, scale=3.0)
    ln = load_jax_params(layers.LayerNorm(16), pl)
    close(ln(torch.from_numpy(x)), jlayers.layer_norm(pl, jnp.asarray(x)))
    plin = np_tree(jlayers.init_linear(jax.random.PRNGKey(2), 16, 7))
    lin = load_jax_params(layers.Linear(16, 7, generator=GEN), plin)
    close(lin(torch.from_numpy(x)), jlayers.linear(plin, jnp.asarray(x)))
    close(layers.log_softmax(torch.from_numpy(x), dim=2),
          jlayers.log_softmax(jnp.asarray(x), axis=2))


def test_multi_head_attention():
    rng = np.random.RandomState(3)
    p = np_tree(jattn.init_multi_head_attention(jax.random.PRNGKey(3), 32))
    p["in_proj_bias"] = rand(rng, 96, scale=0.1)
    q, kv = rand(rng, 2, 8, 32), rand(rng, 2, 11, 32)
    mha = load_jax_params(attention.MultiheadAttention(32, 4, generator=GEN), p)
    got = mha(torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(kv))
    close(got, jattn.multi_head_attention(p, jnp.asarray(q), jnp.asarray(kv),
                                          jnp.asarray(kv), 4))


def test_transformer_encoder_layer():
    rng = np.random.RandomState(4)
    p = np_tree(jattn.init_transformer_encoder(jax.random.PRNGKey(4), 1, 32, 64))
    x = rand(rng, 2, 8, 32)
    enc = load_jax_params(attention.TransformerEncoder(1, 32, 64, 4, generator=GEN), p)
    close(enc(torch.from_numpy(x)), jattn.transformer_encoder(p, jnp.asarray(x), 1, 4))


@pytest.mark.parametrize("num_layers", [1, 3])
def test_transformer_decoder(num_layers):
    rng = np.random.RandomState(5)
    p = np_tree(jattn.init_transformer_decoder(jax.random.PRNGKey(5), num_layers, 32, 64))
    tgt, mem = rand(rng, 2, 8, 32), rand(rng, 2, 10, 32)
    dec = load_jax_params(
        attention.TransformerDecoder(num_layers, 32, 64, 4, generator=GEN), p)
    close(dec(torch.from_numpy(tgt), torch.from_numpy(mem)),
          jattn.transformer_decoder(p, jnp.asarray(tgt), jnp.asarray(mem), num_layers, 4))


def test_mlp():
    rng = np.random.RandomState(6)
    p = np_tree(jblocks.init_mlp(jax.random.PRNGKey(6), 12, 24, 8))
    x = rand(rng, 2, 5, 12)
    m = load_jax_params(blocks.MLP(12, 24, 8, generator=GEN), p)
    close(m(torch.from_numpy(x)), jblocks.mlp(p, jnp.asarray(x)))


@pytest.mark.parametrize("cin,cout,stride,pad,downsample",
                         [(4, 8, 5, 20, True), (8, 8, 1, 7, False)])
def test_basic_block(cin, cout, stride, pad, downsample):
    rng = np.random.RandomState(7)
    p = np_tree(jblocks.init_basic_block(jax.random.PRNGKey(7), cin, cout, 15, downsample), rng)
    x = rand(rng, 2, 120, cin)
    blk = load_jax_params(
        blocks.BasicBlock(cin, cout, 15, stride, pad, downsample, generator=GEN), p)
    close(blk(torch.from_numpy(x)), jblocks.basic_block(p, jnp.asarray(x), 15, stride, pad))


def test_wav_encoder_and_out_len():
    rng = np.random.RandomState(8)
    out_dim = 32
    p = np_tree(jblocks.init_wav_encoder(jax.random.PRNGKey(8), out_dim, "emage"), rng)
    wav = rng.uniform(-0.5, 0.5, (2, 10 * 533)).astype(np.float32)
    enc = load_jax_params(blocks.WavEncoder(out_dim, generator=GEN), p)
    got = enc(torch.from_numpy(wav))
    want = jblocks.wav_encoder(p, jnp.asarray(wav), out_dim, "emage")
    assert got.shape[1] == blocks.wav_encoder_out_len(wav.shape[1], out_dim) \
        == jblocks.wav_encoder_out_len(wav.shape[1], out_dim, "emage")
    close(got, want)


@pytest.mark.parametrize("n_layers", [2, 3])
def test_vq_encoder_and_decoder(n_layers):
    rng = np.random.RandomState(9)
    pe = np_tree(jblocks.init_vq_encoder(jax.random.PRNGKey(9), 61, 16, n_layers))
    pd = np_tree(jblocks.init_vq_decoder(jax.random.PRNGKey(10), 61, 16, n_layers))
    x = rand(rng, 2, 12, 61)
    enc = load_jax_params(blocks.VQEncoder(61, 16, n_layers, generator=GEN), pe)
    dec = load_jax_params(blocks.VQDecoder(61, 16, n_layers, generator=GEN), pd)
    lat = enc(torch.from_numpy(x))
    jlat = jblocks.vq_encoder(pe, jnp.asarray(x), n_layers)
    close(lat, jlat)
    close(dec(lat), jblocks.vq_decoder(pd, jlat, n_layers))


def test_periodic_positional_encoding():
    rng = np.random.RandomState(11)
    pe = blocks.make_periodic_pe(32, 8, 8)
    jpe = jblocks.make_periodic_pe(32, 8, 8)
    np.testing.assert_array_equal(pe.numpy(), np.asarray(jpe))
    x = rand(rng, 2, 7, 32)
    close(blocks.periodic_positional_encoding(pe, torch.from_numpy(x)),
          jblocks.periodic_positional_encoding(jpe, jnp.asarray(x)))


def test_rotation_round_trips():
    rng = np.random.RandomState(12)
    aa = rand(rng, 3, 55, 3)
    aa[0, :4] = 0.0  # exercise the small-angle guard
    aa[1, :4] *= 1e-7
    got6 = rotations.axis_angle_to_rotation_6d(torch.from_numpy(aa))
    want6 = jrot.axis_angle_to_rotation_6d(jnp.asarray(aa))
    close(got6, want6)
    six = rand(rng, 3, 20, 6)
    close(rotations.rotation_6d_to_axis_angle(torch.from_numpy(six)),
          jrot.rotation_6d_to_axis_angle(jnp.asarray(six)))


def test_rotation_float32_error_against_float64():
    """The reference's matrix -> quaternion step takes sqrt(1 +- m00 +- m11 +- m22)
    per component, so near a zero component a float32 rounding of the argument
    becomes ~sqrt(eps) in the result. This measures that error for both packages on
    2e5 random rotations (it is the same formula: they agree to 1e-5 on identical
    float32 inputs) and pins the bound the slice tests rely on. The tail grows with
    the sample count; 1e-3 is the bound at this count."""
    six = np.random.RandomState(14).normal(0, 1, (200_000, 6))
    want = rotations.rotation_6d_to_axis_angle(torch.from_numpy(six)).numpy()  # float64
    got = rotations.rotation_6d_to_axis_angle(torch.from_numpy(six.astype(np.float32)))
    jgot = np.asarray(jrot.rotation_6d_to_axis_angle(jnp.asarray(six.astype(np.float32))))
    close(got, jgot)
    err = np.abs(got.numpy() - want).max()
    assert 1e-4 < err < 1e-3, err  # well above float32 rounding, and bounded
    assert np.abs(jgot - want).max() < 1e-3


def test_recover_from_mask_and_velocity2position():
    rng = np.random.RandomState(13)
    for mask in (masking.JOINT_MASK_UPPER, masking.JOINT_MASK_LOWER, masking.JOINT_MASK_HANDS):
        x = rand(rng, 2, 4, sum(mask) * 3)
        want = jmasking.recover_from_mask_ts(jnp.asarray(x), mask)
        close(masking.recover_from_mask_ts(torch.from_numpy(x), mask), want, atol=0)
    assert masking.JOINT_MASK_UPPER == jmasking.JOINT_MASK_UPPER
    assert masking.JOINT_MASK_LOWER == jmasking.JOINT_MASK_LOWER
    assert masking.JOINT_MASK_HANDS == jmasking.JOINT_MASK_HANDS
    vel, init = rand(rng, 2, 30, 1), rand(rng, 2, 1)
    close(integrate.velocity2position(torch.from_numpy(vel), 1 / 30, torch.from_numpy(init)),
          jintegrate.velocity2position(jnp.asarray(vel), 1 / 30, jnp.asarray(init)))
