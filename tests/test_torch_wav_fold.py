"""The low-precision copy's WavEncoder: eval BatchNorm folded into its convs
(``nn/blocks.FoldedWavEncoder``, made by ``utils/precision.cast_floating``).

The benchmark draws every BatchNorm as mean 0, variance 1, weight 1, bias 0, where a
fold is nearly the identity; here the statistics and affines are drawn at random
(mean N(0, 0.5), variance U(0.25, 4), weight U(0.5, 1.5), bias N(0, 0.5)), so a fold
that drops the shift or scales by 1/var in place of 1/sqrt(var + eps) is off by tens of
percent.

Bounds. In float32 the folded encoder is the encoder's arithmetic reassociated
(w * s in place of conv then * s), so it is held to 1e-5 relative L2 over the output
(float32 rounding through 12 convs reads 1.5-3.5e-7). In bfloat16 (8 mantissa bits, a
relative rounding of 2^-9 a value) the output is held to 0.02 relative L2 against the
float32 encoder: the folded copy reads 0.0029-0.0039 over three draws of each variant,
the per-call BatchNorm arithmetic of ``nn/layers.batch_norm1d`` 0.0037-0.0049, and the
two faults above 0.39-0.99.
"""
import numpy as np
import pytest
import torch

from pantomatrix_tpu_torch.models import camn, configs
from pantomatrix_tpu_torch.nn.blocks import FoldedWavEncoder, WavEncoder
from pantomatrix_tpu_torch.nn.layers import BatchNorm1d, fold_batch_norm
from pantomatrix_tpu_torch.utils.precision import cast_floating, cast_once

torch.set_num_threads(2)

BF16 = torch.bfloat16
VARIANTS = {"emage": 32, "camn": 128}  # out_dim; "camn" widths are fixed at 32-128
SMALL_CAMN = dict(audio_f=128, speaker_f=8, speaker_dims=4, hidden_size=48, n_layer=2,
                  pose_dims=258, body_dims=78, hands_dims=180, dropout_prob=0.0)


def draw_batch_norms(module: torch.nn.Module, seed: int) -> None:
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, BatchNorm1d):
                c = m.running_var.numel()
                m.running_mean.copy_(torch.randn(c, generator=g) * 0.5)
                m.running_var.copy_(0.25 + 3.75 * torch.rand(c, generator=g))
                m.weight.copy_(0.5 + torch.rand(c, generator=g))
                m.bias.copy_(torch.randn(c, generator=g) * 0.5)


def encoder(variant: str, seed: int = 0) -> WavEncoder:
    enc = WavEncoder(VARIANTS[variant], variant, generator=torch.Generator().manual_seed(seed))
    draw_batch_norms(enc, seed + 100)
    return enc


def wave(rows: int = 2, samples: int = 8000, seed: int = 1) -> torch.Tensor:
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.uniform(-0.5, 0.5, (rows, samples)).astype(np.float32))


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm())


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_folded_float32_is_the_encoders_arithmetic(variant):
    enc, wav = encoder(variant), wave()
    with torch.no_grad():
        want = enc(wav)
        got = FoldedWavEncoder(enc, torch.float32)(wav)
    assert got.shape == want.shape
    assert rel(got, want) < 1e-5


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_bf16_copy_is_folded_and_within_the_bf16_bound(variant):
    enc, wav = encoder(variant), wave()
    folded = cast_once(enc, BF16)
    assert isinstance(folded, FoldedWavEncoder)
    assert all(p.dtype == BF16 and not p.requires_grad for p in folded.parameters())
    with torch.no_grad():
        want = enc(wav)
        got = folded(wav.to(BF16))
    assert got.dtype == BF16 and got.shape == want.shape
    assert rel(got, want) < 0.02


@pytest.mark.parametrize("fault", ["no_shift", "var_for_sqrt"])
def test_a_wrong_fold_misses_the_bf16_bound(fault, monkeypatch):
    """The bound above separates the faults a fold can make."""
    import pantomatrix_tpu_torch.nn.blocks as blocks

    def wrong(conv, bn):
        with torch.no_grad():
            s = bn.weight * (torch.rsqrt(bn.running_var + bn.eps) if fault == "no_shift"
                             else 1.0 / bn.running_var)
            b = conv.bias * s if fault == "no_shift" else \
                (conv.bias - bn.running_mean) * s + bn.bias
            return conv.weight * s[:, None, None], b

    enc, wav = encoder("camn"), wave()
    monkeypatch.setattr(blocks, "fold_batch_norm", wrong)
    with torch.no_grad():
        err = rel(FoldedWavEncoder(enc, BF16)(wav.to(BF16)), enc(wav))
    assert err > 0.3


def test_fold_rounds_once_from_the_float32_tensors():
    enc = encoder("emage")
    folded = cast_floating(enc, BF16)
    for block, p in zip(enc.feat_extractor, folded.blocks):
        w1, b1 = fold_batch_norm(block.conv1, block.bn1)
        w2, b2 = fold_batch_norm(block.conv2, block.bn2)
        assert torch.equal(p["w1"][:, :, 0], w1.to(BF16))
        assert torch.equal(p["b1"], b1.to(BF16))
        assert torch.equal(p["w2"][:, :, 0], w2.to(BF16))
        cout, cin, k = block.conv1.weight.shape  # channels_last strides, even at Cin = 1
        assert p["w1"].stride() == (k * cin, 1, k * cin, cin)
        if block.downsample is None:
            assert torch.equal(p["b2"], b2.to(BF16)) and "wd" not in p
        else:  # the second conv's bias is carried by the shortcut's, summed in float32
            wd, bd = fold_batch_norm(*block.downsample)
            assert p.get("b2") is None
            assert torch.equal(p["wd"][:, :, 0], wd.to(BF16))
            assert torch.equal(p["bd"], (bd + b2).to(BF16))
    # folding the rounded copies instead would round twice: that differs somewhere
    bn, conv = enc.feat_extractor[0].bn1, enc.feat_extractor[0].conv1
    s = (bn.weight.to(BF16) * torch.rsqrt(bn.running_var.to(BF16) + bn.eps)).detach()
    assert not torch.equal(folded.blocks[0]["w1"][:, :, 0],
                           (conv.weight.to(BF16) * s[:, None, None]).detach())


def test_original_state_dict_is_untouched_and_loads_strictly():
    model = camn.CamnAudio(configs.CamnAudioConfig(**SMALL_CAMN),
                           generator=torch.Generator().manual_seed(0))
    draw_batch_norms(model, 5)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    copy_ = cast_once(model, BF16)
    assert isinstance(copy_.audio_encoder, FoldedWavEncoder)
    assert isinstance(model.audio_encoder, WavEncoder)
    after = model.state_dict()
    assert list(after) == list(before)
    assert all(torch.equal(after[k], v) and after[k].dtype == v.dtype for k, v in before.items())
    fresh = camn.CamnAudio(configs.CamnAudioConfig(**SMALL_CAMN),
                           generator=torch.Generator().manual_seed(1))
    fresh.load_state_dict(after, strict=True)
    assert all(torch.equal(fresh.state_dict()[k], v) for k, v in before.items())


def test_cast_once_refolds_after_a_load_and_after_an_in_place_buffer_write():
    enc, wav = encoder("camn"), wave()
    first = cast_once(enc, BF16)
    assert cast_once(enc, BF16) is first
    enc.load_state_dict(encoder("camn", seed=7).state_dict(), strict=True)
    second = cast_once(enc, BF16)
    assert second is not first
    with torch.no_grad():
        assert rel(second(wav.to(BF16)), enc(wav)) < 0.02
        enc.feat_extractor[2].bn2.running_var.mul_(3.0)
    third = cast_once(enc, BF16)
    assert third is not second
    with torch.no_grad():
        assert rel(third(wav.to(BF16)), enc(wav)) < 0.02
        assert rel(second(wav.to(BF16)), enc(wav)) > 0.02  # the stale fold is wrong


def test_train_mode_and_the_float32_path_are_never_folded():
    enc = encoder("emage")
    assert cast_once(enc, None) is enc
    enc.feat_extractor[3].bn1.train()
    cast = cast_once(enc, BF16)
    assert type(cast) is WavEncoder and cast.feat_extractor[3].bn1.training
    assert cast.feat_extractor[0].conv1.weight.dtype == BF16
    enc.feat_extractor[3].bn1.eval()  # a mode change makes a new copy, folded
    assert isinstance(cast_once(enc, BF16), FoldedWavEncoder)
    model = camn.CamnAudio(configs.CamnAudioConfig(**SMALL_CAMN),
                           generator=torch.Generator().manual_seed(0)).train()
    assert type(cast_once(model, BF16).audio_encoder) is WavEncoder
