"""The frozen reference against the program at small widths on the CPU, in float32,
with one set of seeded weights loaded into both: every output within float32 rounding."""
import json

import pytest
import torch

from conftest import BENCH_DIR, TINY_MODEL
from harness import weights
from harness.common import relative_error
from reference.camn import Camn
from reference.emage import Emage, Suite, decode, follow, generate, route, windows
from reference.layers import LSTM, set_numerics

TOL = 1e-5  # float32 rounding through a few dozen layers


def model_cfg(name):
    cfg = json.loads((BENCH_DIR / "configs" / f"{name}.json").read_text())["model"]
    cfg.update(TINY_MODEL[name])
    return cfg


def test_weights_follow_the_seed():
    a = weights.build(lambda: Camn(model_cfg("camn")), 5, "cpu").state_dict()
    b = weights.build(lambda: Camn(model_cfg("camn")), 5, "cpu").state_dict()
    c = weights.build(lambda: Camn(model_cfg("camn")), 6, "cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["body_out.fc1.weight"], c["body_out.fc1.weight"])
    assert float(a["audio_encoder.feat_extractor.0.bn1.running_var"].min()) == 1.0


def test_lstm_is_torch_lstm():
    ref = weights.build(lambda: LSTM(8, 16, 2), 2, "cpu")
    lstm = torch.nn.LSTM(8, 16, 2, batch_first=True, bidirectional=True)
    lstm.load_state_dict(ref.state_dict())
    x = torch.randn(3, 7, 8)
    with torch.no_grad():
        assert relative_error(ref(x), lstm(x)[0]) < TOL


def test_camn_equals_program():
    from pantomatrix_tpu_torch.models.api import CamnAudioModel
    from pantomatrix_tpu_torch.models.configs import CamnAudioConfig

    cfg = model_cfg("camn")
    ref = weights.build(lambda: Camn(cfg), 1, "cpu")
    prog = CamnAudioModel(CamnAudioConfig(**cfg), device="cpu")
    prog.load_state_dict(ref.state_dict(), strict=True)
    audio = torch.rand(2, 32000, generator=torch.Generator().manual_seed(0)) * 2 - 1
    spk = torch.zeros(2, 1, dtype=torch.long)
    with torch.no_grad():
        r, p = ref(audio, spk), prog(audio, spk)
    for k in r:
        assert relative_error(p[k], r[k]) < TOL, k


@pytest.fixture(scope="module")
def emage_pair():
    from pantomatrix_tpu_torch.models.api import EmageAudioModel, EmageVQModel
    from pantomatrix_tpu_torch.models.configs import EmageAudioConfig

    cfg = model_cfg("emage")
    ref = weights.build(lambda: Emage(cfg), 3, "cpu")
    suite = weights.build(lambda: Suite(), 4, "cpu")
    prog = EmageAudioModel(EmageAudioConfig(**cfg), device="cpu")
    prog.load_state_dict(ref.state_dict(), strict=True)
    vq = EmageVQModel.random(device="cpu")
    vq.load_state_dict(suite.state_dict(), strict=True)
    return cfg, ref, suite, prog, vq


def test_emage_generation_equals_program(emage_pair):
    cfg, ref, suite, prog, vq = emage_pair
    audio = torch.rand(2, 16000, generator=torch.Generator().manual_seed(1)) * 2 - 1
    spk = torch.zeros(2, 1, dtype=torch.long)
    with torch.no_grad():
        r, p = generate(ref, suite, audio, spk), prog.inference(audio, spk, vq)
    assert sorted(r) == sorted(p)
    for k in r:
        assert r[k].shape == p[k].shape and relative_error(p[k], r[k]) < TOL, k


def test_emage_decode_equals_program(emage_pair):
    from pantomatrix_tpu_torch.models.emage import _select_decode_inputs

    cfg, ref, suite, prog, vq = emage_pair
    audio = torch.rand(2, 16000, generator=torch.Generator().manual_seed(2)) * 2 - 1
    spk = torch.zeros(2, 1, dtype=torch.long)
    trans = torch.rand(2, 1, 3)
    with torch.no_grad():
        net = prog.inference(audio, spk, vq, compute_dtype="bfloat16")
        p = vq.decode(**_select_decode_inputs(prog.config, net), get_global_motion=True,
                      ref_trans=trans)
        r = decode(suite, route(cfg, net), trans)
    for k in ("motion_axis_angle", "expression", "trans", "all_motion4inference"):
        assert relative_error(p[k], r[k]) < TOL, k


def test_follow_reads_the_reference_itself(emage_pair):
    """Followed from its own generation, the reference reads float32 rounding in every
    window after the first, the remainder too, and keeps every row; a seed handed on
    wrong from the third window on parts every row there."""
    cfg, ref, suite, _, _ = emage_pair
    audio = torch.rand(3, 16000, generator=torch.Generator().manual_seed(3)) * 2 - 1
    spk = torch.zeros(3, 1, dtype=torch.long)
    with torch.no_grad():
        own = generate(ref, suite, audio, spk)
        first, later = follow(ref, suite, audio, spk, own, block=2)
        plan = windows(cfg, 30)
        assert [s for s, _, _, _ in later] == [s for s, _, _ in plan[1:]]
        assert plan[-1][1] < cfg["pose_length"]  # the last is a remainder window
        assert all(len(rows) == 3 and float(err.max()) < TOL for _, _, rows, err in later)
        assert relative_error(first["rec_upper"][:, :6], own["rec_upper"][:, :6]) < TOL
        wrong = {k: v.clone() for k, v in own.items()}
        s2 = plan[2][0]
        for k in wrong:  # the third window's outputs as if its seed were the identity's
            wrong[k][:, s2:] = generate(ref, suite, audio[:, s2 * 16000 // 30:], spk)[k][
                :, :wrong[k].shape[1] - s2]
        _, later = follow(ref, suite, audio, spk, wrong)
    assert len(later) == 2 and float(later[1][3].min()) > 0.05


def test_control_precision_departs():
    """The control's rounding is not the reference's: fp8 products move a CaMN forward
    by more than float32 rounding does, and float32 leaves it exact."""
    cfg = model_cfg("camn")
    ref = weights.build(lambda: Camn(cfg), 1, "cpu")
    audio = torch.rand(2, 32000, generator=torch.Generator().manual_seed(0)) * 2 - 1
    spk = torch.zeros(2, 1, dtype=torch.long)
    with torch.no_grad():
        exact = ref(audio, spk)["motion"]
        low = set_numerics(ref, "float8_e4m3")(audio, spk)["motion"]
        again = set_numerics(ref, "float32")(audio, spk)["motion"]
    assert torch.equal(exact, again)
    assert relative_error(low, exact) > 1e-3
