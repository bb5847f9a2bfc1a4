"""The port's spans (``pantomatrix_tpu_torch/utils/trace.py``): off without a profiler,
nested and kept under one, host-only events in the trace, the spans of the EMAGE and
CaMN offline paths, outputs unchanged by them, and the store's cap."""
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pantomatrix_tpu_torch.models import api, configs, emage
from pantomatrix_tpu_torch.models.emage_graph import WindowStepGraphs, _Graph
from pantomatrix_tpu_torch.utils import trace

CB = 16
EMAGE_KW = dict(audio_f=32, motion_f=16, hidden_size=32, speaker_dims=4, pose_length=8,
                seed_frames=2, vae_codebook_size=CB, vae_length=CB)


@pytest.fixture(autouse=True)
def empty_store():
    trace.clear()
    yield
    trace.clear()


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def by_name(spans, name):
    return [s for s in spans if s["name"] == name]


def test_no_profiler_records_nothing():
    with trace.span("outer", torch.zeros(2), a=1) as s:
        trace.annotate("outer", b=2)
        with trace.span("inner"):
            torch.ones(3).sum()
    assert s is None
    assert trace.spans() == [] and trace.dropped() == 0


def test_spans_nest_with_parents_and_call_ids():
    with cpu_profile():
        with trace.span("root", torch.zeros(1), n=1) as root:
            with trace.span("child", k=0):
                with trace.span("leaf"):
                    pass
                trace.annotate("leaf", ignored=True)  # not the innermost open span
                trace.annotate("child", seen=True)
            with trace.span("child", k=1):
                pass
        with trace.span("root", n=2):
            pass
    assert root is not None
    got = trace.spans()
    assert [s["name"] for s in got] == ["leaf", "child", "child", "root", "root"]
    leaf, c0, c1, r1, r2 = got
    assert r1["parent"] is None and r2["parent"] is None
    assert c0["parent"] == c1["parent"] == r1["id"] and leaf["parent"] == c0["id"]
    assert leaf["call"] == c0["call"] == c1["call"] == r1["call"] == r1["id"]
    assert r2["call"] == r2["id"] != r1["id"]
    assert c0["attrs"] == {"k": 0, "seen": True} and leaf["attrs"] == {}
    assert r1["attrs"] == {"n": 1}
    assert all(s["device_ms"] is None for s in got)  # no CUDA tensor: host only
    assert r1["host_start_ns"] <= c0["host_start_ns"] <= leaf["host_start_ns"]
    assert leaf["host_end_ns"] <= c0["host_end_ns"] <= c1["host_start_ns"] <= r1["host_end_ns"]


def test_spans_are_host_events_not_user_annotations():
    with cpu_profile() as prof:
        with trace.span("outer.span"):
            with trace.span("inner.span"):
                torch.ones(8).cumsum(0)
    events = [e for e in prof.events() if e.name in ("outer.span", "inner.span")]
    assert sorted(e.name for e in events) == ["inner.span", "outer.span"]
    for e in events:
        assert not e.is_user_annotation
        assert e.device_type == torch.autograd.DeviceType.CPU


def test_nothing_recorded_while_a_graph_is_captured(monkeypatch):
    monkeypatch.setattr(trace, "_capturing", lambda: True)
    with cpu_profile():
        with trace.span("captured") as s:
            pass
    assert s is None and trace.spans() == []


def test_store_cap_drops_and_counts(monkeypatch):
    monkeypatch.setattr(trace, "MAX_SPANS", 3)
    with cpu_profile():
        for i in range(5):
            with trace.span("s", i=i):
                pass
    assert [s["attrs"]["i"] for s in trace.spans()] == [0, 1, 2]
    assert trace.dropped() == 2
    trace.clear()
    assert trace.spans() == [] and trace.dropped() == 0


def tiny_emage():
    cfg = configs.EmageAudioConfig(**EMAGE_KW)
    part = lambda dim, seed: api.EmageVQVAEConv(
        configs.EmageVQVAEConvConfig(vae_test_dim=dim, vae_length=CB, vae_codebook_size=CB),
        seed=seed, device="cpu")
    vq = api.EmageVQModel(face=part(106, 1), upper=part(78, 2), hands=part(180, 3),
                          lower=part(61, 4),
                          global_motion=api.EmageVAEConv(configs.EmageVAEConvConfig(
                              vae_layer=4, vae_length=48, vae_test_dim=61), seed=5,
                              device="cpu"))
    return api.EmageAudioModel(cfg, seed=6, device="cpu"), vq


def emage_call(model, vq, audio):
    speaker = torch.zeros(audio.shape[0], 1, dtype=torch.long)
    net = model.inference(audio, speaker, vq)
    dec = vq.decode(**emage._select_decode_inputs(model.config, net), get_global_motion=True,
                    ref_trans=torch.zeros(audio.shape[0], 1, 3))
    return net, dec


@pytest.mark.parametrize("frames,rounds,remainder", [(24, 3, True), (21, 3, False)])
def test_emage_offline_spans(frames, rounds, remainder):
    """Seed 2, window 8, stride 6: 24 frames are 3 windows and a remainder of 4 > 2
    frames; 21 frames are 3 windows and a remainder of 1, which is not generated."""
    model, vq = tiny_emage()
    audio = torch.Generator().manual_seed(frames)
    audio = 0.1 * torch.randn(2, frames * 16000 // 30 + 1, generator=audio)
    off = emage_call(model, vq, audio)
    assert trace.spans() == []
    with cpu_profile():
        on = emage_call(model, vq, audio)
    got = trace.spans()
    (inf,) = by_name(got, "emage.inference")
    assert inf["parent"] is None
    assert inf["attrs"] == {"batch": 2, "rounds": rounds, "remain": frames - 2 - 6 * rounds}
    windows = by_name(got, "emage.window")
    assert [w["attrs"] for w in windows] == [{"index": i, "graph": "eager"}
                                             for i in range(rounds)]
    assert all(w["parent"] == inf["id"] for w in windows)
    rem = by_name(got, "emage.remainder")
    assert len(rem) == int(remainder)
    if remainder:
        assert rem[0]["parent"] == inf["id"]
        assert rem[0]["attrs"] == {"frames": 6}
    (dec,) = by_name(got, "emage.decode")
    assert dec["parent"] is None
    assert dec["attrs"] == {"frames": frames if remainder else 6 * rounds}
    parts = by_name(got, "vq.part")
    final = [p for p in parts if p["parent"] == dec["id"]]
    assert [p["attrs"]["part"] for p in final] == ["face", "upper", "hands", "lower"]
    # every window's seed decode and the remainder's decode their four parts too
    assert len(parts) == 4 * (rounds + remainder + 1)
    assert all(p["call"] in (inf["id"], dec["id"]) for p in parts)
    for a, b in zip(off, on):  # the spans leave the outputs as they were
        for k in a:
            if a[k] is None:
                assert b[k] is None
            else:
                assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_camn_forward_spans(compute_dtype):
    n_layer = 2
    model = api.CamnAudioModel(configs.CamnAudioConfig(hidden_size=32, n_layer=n_layer),
                               device="cpu")
    audio = 0.1 * torch.randn(2, 2 * 16000, generator=torch.Generator().manual_seed(3))
    speaker = torch.zeros(2, 1, dtype=torch.long)
    off = model(audio, speaker, compute_dtype=compute_dtype)
    with cpu_profile():
        on = model(audio, speaker, compute_dtype=compute_dtype)
    got = trace.spans()
    (fwd,) = by_name(got, "camn.forward")
    t = off["motion"].shape[1]
    assert fwd["parent"] is None and fwd["attrs"] == {"batch": 2, "frames": t}
    (enc,) = by_name(got, "camn.audio_encoder")
    layers = by_name(got, "lstm.layer")
    assert [s["attrs"] for s in layers] == [{"layer": i, "t": t, "b": 2}
                                           for i in range(n_layer)] * 2  # body, hands
    assert all(s["parent"] == fwd["id"] for s in [enc] + layers)
    assert enc["host_end_ns"] <= layers[0]["host_start_ns"]
    for k in off:
        assert torch.equal(off[k], on[k]), k


def test_window_graph_tells_its_span_replayed_or_captured(monkeypatch):
    """``WindowStepGraphs.run`` marks the open window span: captured on the first call
    at a key, replayed after (the capture is stubbed: it needs a card)."""
    cache = WindowStepGraphs()
    owner = torch.nn.Linear(2, 2)
    stub = _Graph(types.SimpleNamespace(replay=lambda: None), (id(owner),), None,
                  (torch.zeros(2),), "outputs", (0, 0))
    monkeypatch.setattr(cache, "_capture", lambda fn, inputs, ids, weights:
                        stub._replace(weights=weights))
    key = ("slot", (id(owner),))
    with cpu_profile():
        for i in range(3):
            with trace.span("emage.window", index=i, graph="eager"):
                assert cache.run(key, None, (torch.ones(2),), (owner,)) == "outputs"
        cache.run(key, None, (torch.ones(2),), (owner,))  # no open window span: no change
    assert [s["attrs"]["graph"] for s in trace.spans()] == ["captured", "replayed", "replayed"]
