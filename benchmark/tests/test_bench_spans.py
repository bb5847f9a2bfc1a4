"""The readers of the program's spans (``harness/spans.py``, ``metrics/*_ms.offline.py``
of ``source`` ``program_span``): each on a synthetic span list, None where its spans are
missing, and a traced run of each cell that gives them."""
import sys
import time

import pytest

from conftest import BENCH_DIR, tiny_cell
from harness import common, spans

EMAGE_READERS = ("window_ms.offline", "remainder_ms.offline", "ar_self_ms.offline",
                 "vq_parts_ms.offline")
CAMN_READERS = ("wav_encoder_ms.offline", "lstm_ms.offline")


def reader(name):
    return common.load_module(BENCH_DIR / "metrics" / f"{name}.py", "t_" + name.replace(".", "_"))


class Spans:
    """A span list as ``pantomatrix_tpu_torch.utils.trace.spans()`` gives it."""

    def __init__(self):
        self.list = []

    def add(self, name, ms, parent=None, **attrs):
        sid = len(self.list) + 1
        call = sid if parent is None else next(s["call"] for s in self.list
                                               if s["id"] == parent)
        self.list.append({"id": sid, "name": name, "attrs": attrs, "parent": parent,
                          "call": call, "host_start_ns": 0, "host_end_ns": 0,
                          "device_ms": ms})
        return sid


def emage_call(s, windows=(20.0, 24.0, 22.0), captured=(), remainder=15.0, total=100.0,
               parts=(10.0, 20.0, 30.0, 40.0), decode=130.0):
    root = s.add("emage.inference", total, batch=128, rounds=len(windows), remain=56)
    for i, ms in enumerate(windows):
        w = s.add("emage.window", ms, root, index=i,
                  graph="captured" if i in captured else "replayed")
        if i in captured:  # a capture's eager warm-ups decode their parts
            s.add("vq.part", 1.0, w, part="face")
    if remainder is not None:
        r = s.add("emage.remainder", remainder, root, frames=60)
        s.add("vq.part", 2.0, r, part="face")
    d = s.add("emage.decode", decode, frames=1800)
    for part, ms in zip(("face", "upper", "hands", "lower"), parts):
        s.add("vq.part", ms, d, part=part)


def camn_call(s, encoder, layers):
    root = s.add("camn.forward", sum(layers) + encoder + 1.0, batch=64, frames=421)
    s.add("camn.audio_encoder", encoder, root)
    for i, ms in enumerate(layers):
        s.add("lstm.layer", ms, root, layer=i % 4, t=421, b=64)


def read_all(monkeypatch, span_list, names):
    monkeypatch.setattr(spans, "recorded", lambda: span_list)
    return {n: reader(n).read({}) for n in names}


def test_emage_readers(monkeypatch):
    s = Spans()
    emage_call(s, windows=(30.0, 20.0, 24.0, 22.0), captured=(0,))
    got = read_all(monkeypatch, s.list, EMAGE_READERS)
    assert got["window_ms.offline"] == pytest.approx(22.0)  # replays only
    assert got["remainder_ms.offline"] == pytest.approx(15.0)
    assert got["ar_self_ms.offline"] == pytest.approx(100.0 - 96.0 - 15.0)
    assert got["vq_parts_ms.offline"] == pytest.approx(100.0)  # not the window's parts


def test_emage_readers_take_the_median_over_calls(monkeypatch):
    s = Spans()
    emage_call(s, remainder=10.0, total=80.0, parts=(1.0, 1.0, 1.0, 1.0))
    emage_call(s, remainder=20.0, total=90.0, parts=(2.0, 2.0, 2.0, 2.0))
    emage_call(s, remainder=30.0, total=200.0, parts=(3.0, 3.0, 3.0, 3.0))
    got = read_all(monkeypatch, s.list, EMAGE_READERS)
    assert got["window_ms.offline"] == pytest.approx(22.0)
    assert got["remainder_ms.offline"] == pytest.approx(20.0)
    assert got["ar_self_ms.offline"] == pytest.approx(90.0 - 66.0 - 20.0)
    assert got["vq_parts_ms.offline"] == pytest.approx(8.0)


def test_camn_readers(monkeypatch):
    s = Spans()
    camn_call(s, 5.0, [6.0] * 8)
    camn_call(s, 7.0, [7.0] * 8)
    camn_call(s, 6.0, [6.5] * 8)
    got = read_all(monkeypatch, s.list, CAMN_READERS)
    assert got["wav_encoder_ms.offline"] == pytest.approx(6.0)
    assert got["lstm_ms.offline"] == pytest.approx(52.0)


@pytest.mark.parametrize("case", ["no program spans", "no device time", "other family",
                                  "no replayed window"])
def test_readers_give_none_where_their_spans_are_missing(monkeypatch, case):
    s = Spans()
    if case == "no device time":
        emage_call(s)
        camn_call(s, 5.0, [6.0] * 8)
        for span in s.list:
            span["device_ms"] = None
    elif case == "other family":
        camn_call(s, 5.0, [6.0] * 8)
        assert read_all(monkeypatch, s.list, ["lstm_ms.offline"])["lstm_ms.offline"] == 48.0
        got = read_all(monkeypatch, s.list, EMAGE_READERS)
        assert set(got.values()) == {None}
        s = Spans()
        emage_call(s)
        got = read_all(monkeypatch, s.list, CAMN_READERS)
        assert set(got.values()) == {None}
        return
    elif case == "no replayed window":
        emage_call(s, windows=(30.0,), captured=(0,), remainder=None)
        got = read_all(monkeypatch, s.list, ["window_ms.offline", "remainder_ms.offline"])
        assert set(got.values()) == {None}
        return
    got = read_all(monkeypatch, None if case == "no program spans" else s.list,
                   EMAGE_READERS + CAMN_READERS)
    assert set(got.values()) == {None}


def test_a_program_without_the_recorder_gives_none(monkeypatch):
    monkeypatch.setitem(sys.modules, "pantomatrix_tpu_torch.utils.trace", None)
    assert spans.recorded() is None
    assert {reader(n).read({}) for n in EMAGE_READERS + CAMN_READERS} == {None}


@pytest.mark.parametrize("name", ["camn-offline-bf16", "emage-offline-bf16"])
def test_traced_cpu_run_reads_no_device_span(name):
    """On the CPU the program's spans have no device time, so no span metric is read;
    the traced run goes on and reports the rest."""
    import run
    from pantomatrix_tpu_torch.utils import trace

    trace.clear()
    cell = tiny_cell(name)
    out = run.run_cell(cell, 2**31 + 5, 0.0, True, time.time(), device="cpu")
    assert out["line"]["correct"]
    names = [m["name"] for m in cell["per_layer"] if m["source"] == "program_span"
             and m["name"] in EMAGE_READERS + CAMN_READERS]
    assert set(names) == set(EMAGE_READERS if name.startswith("emage") else CAMN_READERS)
    assert not set(names) & set(out["line"]["metrics"])
    program = spans.recorded()
    assert program and all(s["device_ms"] is None for s in program)


@pytest.mark.card
@pytest.mark.parametrize("name", ["camn-offline-bf16", "emage-offline-bf16"])
def test_traced_card_run_reads_every_span_metric(card, name):
    """A traced run of the tiny cell on the card reports each span metric of its cell,
    and no device-typed event of the profile carries a span's name."""
    import run
    from pantomatrix_tpu_torch.utils import trace

    trace.clear()
    cell = tiny_cell(name)
    out = run.run_cell(cell, 2**31 + 5, 0.0, True, time.time(), device=str(card))
    mine = EMAGE_READERS if name.startswith("emage") else CAMN_READERS
    assert out["line"]["correct"]
    assert set(mine) <= set(out["line"]["metrics"])
    assert all(out["line"]["metrics"][n]["value"] > 0 for n in mine
               if n != "ar_self_ms.offline")
    names = {s["name"] for s in trace.spans()}
    kernels = {k for k, _, _ in out["result"]["profile"]["kernels"]}
    assert names and not names & kernels
