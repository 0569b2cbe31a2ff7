"""CPU tests of the per-layer readers of the program's spans and of the
train window's conv operators: each on a made-up span snapshot (the
recorder's, ``brats2019_tpu_torch/utils/profile.py``) and a made-up
``trace.Profile``, and None outside its kind or without what it reads.

Run from the checkout's root: ``python -m pytest perfbench/tests -q``.
"""

import types

import pytest

from conftest import REPO
from perfbench import harness, trace, yardstick

PREDICT = {"kind": "predict"}
TRAIN = {"kind": "train"}
READERS = ("prep_wait_ms.predict", "prep_span_ms.predict", "cc_host_ms.predict",
           "sample_ms.train", "conv_roofline.train")


def _span(name, host_ms, device_ms=None, parent=None):
    return types.SimpleNamespace(name=name, host_ms=host_ms, device_ms=device_ms,
                                 parent=parent)


def _predict_spans():
    """Two volumes: each a prep, a wait with its device edges, a program
    whose ``program.cc`` holds two flag reads."""
    out = []
    for wait, prep in ((4.0, 120.0), (2.0, 140.0)):
        out.append(_span("predict.prep", prep))
        out.append(_span("predict.await_prep", wait + 1.0, device_ms=wait))
        program = _span("predict.program", 200.0, device_ms=190.0)
        cc = _span("program.cc", 30.0, parent=program)
        out += [program, cc, _span("cc.sync", 2.0, device_ms=0.5, parent=cc),
                _span("cc.sync", 3.0, device_ms=1.5, parent=cc)]
    out.append(_span("predict.await_post", 50.0, device_ms=40.0))
    return out


def _train_spans():
    out = []
    for sample in (12.0, 18.0):
        step = _span("train.step", 95.0)
        out += [step, _span("train.sample", sample, parent=step)]
    return out


@pytest.fixture
def snapshot(monkeypatch):
    from brats2019_tpu_torch.utils import profile

    spans = []
    monkeypatch.setattr(profile, "snapshot", lambda: list(spans))
    return spans


def _read(name, readings, prof=None):
    return harness.reader(REPO, name)(readings, prof)


def test_predict_readers(snapshot):
    snapshot += _predict_spans()
    assert _read("prep_wait_ms.predict", PREDICT) == pytest.approx(3.0)
    assert _read("prep_span_ms.predict", PREDICT) == pytest.approx(130.0)
    assert _read("cc_host_ms.predict", PREDICT) == pytest.approx(25.0)


def test_sample_reader(snapshot):
    snapshot += _train_spans()
    assert _read("sample_ms.train", TRAIN) == pytest.approx(15.0)


def _profile(calls):
    return trace.Profile(window_s=1.0, busy_s=0.8, device_ops=[], idle_gaps=[],
                         op_calls=calls)


def test_conv_roofline_train_counts_forward_dgrad_and_wgrad():
    x, w, wt = (2, 16, 16, 16, 32), (3, 3, 3, 32, 64), (3, 3, 3, 64, 32)
    y = (2, 16, 16, 16, 64)
    calls = [("brats_torch::conv3d_stats", (x, w), 2e-4),
             ("brats_torch::conv3d", (y, wt), 3e-4),
             ("brats_torch::conv3d_wgrad", (x, y, w), 5e-4),
             ("brats_torch::instance_norm_act", (y,), 1e-4)]
    bound = yardstick.conv_bound_s(x[:4] + (32, 64))
    want = 100.0 * (bound + yardstick.conv_bound_s(y + (32,)) + bound) / 1e-3
    assert _read("conv_roofline.train", TRAIN, _profile(calls)) == pytest.approx(want)
    # without the wgrad operator (a program before it) there is nothing to read
    assert _read("conv_roofline.train", TRAIN, _profile(calls[:2])) is None


@pytest.mark.parametrize("name", READERS)
def test_none_outside_its_kind_or_without_spans(snapshot, name):
    calls = [("brats_torch::conv3d_wgrad",
              ((1, 8, 8, 8, 16), (1, 8, 8, 8, 16), (3, 3, 3, 16, 16)), 1e-4)]
    snapshot += _predict_spans() + _train_spans()
    own, other = (TRAIN, PREDICT) if name.endswith(".train") else (PREDICT, TRAIN)
    assert _read(name, own, _profile(calls)) is not None
    assert _read(name, other, _profile(calls)) is None
    assert _read(name, {}, None) is None
    snapshot.clear()
    if name != "conv_roofline.train":
        assert _read(name, own, _profile(calls)) is None


def test_device_edge_reader_none_without_edges(snapshot):
    """A run without a card keeps spans without device edges."""
    snapshot += [_span(s.name, s.host_ms, parent=s.parent) for s in _predict_spans()]
    assert _read("prep_wait_ms.predict", PREDICT) is None


def test_readers_none_where_the_program_has_no_recorder(monkeypatch):
    """A program without ``utils/profile.snapshot``, as a parent commit before
    the spans: every span reader returns None and raises nothing."""
    from brats2019_tpu_torch.utils import profile

    monkeypatch.delattr(profile, "snapshot")
    for name in READERS[:4]:
        readings = TRAIN if name.endswith(".train") else PREDICT
        assert _read(name, readings) is None
