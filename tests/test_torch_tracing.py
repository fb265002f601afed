"""The port's profiler ranges (``utils/profiling.py`` ``span``): where they
open, that they nest as documented, that the autograd nodes of the
operations inside a BN or depthwise range carry its sequence numbers into
the backward, and that they are plain CPU operations (no user annotation,
nothing on the device's timeline), recorded only under an active
profiler.  CPU, the flagship at 32², B = 2."""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deeplabv3plus_keras_tpu_torch import SemanticSegmentation
from deeplabv3plus_keras_tpu_torch.data import MODE_TRAIN, make_synthetic_voc
from deeplabv3plus_keras_tpu_torch.kernels import depthwise
from deeplabv3plus_keras_tpu_torch.models.blocks import BatchNorm
from deeplabv3plus_keras_tpu_torch.utils import profiling, span

from torch_helpers import conf_dict

torch.set_num_threads(1)
SIZE, BATCH = 32, 2
STEP_CHILDREN = ("dlv3.step.forward", "dlv3.step.tail", "dlv3.step.backward",
                 "dlv3.step.optimizer")


def _events(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return list(prof.profiler.kineto_results.events())


def _named(events, name):
    return [e for e in events if e.name() == name]


def _inside(child, parent) -> bool:
    a, b = parent.start_ns(), parent.start_ns() + parent.duration_ns()
    return a <= child.start_ns() and child.start_ns() + child.duration_ns() <= b


def _range(name):
    with span(name):
        pass


def _images(seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    label = np.eye(21, dtype=np.float32)[rng.integers(0, 21, (BATCH, SIZE, SIZE))]
    return {"image": _images(seed), "label": label, "valid": np.ones(BATCH, np.int32)}


@pytest.fixture(scope="module")
def seg(tmp_path_factory):
    return SemanticSegmentation(conf_dict(SIZE), work_dir=str(tmp_path_factory.mktemp("w")),
                                device="cpu")


@pytest.fixture(scope="module")
def sites(seg):
    """(depthwise passes, BN modules) of one forward: the model's
    (C, 1, k, k) weights with k > 1, and its BatchNorm modules."""
    dw = [w for w in seg.model.parameters()
          if w.dim() == 4 and w.shape[1] == 1 and w.shape[-1] > 1]
    bn = [m for m in seg.model.modules() if isinstance(m, BatchNorm)]
    return len(dw), len(bn)


@pytest.fixture(scope="module")
def step_events(seg):
    seg.train_step(_batch())  # the first step's one-time work outside the trace
    return _events(lambda: seg.train_step(_batch(1)))


def test_segment_records_its_three_phases_and_every_site(seg, sites):
    labels = []
    events = _events(lambda: labels.append(seg.segment(_images())))
    assert labels[0].shape == (BATCH, SIZE, SIZE)
    [outer] = _named(events, "dlv3.segment")
    for name in ("dlv3.segment.copy_in", "dlv3.segment.forward", "dlv3.segment.copy_out"):
        [child] = _named(events, name)
        assert _inside(child, outer), name
    n_dw, n_bn = sites
    assert n_dw == 18 and n_bn > n_dw  # 13 backbone and 5 ASPP depthwise passes
    assert len(_named(events, "dlv3.dw_site")) == n_dw
    assert len(_named(events, "dlv3.bn")) == n_bn


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_records_each_phase_once_a_microbatch(seg, sites, step_events, tmp_path,
                                                         accum):
    events = step_events
    if accum > 1:
        conf = conf_dict(SIZE, grad_accum=accum)
        other = SemanticSegmentation(conf, work_dir=str(tmp_path), device="cpu")
        events = _events(lambda: other.train_step(_batch()))
    [outer] = _named(events, "dlv3.step")
    for name in STEP_CHILDREN:
        found = _named(events, name)
        assert len(found) == (1 if name == "dlv3.step.optimizer" else accum), name
        assert all(_inside(e, outer) for e in found), name
    n_dw, n_bn = sites
    assert len(_named(events, "dlv3.dw_site")) == n_dw * accum
    assert len(_named(events, "dlv3.bn")) == n_bn * accum


@pytest.mark.parametrize("name", ["dlv3.dw_site", "dlv3.bn"])
def test_forward_ops_of_a_range_have_backward_nodes(step_events, name):
    """Every forward operation inside the ranges that carries a sequence
    number has a backward node with it, so a trace can attribute the
    backward's kernels to the range; each range holds at least one."""
    ranges = _named(step_events, name)
    fwd = [e for e in step_events if e.sequence_nr() >= 0 and e.fwd_thread_id() == 0
           and not e.name().startswith("dlv3.")]
    bwd = {(e.fwd_thread_id(), e.sequence_nr()) for e in step_events
           if e.sequence_nr() >= 0 and e.fwd_thread_id() != 0}
    claimed = set()
    for r in ranges:
        inside = [e for e in fwd if e.start_thread_id() == r.start_thread_id() and _inside(e, r)]
        assert inside, name
        for e in inside:
            assert (e.start_thread_id(), e.sequence_nr()) in bwd, (name, e.name())
            claimed.add((e.start_thread_id(), e.sequence_nr()))
    if name == "dlv3.bn":  # BN's own backward nodes, one a range, and no neighbour's
        nodes = [e.name() for e in step_events if e.fwd_thread_id() != 0
                 and (e.fwd_thread_id(), e.sequence_nr()) in claimed
                 and not e.name().startswith("autograd::engine")]
        assert nodes == ["NativeBatchNormBackward0"] * len(ranges)


def test_ranges_are_no_user_annotations(step_events):
    ours = [e for e in step_events if e.name().startswith("dlv3.")]
    assert ours and not any(e.is_user_annotation() for e in ours)
    assert all(e.sequence_nr() < 0 for e in ours)
    # a record_function range is one, and the device's timeline repeats it
    def other():
        with torch.profiler.record_function("other"):
            pass

    events = _events(other)
    assert any(e.is_user_annotation() for e in _named(events, "other"))


def test_no_profiler_no_record(monkeypatch):
    """A range outside a profiler records nothing; without the fast range
    in the installed torch, ``span`` is a no-op, never ``record_function``."""
    with span("dlv3.before"):
        pass
    events = _events(lambda: _range("dlv3.during"))
    assert [e.name() for e in events if e.name().startswith("dlv3.")] == ["dlv3.during"]
    monkeypatch.setattr(profiling, "_Range", None)
    assert isinstance(span("dlv3.x"), contextlib.nullcontext)
    events = _events(lambda: _range("dlv3.none"))
    assert not [e for e in events if e.name().startswith("dlv3.")]


@pytest.mark.parametrize("layout,window", [("nhwc", None), ("nhwc", (5, 1)),
                                           ("bhcw", None), ("bhcw", (5, 1))])
def test_one_dw_site_a_pass_on_every_route(monkeypatch, layout, window):
    """One range a pass on the plain, channels-first and row-window routes
    (the channels-first window calls the pass again inside)."""
    monkeypatch.setenv("DLV3_DW_LAYOUT", layout)
    x = torch.randn(1, 4, 6 if window else 8, 8).contiguous(memory_format=torch.channels_last)
    w = torch.randn(4, 1, 3, 3)
    events = _events(lambda: depthwise.depthwise_conv(x, w, window=window))
    assert len(_named(events, "dlv3.dw_site")) == 1
    events = _events(lambda: depthwise.depthwise_cf(x.contiguous(), w))
    assert len(_named(events, "dlv3.dw_site")) == 1


def test_device_data_path_one_range_a_batch(seg, tmp_path):
    """``dlv3.data.batch`` once a batch, from the device cache and from the
    streamed loader."""
    root = make_synthetic_voc(str(tmp_path / "voc"), n_train=4, n_val=0, n_test=0,
                              min_size=30, max_size=40)
    conf = dict(conf_dict(SIZE), resource_type="pascal_voc_2012", resource_path=root,
                workers=1)
    for extra in ({"cache_device": True}, {}):
        other = SemanticSegmentation(dict(conf, **extra), work_dir=str(tmp_path / "w"),
                                     device="cpu")
        loader = other._loader(MODE_TRAIN)
        got = []
        events = _events(lambda: got.extend(other._batches(loader)))
        assert len(got) == 2
        assert len(_named(events, "dlv3.data.batch")) == 2, extra
