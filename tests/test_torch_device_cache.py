"""The device-resident dataset (config key ``cache_device``) on the port,
on the CPU: ``data/pipeline.py`` ``DeviceDataset`` and
``ops/preprocess.py`` ``prepare_batch_from_cache`` against the JAX
package's and against the port's own streaming path (the cases of
tests/test_device_cache.py, tests/test_device_cache_partial.py and the
cache-build case of tests/test_preemption.py).

Tolerances: the batches of a cached epoch equal the streaming path's in
composition, order, names and masks, and in labels exactly; pixels to
1e-6 (the same float32 arithmetic on the same uint8 canvases; the JAX
package's own test allows 1e-6 for its fused gather).  ``train()``'s
history with the cache equals the streaming one exactly: the same batches
in the same order through the same steps.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplabv3plus_keras_tpu.data import pipeline as jpipe
from deeplabv3plus_keras_tpu.data import voc as jvoc
from deeplabv3plus_keras_tpu.ops.preprocess import prepare_batch_from_cache as jax_from_cache
from deeplabv3plus_keras_tpu_torch import SemanticSegmentation
from deeplabv3plus_keras_tpu_torch.data import (
    MODE_TEST,
    MODE_TRAIN,
    DeviceDataset,
    HostLoader,
    device_batches,
    make_synthetic_voc,
    pascal_voc_2012,
)
from deeplabv3plus_keras_tpu_torch.ops.preprocess import prepare_batch_from_cache

from torch_helpers import conf_dict

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
BPS = 64 * 64 * 4 + 8  # canvas² × (3 image + 1 label) + sizes


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    return make_synthetic_voc(str(tmp_path_factory.mktemp("voc")), n_train=7, n_val=0,
                              n_test=3, min_size=40, max_size=64)


def _collect(src, with_labels=True, one_hot=True):
    out = []
    for b in device_batches(src, 64, 21, with_labels, one_hot_labels=one_hot, device="cpu"):
        out.append({"image": np.asarray(b["image"]),
                    "label": np.asarray(b["label"]) if with_labels else None,
                    "valid": np.asarray(b["valid"]), "names": b["names"]})
    return out


def _jax_collect(src, with_labels=True, one_hot=True):
    return [{"image": np.asarray(b["image"]),
             "label": np.asarray(b["label"]) if with_labels else None,
             "valid": np.asarray(b["valid"]), "names": b["names"]}
            for b in jpipe.device_batches(src, 64, 21, with_labels, one_hot_labels=one_hot)]


def _assert_same_batches(a, b, with_labels=True):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x["names"] == y["names"]
        np.testing.assert_array_equal(x["valid"], y["valid"])
        # the whole batch, the padded tail included (zeroed rows of sizes
        # (1, 1), as the streaming path's canvases)
        np.testing.assert_allclose(x["image"], y["image"], atol=1e-6, rtol=0)
        if with_labels:
            np.testing.assert_array_equal(x["label"], y["label"])


@pytest.mark.parametrize("shuffle", [False, True])
def test_device_dataset_matches_host_path(voc_root, shuffle):
    """Two epochs (shuffled with seed + epoch): the cached batches equal the
    port's streaming batches and the JAX package's cached batches."""
    specs = pascal_voc_2012(voc_root, MODE_TRAIN)
    kw = dict(batch_size=3, canvas_size=64, workers=1, shuffle=shuffle, seed=5)
    host = HostLoader(specs, **kw)
    ds = DeviceDataset(HostLoader(specs, **kw), "cpu")
    jds = jpipe.DeviceDataset(jpipe.HostLoader(jvoc.pascal_voc_2012(voc_root, jvoc.MODE_TRAIN),
                                               **kw))
    assert ds.steps() == host.steps() == jds.steps() == 3
    assert ds.data_img.dtype == torch.uint8 and ds.data_img.shape == (7, 64, 64, 3)
    for _ in range(2):
        cached = _collect(ds)
        _assert_same_batches(_collect(host), cached)
        _assert_same_batches(_jax_collect(jds), cached)


def test_device_dataset_unlabeled_and_sparse(voc_root):
    test_specs = pascal_voc_2012(voc_root, MODE_TEST)
    kw = dict(batch_size=2, canvas_size=64, workers=1, with_labels=False)
    ds = DeviceDataset(HostLoader(test_specs, **kw), "cpu")
    assert ds.data_lab is None
    _assert_same_batches(_collect(HostLoader(test_specs, **kw), with_labels=False),
                         _collect(ds, with_labels=False), with_labels=False)

    specs = pascal_voc_2012(voc_root, MODE_TRAIN)
    kw = dict(batch_size=3, canvas_size=64, workers=1)
    a = _collect(HostLoader(specs, **kw), one_hot=False)
    b = _collect(DeviceDataset(HostLoader(specs, **kw), "cpu"), one_hot=False)
    assert all(y["label"].ndim == 3 and y["label"].dtype == np.int32 for y in b)
    _assert_same_batches(a, b)


def test_prepare_batch_from_cache_matches_jax():
    """Gather + preprocess of the same uint8 arrays, a padded row included."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (5, 48, 48, 3), dtype=np.uint8)
    lab = rng.integers(0, 30, (5, 48, 48), dtype=np.uint8)
    lab[:, ::7] = 255
    sizes = np.array([[48, 40], [30, 48], [17, 9], [48, 48], [1, 1]], np.int32)
    idx = np.array([3, 0, 2, 1], np.int64)
    valid = np.array([1, 1, 1, 0], np.int32)
    for one_hot in (True, False):
        jimg, jlab = jax_from_cache(jnp.asarray(img), jnp.asarray(lab), jnp.asarray(sizes),
                                    jnp.asarray(idx), jnp.asarray(valid), size=32,
                                    one_hot_labels=one_hot)
        pimg, plab = prepare_batch_from_cache(
            torch.from_numpy(img), torch.from_numpy(lab), torch.from_numpy(sizes),
            torch.from_numpy(idx), torch.from_numpy(valid), size=32, one_hot_labels=one_hot)
        np.testing.assert_allclose(pimg.numpy(), np.asarray(jimg), atol=1e-6, rtol=0)
        np.testing.assert_array_equal(plab.numpy(), np.asarray(jlab))
        # the padded row: a zero canvas of size (1, 1), as a streamed tail
        np.testing.assert_array_equal(pimg[3].numpy(), pimg.new_full((32, 32, 3), -1.0).numpy())
    jimg, _ = jax_from_cache(jnp.asarray(img), None, jnp.asarray(sizes), jnp.asarray(idx),
                             jnp.asarray(valid), size=32, with_labels=False)
    pimg, plab = prepare_batch_from_cache(torch.from_numpy(img), None, torch.from_numpy(sizes),
                                          torch.from_numpy(idx), torch.from_numpy(valid), size=32,
                                          with_labels=False)
    assert plab is None
    np.testing.assert_allclose(pimg.numpy(), np.asarray(jimg), atol=1e-6, rtol=0)


def _loader(voc_root, **over):
    kw = dict(batch_size=3, canvas_size=64, workers=1, shuffle=True, seed=5)
    kw.update(over)
    return HostLoader(pascal_voc_2012(voc_root, MODE_TRAIN), **kw)


def _epoch_names(src):
    names, n_batches = [], 0
    for b in device_batches(src, 64, 21, True, one_hot_labels=True, device="cpu"):
        v = np.asarray(b["valid"]).astype(bool)
        names += [n for n, ok in zip(b["names"], v) if ok]
        assert tuple(b["image"].shape) == (3, 64, 64, 3)
        assert tuple(b["label"].shape) == (3, 64, 64, 21)
        n_batches += 1
    return names, n_batches


def test_partial_cache_streams_remainder(voc_root, capsys):
    ds = DeviceDataset(_loader(voc_root), "cpu", max_bytes=4 * BPS)  # 4 of 7 fit
    assert "cache_device: HBM budget fits 4/7 samples" in capsys.readouterr().out
    assert ds.n == 4 and ds.residual_loader is not None
    assert len(ds.residual_loader.specs) == 3
    assert ds.steps() == 2 + 1  # ceil(4/3) cached + ceil(3/3) streamed
    all_specs = [s.name for s in pascal_voc_2012(voc_root, MODE_TRAIN)]
    for _ in range(2):  # every sample exactly once an epoch
        names, n_batches = _epoch_names(ds)
        assert sorted(names) == sorted(all_specs)
        assert n_batches == ds.steps()


def test_partial_cache_epochs_shuffle_both_parts(voc_root):
    """Reshuffled each epoch, the same cover; and the JAX package's partial
    cache gives the same order (cached part, then the streamed part)."""
    ds = DeviceDataset(_loader(voc_root), "cpu", max_bytes=4 * BPS)
    jds = jpipe.DeviceDataset(jpipe.HostLoader(
        jvoc.pascal_voc_2012(voc_root, jvoc.MODE_TRAIN), batch_size=3, canvas_size=64,
        workers=1, shuffle=True, seed=5), max_bytes=4 * BPS)
    e1, _ = _epoch_names(ds)
    e2, _ = _epoch_names(ds)
    assert sorted(e1) == sorted(e2) and e1 != e2
    j1 = [n for b in _jax_collect(jds) for n, ok in zip(b["names"], b["valid"]) if ok]
    assert j1 == e1


def test_zero_budget_degrades_to_host_streaming(voc_root, capsys):
    ds = DeviceDataset(_loader(voc_root), "cpu", max_bytes=0, residual_cache=True)
    assert "fits 0/7" in capsys.readouterr().out
    assert ds.n == 0 and len(ds.residual_loader.specs) == 7
    assert ds.residual_loader.cache  # cache_decoded semantics for the stream
    names, _ = _epoch_names(ds)
    assert len(names) == 7


def test_full_budget_unchanged(voc_root, capsys):
    full = DeviceDataset(_loader(voc_root), "cpu")  # no limit off the card
    assert full.n == 7 and full.residual_loader is None and full.steps() == 3
    assert "cache_device" not in capsys.readouterr().out


def _conf(root, **extra):
    conf = conf_dict(32, resource_type="pascal_voc_2012", resource_path=root, workers=1,
                     **extra)
    conf["hps"].update(epochs=2, batch_size=3)
    conf["nn_arch"]["dropout_rate"] = 0.0
    return conf


def test_train_history_with_cache_equals_streaming(tmp_path, capsys):
    """train() for 2 epochs with and without cache_device, from the same
    weights: the same history, exactly.  A partial cache (3 of 6 samples at
    the facade's 512 canvas) shuffles its cached and streamed samples apart,
    so its history differs; it trains, and says how it split."""
    root = make_synthetic_voc(str(tmp_path / "voc"), n_train=6, n_val=2, n_test=0,
                              min_size=24, max_size=40)
    streamed = SemanticSegmentation(_conf(root), work_dir=str(tmp_path / "a"), device="cpu")
    cached = SemanticSegmentation(_conf(root, cache_device=True), work_dir=str(tmp_path / "b"),
                                  device="cpu")
    cached.model.load_state_dict(streamed.model.state_dict())
    h_stream, h_cache = streamed.train(), cached.train()
    assert h_cache == h_stream and len(h_cache["loss"]) == 2
    assert "cache_device" not in capsys.readouterr().out

    partial = SemanticSegmentation(
        _conf(root, cache_device=True, cache_device_max_bytes=3 * (512 * 512 * 4 + 8)),
        work_dir=str(tmp_path / "c"), device="cpu")
    h = partial.train()
    assert "cache_device: HBM budget fits 3/6 samples" in capsys.readouterr().out
    assert len(h["loss"]) == 2 and all(np.isfinite(v) for k in h for v in h[k])


def test_sigterm_during_cache_build_saves_and_exits(tmp_path):
    """SIGTERM during the DeviceDataset build unwinds as Preempted; train()
    saves a resume checkpoint and returns (tests/test_preemption.py:156)."""
    root = make_synthetic_voc(str(tmp_path / "resource"), n_train=4, n_val=2, n_test=0,
                              min_size=24, max_size=40)
    conf = _conf(root, cache_device=True)
    conf["hps"]["epochs"] = 3
    (tmp_path / "conf.json").write_text(json.dumps(conf))
    child = r"""
import json, os, signal, sys
from deeplabv3plus_keras_tpu_torch import SemanticSegmentation
from deeplabv3plus_keras_tpu_torch.data import pipeline

workdir = sys.argv[1]
conf = json.load(open(os.path.join(workdir, "conf.json")))
ss = SemanticSegmentation(conf, work_dir=workdir, device="cpu")
# SIGTERM arrives while the cache build drains its first batch
orig = pipeline.HostLoader._assemble
def hooked(self, specs):
    os.kill(os.getpid(), signal.SIGTERM)
    return orig(self, specs)
pipeline.HostLoader._assemble = hooked
ss.train()
print("TRAIN_RETURNED", flush=True)
"""
    script = tmp_path / "child_cache.py"
    script.write_text(child)
    out = subprocess.run([sys.executable, "-u", str(script), str(tmp_path)], capture_output=True,
                         text=True, timeout=300, env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stdout + out.stderr
    assert "SIGTERM received: checkpoint saved" in out.stdout
    assert "TRAIN_RETURNED" in out.stdout
    assert (tmp_path / "semantic_segmentation_deeplabv3plus" / "state.resume").is_dir()
