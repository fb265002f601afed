"""The port's serving entry point against the JAX package's, and its rules:
no JAX import, no silent CPU."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplabv3plus_keras_tpu.kernels.upsample_argmax import upsample_argmax_reference
from deeplabv3plus_keras_tpu_torch import SemanticSegmentation, api, cli
from deeplabv3plus_keras_tpu_torch.data import (
    MODE_TRAIN,
    DeviceDataset,
    HostLoader,
    device_batches,
    make_synthetic_voc,
)
from deeplabv3plus_keras_tpu_torch.parallel import build_predict_step, launch
from deeplabv3plus_keras_tpu_torch.utils.jax_weights import load_jax_variables

import torch_spatial_workers
from torch_helpers import conf_dict, jax_model_and_variables

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]


def _served(conf, seed):
    jm, v = jax_model_and_variables(conf, seed=seed)
    seg = SemanticSegmentation(conf, device="cpu")
    load_jax_variables(seg.model, v)
    return jm, v, seg


@pytest.mark.parametrize("refine", [True, False])
def test_segment_cpu_matches_jax_label_path(refine):
    conf = conf_dict(64, refine=refine)
    jm, v, seg = _served(conf, seed=11)
    x = np.random.default_rng(2).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    labels = seg.segment(x)
    logits, up = jm.apply(v, jnp.asarray(x), train=False, return_presample=True)
    ref = np.asarray(upsample_argmax_reference(logits, up))
    assert labels.dtype == np.int32 and labels.shape == (2, 64, 64)
    assert labels.min() >= 0 and labels.max() < 21
    # float32 logits agree to ~1e-6 relative; a label can flip only where
    # two classes tie that closely
    assert (labels != ref).mean() <= 1e-3
    assert len(np.unique(labels)) > 3  # a real segmentation, not a constant


def test_predict_probs_agree_with_segment():
    conf = conf_dict(64)
    _, _, seg = _served(conf, seed=12)
    x = np.random.default_rng(3).uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    probs = build_predict_step(seg.model)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-5)
    assert (probs.argmax(-1) != seg.segment(x)).mean() <= 1e-3


def test_no_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SemanticSegmentation(conf_dict(64))
    assert api.resolve_device("cpu") == torch.device("cpu")
    # the data path and the CLI: no silent CPU either
    loader = HostLoader([], batch_size=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(device_batches(loader, 32, 21))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["/nonexistent/conf.json"])


def test_segment_rejects_bad_images_and_unported_options():
    seg = SemanticSegmentation(conf_dict(64), device="cpu")
    with pytest.raises(ValueError, match=r"\(B, H, W, 3\)"):
        seg.segment(np.zeros((1, 3, 64, 64), np.float32))
    # every backbone of the reference serves (the port once refused
    # EfficientNet, naming Queue A item 14)
    labels = SemanticSegmentation({**conf_dict(32), "base_model": "efficientnetb0"},
                                  device="cpu").segment(np.zeros((2, 32, 32, 3), np.float32))
    assert labels.shape == (2, 32, 32) and labels.min() >= 0 and labels.max() < 21
    # int8_infer serves (the port once refused it, naming Queue A item 15):
    # the first call calibrates on its images, the wide convs run int8
    from deeplabv3plus_keras_tpu_torch.ops import quant

    seg = SemanticSegmentation(conf_dict(64, int8_infer=True), device="cpu")
    quant.reset_counts()
    assert seg.segment(np.zeros((2, 64, 64, 3), np.float32)).shape == (2, 64, 64)
    assert seg._quant and quant.counts["int8_conv"] == len(seg._quant)


@pytest.mark.parametrize("keys,item", [
    ({"multi_gpu": True, "num_gpus": 2}, "launcher"),
    ({"multi_gpu": True, "num_gpus": 4, "allow_fewer_devices": True}, "shrinks"),
    ({"backbone_weights": "/nonexistent/backbone.h5"}, "item 14b"),
    ({"backbone_weights": "imagenet"}, "item 14b"),
    ({"multi_gpu": True, "num_gpus": 3, "mesh_space": 2}, "divide"),
    ({"multi_gpu": True, "num_gpus": 2, "mesh_space": 2, "int8_infer": True}, "item 13c"),
    ({"cache_device": True}, "item 19"),
    ({"hps": {"dtype": "bfloat16"}}, "item 18"),
])
def test_config_keys_that_change_the_result_raise(keys, item, tmp_path, monkeypatch):
    """The JAX facade builds a num_gpus mesh under ``multi_gpu``
    (api.py:90-108), loads ``backbone_weights`` into the backbone
    (api.py:131-133) and shards space under ``mesh_space`` > 1
    (api.py:109-113).  The port runs ``multi_gpu`` over the ranks of a
    process group: with none and no launcher it must refuse rather than
    train on one device, and ``allow_fewer_devices`` shrinks to the one
    process, as the JAX facade shrinks its mesh.  It loads backbone weights
    from a Keras file and downloads nothing: a missing file (an ImageNet one
    absent from an empty Keras cache) raises naming it, before TensorFlow
    is imported.  It shards space over the ranks' (data, space) grid
    (tests/test_torch_spatial.py): a ``mesh_space`` that does not divide
    ``num_gpus`` raises ``ValueError`` before any process group is needed,
    as the JAX facade does (api.py:110-111), and ``int8_infer`` is accepted
    under it (ROADMAP item 13c, which once refused it): two ranks of a gloo
    group build the facade (tests/test_torch_spatial_backbones.py runs
    it).  It keeps the
    dataset in device memory under ``cache_device`` (api.py:221-236,
    ROADMAP item 19) and computes in the ``hps.dtype`` (item 18) as the JAX
    facade does, so those keys are accepted and take effect."""
    conf = {**conf_dict(32), **keys}
    if item == "launcher":
        with pytest.raises(RuntimeError, match="torchrun"):
            SemanticSegmentation(conf, device="cpu")
    elif item == "divide":
        with pytest.raises(ValueError, match="mesh_space 2 must divide num devices 3"):
            SemanticSegmentation(conf, device="cpu")
    elif item == "shrinks":
        seg = SemanticSegmentation(conf, device="cpu")
        assert seg.world == 1
        assert seg.segment(np.zeros((1, 32, 32, 3), np.float32)).shape == (1, 32, 32)
    elif item == "item 18":  # computes in bfloat16; parameters stay float32
        seg = SemanticSegmentation(conf, device="cpu")
        assert seg.model.compute_dtype == torch.bfloat16
        assert {p.dtype for p in seg.model.parameters()} == {torch.float32}
        assert seg.segment(np.zeros((1, 32, 32, 3), np.float32)).shape == (1, 32, 32)
    elif item == "item 14b":  # pretrained backbones: the file must exist
        monkeypatch.setenv("KERAS_HOME", str(tmp_path / "keras"))
        name = ("mobilenet_v2_weights_tf_dim_ordering_tf_kernels_1.0_224_no_top.h5"
                if keys["backbone_weights"] == "imagenet" else "backbone.h5")
        with pytest.raises(FileNotFoundError, match=name):
            SemanticSegmentation(conf, device="cpu")
    elif item == "item 13c":  # int8_infer under mesh_space: two ranks build the facade
        launch.spawn(torch_spatial_workers.facade_build_worker, 2, (str(tmp_path), conf),
                     devices=["cpu"] * 2, timeout_s=120, group_timeout_s=60)
        for r in range(2):
            out = torch.load(tmp_path / f"facade_build_r{r}.pt", weights_only=False)
            assert out == {"world": 2, "grid": (1, 2), "int8": True}, out
    elif item == "item 19":  # the train loader is a device-resident dataset
        root = make_synthetic_voc(str(tmp_path / "voc"), n_train=2, n_val=1, n_test=0,
                                  min_size=20, max_size=30)
        seg = SemanticSegmentation({**conf, "resource_type": "pascal_voc_2012",
                                    "resource_path": root, "workers": 1}, device="cpu")
        loader = seg._loader(MODE_TRAIN, shuffle=True)
        assert isinstance(loader, DeviceDataset) and loader.n == 2
    else:
        with pytest.raises(NotImplementedError, match=item):
            SemanticSegmentation(conf, device="cpu")
    # one GPU asked for, no backbone weights and no spatial split are what
    # the port does
    SemanticSegmentation({**conf_dict(32), "multi_gpu": True, "num_gpus": 1,
                          "backbone_weights": "", "mesh_space": 1}, device="cpu")


def test_port_imports_no_jax():
    """Importing every module of the port (and chip_smoke.py's imports)
    loads no jax, flax or deeplabv3plus_keras_tpu module."""
    code = r"""
import importlib, pkgutil, sys
import deeplabv3plus_keras_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
import importlib.util
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m in ("jax", "flax", "deeplabv3plus_keras_tpu")
             or m.startswith(("jax.", "flax.", "deeplabv3plus_keras_tpu.")))
print("BAD", bad)
print("N", sum(m.startswith("deeplabv3plus_keras_tpu_torch") for m in sys.modules))
print("MODULES", " ".join(m for m in sys.modules if m.startswith("deeplabv3plus_keras_tpu_torch")))
"""
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert int(out.stdout.split("N ")[1].split()[0]) >= 30
    # the modules of the data path, the loops, checkpoints and the CLI
    loaded = set(out.stdout.split("MODULES ")[1].split())
    for m in ("api", "cli", "config", "data", "data.openimages", "data.pipeline",
              "data.synthetic", "data.voc", "kernels.parity_tail", "native", "ops.augment",
              "ops.parity_tail", "ops.preprocess", "ops.resize", "parallel.step", "train.callbacks", "train.checkpoint",
              "train.loss", "utils.preemption", "utils.profiling"):
        assert f"deeplabv3plus_keras_tpu_torch.{m}" in loaded, m


def test_facade_trains_nasnet_mobile_on_a_voc_tree(tmp_path):
    """``train()`` from the JSON config with ``base_model: nasnetmobile``:
    one epoch of 2 steps (4 images, B=2) on a synthetic VOC tree, on the
    CPU; the history is finite and the weights moved."""
    root = make_synthetic_voc(str(tmp_path / "voc"), n_train=4, n_val=2, n_test=0,
                              min_size=30, max_size=50)
    conf = {**conf_dict(32), "base_model": "nasnetmobile", "resource_type": "pascal_voc_2012",
            "resource_path": root, "workers": 1}
    conf["hps"].update(epochs=1, batch_size=2)
    seg = SemanticSegmentation(conf, work_dir=str(tmp_path / "work"), device="cpu")
    w0 = seg.model.base.stem_conv1.weight.detach().clone()
    history = seg.train()
    assert len(history["loss"]) == 1
    assert all(np.isfinite(v) for k in history for v in history[k])
    assert int(seg.optimizer.iterations) == 2
    assert not torch.equal(seg.model.base.stem_conv1.weight, w0)
