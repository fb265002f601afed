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
from deeplabv3plus_keras_tpu_torch import SemanticSegmentation, api
from deeplabv3plus_keras_tpu_torch.parallel import build_predict_step
from deeplabv3plus_keras_tpu_torch.utils.jax_weights import load_jax_variables

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


def test_segment_rejects_bad_images_and_unported_options():
    seg = SemanticSegmentation(conf_dict(64), device="cpu")
    with pytest.raises(ValueError, match=r"\(B, S, S, 3\)"):
        seg.segment(np.zeros((1, 3, 64, 64), np.float32))
    with pytest.raises(NotImplementedError, match="Queue A item 14"):
        SemanticSegmentation({**conf_dict(64), "base_model": "efficientnetb0"}, device="cpu")
    with pytest.raises(NotImplementedError, match="int8_infer"):
        SemanticSegmentation(conf_dict(64, int8_infer=True), device="cpu")


@pytest.mark.parametrize("keys,item", [
    ({"model_loading": True}, "item 11"),
    ({"multi_gpu": True, "num_gpus": 2}, "item 13"),
    ({"multi_gpu": True, "num_gpus": 4, "allow_fewer_devices": True}, "item 13"),
    ({"backbone_weights": "/nonexistent/backbone.h5"}, "item 14"),
    ({"backbone_weights": "imagenet"}, "item 14"),
    ({"mesh_space": 2}, "item 13"),
])
def test_config_keys_that_change_the_result_raise(keys, item):
    """The JAX facade restores the checkpoint in work_dir under
    ``model_loading`` (api.py:135-136), builds a num_gpus mesh under
    ``multi_gpu`` (api.py:90-108), loads ``backbone_weights`` into the
    backbone (api.py:131-133) and shards space under ``mesh_space`` > 1
    (api.py:109-113); the port does none of these yet, so it must refuse
    rather than train from random weights on one device."""
    with pytest.raises(NotImplementedError, match=item):
        SemanticSegmentation({**conf_dict(32), **keys}, device="cpu")
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
"""
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert int(out.stdout.split("N ")[1]) >= 15
