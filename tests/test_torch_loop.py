"""The port's epoch loops ``train()``, ``evaluate()`` and ``test()`` and its
callbacks against the JAX package's, on a synthetic VOC tree the test
writes (64², B=2, dropout 0, no augmentation: the port cannot reproduce
``jax.random``).  Test-time augmentation: test_torch_tta.py; the CLI and
checkpoints: test_torch_checkpoint.py."""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplabv3plus_keras_tpu import SemanticSegmentation as JaxSeg
from deeplabv3plus_keras_tpu.train import callbacks as jcb
from deeplabv3plus_keras_tpu_torch import SemanticSegmentation
from deeplabv3plus_keras_tpu_torch.data import make_synthetic_voc
from deeplabv3plus_keras_tpu_torch.train import callbacks as pcb
from deeplabv3plus_keras_tpu_torch.utils.jax_weights import load_jax_variables

from torch_helpers import conf_dict, jax_model_and_variables

torch.set_num_threads(1)
SIZE = 64


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("voc"))
    make_synthetic_voc(root, n_train=6, n_val=4, n_test=3, min_size=40, max_size=90)
    return root


def _conf(root, **extra):
    conf = conf_dict(SIZE, resource_type="pascal_voc_2012", resource_path=root, workers=1,
                     max_queue_size=4, **extra)
    conf["hps"].update(epochs=2, batch_size=2)
    conf["nn_arch"]["dropout_rate"] = 0.0
    return conf


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


@pytest.fixture(scope="module")
def pair(tree, tmp_path_factory):
    """A JAX facade and a port facade holding the same initial weights."""
    conf = _conf(tree)
    jwd, pwd = str(tmp_path_factory.mktemp("jax")), str(tmp_path_factory.mktemp("port"))
    jseg = JaxSeg(conf, work_dir=jwd)
    pseg = SemanticSegmentation(conf, work_dir=pwd, device="cpu")
    load_jax_variables(pseg.model, {"params": _numpy_tree(jseg.state.params),
                                    "batch_stats": _numpy_tree(jseg.state.batch_stats)})
    return jseg, pseg


def _same_weights(jseg, pseg, seed):
    """O(1) weights from a seed (torch_helpers), set in both facades."""
    _, v = jax_model_and_variables(_conf("unused"), seed=seed)
    jseg.state = jseg.state.replace(params=jax.tree_util.tree_map(jnp.asarray, v["params"]),
                                    batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                                       v["batch_stats"]))
    load_jax_variables(pseg.model, v)


def test_train_history_matches_jax(pair):
    """Per-epoch train and val losses within 2e-3 relative of the JAX
    package's train() (tests/test_trajectory_parity.py's float32 bound),
    and both save a best-val checkpoint."""
    jseg, pseg = pair
    jh, ph = jseg.train(), pseg.train()
    assert len(ph["loss"]) == len(jh["loss"]) == 2
    for key in ("loss", "val_loss"):
        np.testing.assert_allclose(ph[key], jh[key], rtol=2e-3, err_msg=key)
    assert all(np.isfinite(ph["miou"] + ph["val_miou"]))
    assert pseg.optimizer.iterations == int(jseg.state.step) == 6
    assert os.path.isfile(os.path.join(pseg.work_dir, pseg.MODEL_PATH, "state", "state.pt"))


def test_evaluate_and_test_match_jax(pair):
    """With the same weights: evaluate()'s mIoU within 1e-6 of the JAX
    package's, and test()'s PNGs (named after the inputs) equal on
    ≥ 99.9 % of pixels."""
    from PIL import Image

    jseg, pseg = pair
    _same_weights(jseg, pseg, seed=21)
    jm, pm = jseg.evaluate(), pseg.evaluate()
    assert abs(pm.result() - jm.result()) <= 1e-6
    assert pm.total_cm.sum() == jm.total_cm.sum() > 0
    jseg.test()
    pseg.test()
    jdir = Path(jseg.work_dir) / "test_results"
    pdir = Path(pseg.work_dir) / "test_results"
    names = sorted(p.name for p in pdir.iterdir())
    assert names == sorted(p.name for p in jdir.iterdir()) == [f"te_{i:04d}.png" for i in range(3)]
    same = total = 0
    for n in names:
        a, b = np.asarray(Image.open(pdir / n)), np.asarray(Image.open(jdir / n))
        assert a.shape == b.shape == (SIZE, SIZE) and a.dtype == np.uint8
        same += int((a == b).sum())
        total += a.size
    assert same >= 0.999 * total
    # result_saving writes one 4-panel PNG per valid sample
    pseg.evaluate(result_saving=True)
    panels = sorted(os.listdir(os.path.join(pseg.work_dir, "results")))
    assert len(panels) == 4
    assert np.asarray(Image.open(os.path.join(pseg.work_dir, "results", panels[0]))).shape == (
        SIZE, 4 * SIZE, 3)


def test_callbacks_lr_sequences_equal_jax():
    losses = [3.0, 2.0, 2.0, 2.00005, 1.99995, 2.5, 2.5, 2.5, 2.5, 2.5, 1.0, 1.0, 1.0, 1.0,
              1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0]
    jp, pp = jcb.ReduceLROnPlateau(0.5, patience=3), pcb.ReduceLROnPlateau(0.5, patience=3)
    jl = pl = 1e-3
    for loss in losses:
        jl, pl = jp.update(loss, jl), pp.update(loss, pl)
        assert pl == jl
    assert pl < 1e-3
    for spec in ({}, {"type": "poly", "power": 0.9, "end_lr": 1e-6},
                 {"type": "exponential"}, {"type": "exponential", "factor": 0.5}):
        js, ps = jcb.LRSchedule(spec, 1e-3, 7, 0.9), pcb.LRSchedule(spec, 1e-3, 7, 0.9)
        assert [ps.lr(e) for e in range(9)] == [js.lr(e) for e in range(9)]
    with pytest.raises(ValueError, match="lr_schedule"):
        pcb.LRSchedule({"type": "cosine"}, 1e-3, 3)
