"""The port's checkpoints (``train/checkpoint.py``: state_dicts in the JAX
package's two-slot layout), ``model_loading``, ``resume``, the SIGTERM
guard in ``train()``, and the CLI, on a synthetic VOC tree the test writes."""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplabv3plus_keras_tpu_torch import SemanticSegmentation
from deeplabv3plus_keras_tpu_torch.data import make_synthetic_voc
from deeplabv3plus_keras_tpu_torch.train import checkpoint as ckpt

from torch_helpers import conf_dict

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("voc"))
    make_synthetic_voc(root, n_train=4, n_val=2, n_test=3, min_size=40, max_size=90)
    return root


def _conf(root, epochs=2, **extra):
    conf = conf_dict(32, resource_type="pascal_voc_2012", resource_path=root, workers=1,
                     max_queue_size=4, **extra)
    conf["hps"].update(epochs=epochs, batch_size=2, lr=1e-3)
    conf["nn_arch"]["dropout_rate"] = 0.0
    return conf


def _state(seg):
    return ({k: v.clone() for k, v in seg.model.state_dict().items()},
            [t.clone() for t in seg.optimizer.m + seg.optimizer.v],
            seg.optimizer.iterations, seg.optimizer.lr)


def _assert_same_state(a, b):
    for k in a[0]:
        assert torch.equal(a[0][k], b[0][k]), k
    assert all(torch.equal(x, y) for x, y in zip(a[1], b[1]))
    assert a[2:] == b[2:]


def test_save_restore_and_best_only(tree, tmp_path):
    """Save then restore gives the same weights, BN statistics and Adam
    state; a worse val_loss is not saved under best-only; model_loading
    restores at construction."""
    wd = str(tmp_path)
    seg = SemanticSegmentation(_conf(tree), work_dir=wd, device="cpu")
    rng = np.random.default_rng(0)
    batch = {"image": rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32),
             "label": rng.integers(0, 21, (2, 32, 32))}
    seg.train_step(batch)
    seg.optimizer.lr = 5e-4
    assert ckpt.save_checkpoint(seg.model, seg.optimizer, wd, val_loss=1.0)
    saved = _state(seg)
    seg.train_step(batch)
    assert not ckpt.save_checkpoint(seg.model, seg.optimizer, wd, val_loss=1.5)
    assert json.load(open(os.path.join(wd, ckpt.MODEL_DIR, "state", ckpt.SLOT_META))) == {
        "step": 1, "val_loss": 1.0}
    moved = _state(seg)
    assert ckpt.restore_checkpoint(seg.model, seg.optimizer, wd) == 1
    _assert_same_state(_state(seg), saved)
    assert not torch.equal(moved[1][0], saved[1][0])
    again = SemanticSegmentation(_conf(tree, model_loading=True), work_dir=wd, device="cpu")
    _assert_same_state(_state(again), saved)
    fresh = SemanticSegmentation(_conf(tree), work_dir=wd, device="cpu")
    assert fresh.optimizer.iterations == 0  # without model_loading nothing is read
    assert ckpt.save_checkpoint(seg.model, seg.optimizer, wd, val_loss=0.5)  # a better one
    assert not os.path.exists(os.path.join(wd, ckpt.MODEL_DIR, "state.old"))


def test_resume_slot_continues_at_the_right_epoch(tree, tmp_path):
    """A run stopped after epoch 2 with a resume save, restored with
    model_loading + resume, runs epoch 3 alone and matches the run that
    never stopped; finishing drops the resume slot."""
    straight = SemanticSegmentation(_conf(tree, epochs=3), work_dir=str(tmp_path / "a"),
                                    device="cpu").train()
    wd = str(tmp_path / "b")
    first = SemanticSegmentation(_conf(tree, epochs=2), work_dir=wd, device="cpu")
    first.train()
    assert ckpt.save_checkpoint(first.model, first.optimizer, wd, best_only=False)
    resume_dir = os.path.join(wd, ckpt.MODEL_DIR, "state.resume")
    assert json.load(open(os.path.join(resume_dir, ckpt.SLOT_META))) == {"step": 4}
    second = SemanticSegmentation(_conf(tree, epochs=3, model_loading=True, resume=True),
                                  work_dir=wd, device="cpu")
    assert second.optimizer.iterations == 4
    h = second.train()
    assert len(h["loss"]) == 1 and second.optimizer.iterations == 6
    np.testing.assert_allclose(h["loss"][0], straight["loss"][2], rtol=1e-6)
    np.testing.assert_allclose(h["val_loss"][0], straight["val_loss"][2], rtol=1e-6)
    assert not os.path.exists(resume_dir)
    assert "resume_step" not in json.load(open(os.path.join(wd, ckpt.MODEL_DIR, "meta.json")))
    ckpt.clear_resume_checkpoint(wd)  # nothing left to clear
    assert ckpt.checkpoint_exists(wd) and not ckpt.checkpoint_exists(str(tmp_path / "none"))


def test_nan_guard_and_profile_logdir(tree, tmp_path):
    """A non-finite epoch loss raises before any checkpoint is written
    (nan_guard), unless nan_guard is off; profile_logdir writes a
    torch.profiler trace of the first epoch."""
    seg = SemanticSegmentation(_conf(tree, epochs=1), work_dir=str(tmp_path / "a"), device="cpu")
    real = seg._train_step

    def poisoned(batch):
        out = real(batch)
        return {"loss": out["loss"] * float("nan"), "cm": out["cm"]}

    seg._train_step = poisoned
    with pytest.raises(FloatingPointError, match="non-finite training loss"):
        seg.train()
    assert not ckpt.checkpoint_exists(str(tmp_path / "a"))
    logdir = tmp_path / "profile"
    seg = SemanticSegmentation(_conf(tree, epochs=1, nan_guard=False, profile_logdir=str(logdir)),
                               work_dir=str(tmp_path / "b"), device="cpu")
    seg._train_step = lambda batch, real=seg._train_step: {**real(batch),
                                                          "loss": torch.tensor(float("nan"))}
    h = seg.train()
    assert np.isnan(h["loss"][0])
    assert json.loads((logdir / "trace.json").read_text())["traceEvents"]
    assert "Self CPU" in (logdir / "key_averages.txt").read_text()


CHILD = r"""
import json, sys
from deeplabv3plus_keras_tpu_torch import SemanticSegmentation
conf = json.load(open(sys.argv[2]))
seg = SemanticSegmentation(conf, work_dir=sys.argv[1], device="cpu")
seg.train()
print("TRAIN_RETURNED", seg.optimizer.iterations, flush=True)
"""


def test_sigterm_mid_training_saves_and_returns(tree, tmp_path):
    """SIGTERM during train() finishes the step in flight, writes the resume
    slot and returns; model_loading then restores that step."""
    conf = _conf(tree, epochs=1000, metrics_log=str(tmp_path / "metrics.jsonl"))
    (tmp_path / "conf.json").write_text(json.dumps(conf))
    (tmp_path / "child.py").write_text(CHILD)
    proc = subprocess.Popen([sys.executable, "-u", str(tmp_path / "child.py"), str(tmp_path),
                             str(tmp_path / "conf.json")], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, cwd=REPO,
                            env={**os.environ, "PYTHONPATH": str(REPO)})
    lines = []
    try:
        deadline = time.time() + 240
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("epoch 2/"):
                proc.send_signal(signal.SIGTERM)
                break
            assert time.time() < deadline, "".join(lines)
        out, _ = proc.communicate(timeout=120)
    finally:
        proc.kill()
    lines.append(out)
    text = "".join(lines)
    assert proc.returncode == 0, text
    assert "SIGTERM received: checkpoint saved" in text and "TRAIN_RETURNED" in text
    step = int(text.split("TRAIN_RETURNED")[1].split()[0])
    assert step >= 4
    meta = json.load(open(tmp_path / ckpt.MODEL_DIR / "state.resume" / ckpt.SLOT_META))
    assert meta == {"step": step}
    assert json.loads((tmp_path / "metrics.jsonl").read_text().splitlines()[-1])["preempted"]
    seg = SemanticSegmentation(_conf(tree, model_loading=True), work_dir=str(tmp_path),
                               device="cpu")
    assert seg.optimizer.iterations == step


def test_cli_trains_evaluates_and_tests(tree, tmp_path):
    """python -m deeplabv3plus_keras_tpu_torch.cli conf.json --device cpu,
    for modes train, evaluate, test and convert_to_tf_lite, with the loop's
    extra keys."""
    conf = _conf(tree, metrics_log=str(tmp_path / "metrics.jsonl"), sparse_labels=True,
                 lr_schedule={"type": "poly"}, cache_decoded=True, loader_backend="pil",
                 eval_per_class_iou=True, prepro_device=-1)
    conf["hps"]["epochs"] = 1

    def run(mode, **kw):
        path = tmp_path / f"{mode}.json"
        path.write_text(json.dumps({**conf, "mode": mode, **kw}))
        out = subprocess.run([sys.executable, "-m", "deeplabv3plus_keras_tpu_torch.cli",
                              str(path), "--device", "cpu"], cwd=tmp_path, capture_output=True,
                             text=True, timeout=300, env={**os.environ, "PYTHONPATH": str(REPO)})
        assert out.returncode == 0, out.stderr[-3000:]
        return out.stdout

    assert "epoch 1/1" in run("train")
    assert json.loads((tmp_path / "metrics.jsonl").read_text().splitlines()[-1])["epoch"] == 1
    out = run("evaluate", model_loading=True)
    assert "per-class IoU" in out and "aeroplane" in out and "mean iou" in out
    run("test", model_loading=True)
    assert sorted(os.listdir(tmp_path / "test_results")) == [f"te_{i:04d}.png" for i in range(3)]
    # convert_to_tf_lite writes the torch.export program into the working
    # directory, which a process that imports the port loads
    out = run("convert_to_tf_lite")
    assert "no .tflite written" in out
    assert (tmp_path / "semantic_segmentation_deeplabv3plus.pt2").is_file()
