"""The JSON-config entry points over two CPU ranks (gloo), from a synthetic
VOC tree: the CLI starting its own ranks for ``train``, ``evaluate`` and
``test``, and the facade inside a spawned pair (``evaluate()`` summed over
ranks, result panels and ``test()``'s PNGs written by the rank that owns
each sample, checkpoint and restore, ``allow_fewer_devices``).

Tolerances.  Against one process from the same weights, float32:

- the first epoch's ``train()`` history: losses to 1e-3 relative, mIoUs
  to 5e-3.  The two ranks' BN statistics and loss are the global batch's,
  but their sums round in another order, and Keras Adam at β₁ = 0.5 turns
  a gradient that rounds across zero into a whole ±lr update
  (tests/test_torch_train.py explains the drift); measured on this tree:
  7e-5 on the loss, 4.5e-4 on the mIoU, 1e-6 on the validation loss.
- ``evaluate()`` of one checkpoint: the mIoU to 1e-4, the confusion
  matrix's total exactly (every validation pixel counted once).
- ``test()``: each PNG equal to one process's labels of the same
  checkpoint.
- ``int8_infer``'s ``evaluate()``: the calibrated ranges (each rank's
  abs-max over its rows, the maximum over the ranks) to 1e-6 relative (a
  row's activations round alike in a batch of 2 or 4), the mIoU to 1e-4,
  the confusion matrix's total exactly.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_ddp_workers as workers
from deeplabv3plus_keras_tpu_torch import SemanticSegmentation
from deeplabv3plus_keras_tpu_torch.data import make_synthetic_voc
from deeplabv3plus_keras_tpu_torch.parallel import launch
from torch_helpers import conf_dict

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
N_TRAIN, N_VAL, N_TEST, SIZE = 8, 4, 3, 32


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_synthetic_voc(str(tmp_path_factory.mktemp("voc")), n_train=N_TRAIN,
                              n_val=N_VAL, n_test=N_TEST, min_size=40, max_size=90)


def _conf(root, **extra):
    conf = conf_dict(SIZE, resource_type="pascal_voc_2012", resource_path=root, workers=1,
                     max_queue_size=4, **extra)
    conf["hps"].update(epochs=1, batch_size=4)
    conf["nn_arch"]["dropout_rate"] = 0.0
    return conf


def _cli(work_dir, conf):
    with open(os.path.join(work_dir, "conf.json"), "w") as f:
        json.dump(conf, f)
    # its own session, so that a timeout stops the ranks it started too
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeplabv3plus_keras_tpu_torch.cli", "conf.json", "--device", "cpu"],
        cwd=work_dir, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"},
        start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=180)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.communicate()
        raise
    return proc.returncode, out


def _history_close(got, ref):
    for k in ("loss", "val_loss"):
        assert abs(got[k] - ref[k]) <= 1e-3 * abs(ref[k]), (k, got[k], ref[k])
    for k in ("miou", "val_miou"):
        assert abs(got[k] - ref[k]) <= 5e-3, (k, got[k], ref[k])


def test_cli_trains_evaluates_and_tests_on_two_cpu_ranks(tree, tmp_path):
    """``python -m deeplabv3plus_keras_tpu_torch.cli conf.json --device cpu``
    with ``multi_gpu: true, num_gpus: 2`` starts two ranks for each mode:
    train's logged history agrees with one process's; evaluate prints the
    metric once; test writes each test image's PNG."""
    two, one = tmp_path / "two", tmp_path / "one"
    two.mkdir()
    one.mkdir()
    conf = _conf(tree, multi_gpu=True, num_gpus=2, metrics_log=str(two / "metrics.jsonl"))
    rc, out = _cli(str(two), {**conf, "mode": "train"})
    assert rc == 0, out
    assert out.count("epoch 1/1") == 1  # rank 0 alone prints
    logged = [json.loads(line) for line in (two / "metrics.jsonl").read_text().splitlines()]
    assert len(logged) == 1
    ref = SemanticSegmentation(_conf(tree), work_dir=str(one), device="cpu").train()
    _history_close(logged[0], {k: v[0] for k, v in ref.items()})

    rc, out = _cli(str(two), {**conf, "mode": "evaluate", "model_loading": True})
    assert rc == 0, out
    assert out.count("mean iou:") == 1
    rc, out = _cli(str(two), {**conf, "mode": "test", "model_loading": True})
    assert rc == 0, out
    assert sorted(os.listdir(two / "test_results")) == [f"te_{i:04d}.png" for i in range(N_TEST)]


def test_cli_under_torchrun_joins_its_group(tree, tmp_path):
    """Started by torchrun (``--standalone``: a free port), each process
    joins the group of its environment; test() writes each PNG."""
    conf = {**_conf(tree, multi_gpu=True, num_gpus=2), "mode": "test"}
    with open(tmp_path / "conf.json", "w") as f:
        json.dump(conf, f)
    done = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "deeplabv3plus_keras_tpu_torch.cli", "conf.json", "--device", "cpu"],
        cwd=tmp_path, capture_output=True, text=True, timeout=180,
        env={**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"})
    assert done.returncode == 0, done.stdout + done.stderr
    assert sorted(os.listdir(tmp_path / "test_results")) == [f"te_{i:04d}.png"
                                                             for i in range(N_TEST)]


def test_cli_counts_cards_before_it_starts_ranks(monkeypatch):
    """num_gpus above the cards there are: refused, or fewer ranks under
    allow_fewer_devices, as the JAX CLI shrinks its mesh; --device cpu
    starts N CPU processes whatever the cards."""
    from deeplabv3plus_keras_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    conf = {"multi_gpu": True, "num_gpus": 4}
    with pytest.raises(RuntimeError, match="allow_fewer_devices"):
        cli._rank_devices(conf, None)
    assert cli._rank_devices({**conf, "allow_fewer_devices": True}, None) == ["cuda:0", "cuda:1"]
    assert cli._rank_devices(conf, "cpu") == ["cpu"] * 4
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert cli._rank_devices(conf, None) == [f"cuda:{r}" for r in range(4)]


def test_cli_fails_when_a_rank_fails(tree, tmp_path):
    """Ranks that raise (grad_accum 3 does not divide the global batch of
    4) make the CLI exit non-zero."""
    conf = _conf(tree, multi_gpu=True, num_gpus=2, grad_accum=3)
    rc, out = _cli(str(tmp_path), {**conf, "mode": "train"})
    assert rc != 0
    assert "exited with code" in out


def test_a_failed_rank_stops_the_others():
    """Rank 1 raises while rank 0 waits in an all-reduce: ``spawn`` raises
    at once, long before the group's timeout (which rank it names first
    depends on whether gloo has already failed rank 0's all-reduce)."""
    import time

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank[01] exited with code 1"):
        launch.spawn(workers.failing_worker, 2, devices=["cpu", "cpu"], timeout_s=120,
                     group_timeout_s=300)
    assert time.monotonic() - t0 < 60


def test_a_sigterm_on_one_rank_stops_every_rank_at_one_step(tree, tmp_path):
    """preemption_save over two ranks: rank 1 alone is signalled during its
    second step; both ranks stop after the same step (the flag agreed by
    an all-reduce), rank 0 writes the resume slot, train() returns."""
    conf = _conf(tree, multi_gpu=True, num_gpus=2)
    launch.spawn(workers.preempt_worker, 2, (conf, str(tmp_path), str(tmp_path)),
                 devices=["cpu", "cpu"], timeout_s=120, group_timeout_s=60)
    r0, r1 = (json.loads((tmp_path / f"preempt_r{r}.json").read_text()) for r in (0, 1))
    assert r0 == r1
    assert r0["epochs"] == 0 and 2 <= r0["steps"] == r0["iterations"] <= 3
    assert (tmp_path / "semantic_segmentation_deeplabv3plus" / "state.resume").is_dir()


@pytest.fixture(scope="module")
def facade(tree, tmp_path_factory):
    """The facade worker's two ranks' reports and the work directory."""
    wd = tmp_path_factory.mktemp("facade")
    conf = _conf(tree, multi_gpu=True, num_gpus=2)
    launch.spawn(workers.facade_worker, 2, (conf, str(wd), str(wd)), devices=["cpu", "cpu"],
                 timeout_s=240, group_timeout_s=120)
    return [json.loads((wd / f"facade_r{r}.json").read_text()) for r in (0, 1)], wd, conf


def test_facade_trains_and_restores_on_two_ranks(facade):
    """Both ranks compute the same history; the checkpoint rank 0 wrote
    restores on both ranks to the weights they trained."""
    (r0, r1), wd, _ = facade
    assert r0["history"] == r1["history"]
    assert all(np.isfinite(v[0]) for v in r0["history"].values())
    assert r0["restored_equals_last"] and r1["restored_equals_last"]
    assert (wd / "semantic_segmentation_deeplabv3plus" / "state" / "state.pt").is_file()


def test_evaluate_sums_over_ranks_and_writes_each_panel_once(facade, tree):
    """evaluate() on two ranks: the same metric on both, every validation
    pixel counted once, the mIoU of one process evaluating the same
    checkpoint, and one result panel a validation image."""
    (r0, r1), wd, conf = facade
    assert r0["val_miou"] == r1["val_miou"] and r0["cm"] == r1["cm"]
    assert int(np.sum(r0["cm"])) == N_VAL * SIZE * SIZE
    one = SemanticSegmentation({**_conf(tree), "model_loading": True}, work_dir=str(wd),
                               device="cpu")
    ref = one.evaluate()
    assert abs(r0["val_miou"] - ref.result()) <= 1e-4
    assert sorted(os.listdir(wd / "results")) == sorted(f"result_{i}.png" for i in range(N_VAL))


def test_test_writes_each_png_once_with_one_process_labels(facade, tree):
    (_r, wd, _conf_) = facade
    from PIL import Image

    from deeplabv3plus_keras_tpu_torch.data import MODE_TEST

    one = SemanticSegmentation({**_conf(tree), "model_loading": True}, work_dir=str(wd),
                               device="cpu")
    names = sorted(os.listdir(wd / "test_results"))
    assert names == [f"te_{i:04d}.png" for i in range(N_TEST)]
    for b in one._batches(one._loader(MODE_TEST, with_labels=False), with_labels=False):
        labels = one.segment(b["image"].numpy())
        for i, name in enumerate(b["names"]):
            got = np.asarray(Image.open(wd / "test_results" / f"{name}.png"))
            np.testing.assert_array_equal(got, labels[i].astype(np.uint8))


def test_allow_fewer_devices_on_two_ranks(facade):
    """num_gpus 4 on a group of 2: refused with JAX's advice, or shrunk to
    the group under allow_fewer_devices."""
    (r0, r1), _, _ = facade
    for r in (r0, r1):
        assert "num_gpus=4" in r["refused"] and "allow_fewer_devices" in r["refused"]
        assert r["shrunk_world"] == 2


def test_int8_evaluate_on_two_ranks_equals_one_process(facade, tree):
    """int8 evaluate() of one checkpoint on two ranks quantizes as one
    process does: the calibration's abs-maxima are reduced with MAX over
    the ranks (JAX's N devices calibrate on the global batch)."""
    _, wd, conf = facade
    launch.spawn(workers.int8_worker, 2, (conf, str(wd), str(wd)), devices=["cpu", "cpu"],
                 timeout_s=240, group_timeout_s=120)
    r0, r1 = (json.loads((wd / f"int8_r{r}.json").read_text()) for r in (0, 1))
    assert r0 == r1
    one = SemanticSegmentation({**_conf(tree), "model_loading": True, "int8_infer": True,
                                "int8_calib_batches": 4}, work_dir=str(wd), device="cpu")
    ref = one.evaluate()
    ranges = {k: v.item() for k, v in one._quant.items()}
    assert sorted(r0["ranges"]) == sorted(ranges) and ranges
    for k, v in ranges.items():
        assert abs(r0["ranges"][k] - v) <= 1e-6 * v, k
    assert abs(r0["val_miou"] - ref.result()) <= 1e-4
    assert int(np.sum(r0["cm"])) == N_VAL * SIZE * SIZE
