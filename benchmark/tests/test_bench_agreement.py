"""The plain reference and the program agree at a tiny size on the CPU, in
float64 so that only the arithmetic's order separates them: one training
step (loss, every parameter's gradient; the dropout mask drawn on both
sides from the configuration's stream) and one ``segment()`` call (the
served labels against the reference's logits).  Only this test imports
both."""

from __future__ import annotations

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.reference import model as ref
from benchmark.reference import train as ref_train

REPO = Path(__file__).resolve().parents[2]
CONFIGS = ("mobilenetv2-os16-br", "xception-os16")


def _setup(name):
    from deeplabv3plus_keras_tpu_torch import SemanticSegmentation

    torch.set_num_threads(4)
    conf = copy.deepcopy(json.loads((REPO / f"benchmark/configs/{name}.json").read_text())["config"])
    conf["nn_arch"]["image_size"] = 64
    conf["hps"]["batch_size"] = 2
    conf["hps"]["dtype"] = "float64"
    arch = ref.arch_of(conf)
    weights = ref.random_weights(arch, 2**31 + 1, "cpu")
    gen = torch.Generator().manual_seed(5)
    images = torch.rand(2, 64, 64, 3, generator=gen) * 2 - 1
    ref.calibrate_bn(arch, weights, images)
    weights = {k: v.double() for k, v in weights.items()}
    seg = SemanticSegmentation(conf, device="cpu")
    seg.model.double()
    seg.model.load_state_dict(weights)
    return conf, arch, weights, seg, images.double(), gen


@pytest.mark.parametrize("name", CONFIGS)
def test_one_training_step(name):
    conf, arch, weights, seg, images, gen = _setup(name)
    from deeplabv3plus_keras_tpu_torch.parallel.step import build_train_step, create_train_state

    seed = json.loads((REPO / f"benchmark/configs/{name}.json").read_text())["dropout_seed"]
    assert arch.dropout_rate > 0  # the mask is drawn on both sides
    seg.optimizer = create_train_state(seg.conf, seg.model)  # float64 moments
    step = build_train_step(seg.model, seg.optimizer, seg.conf, seed=seed)
    labels = torch.randint(0, arch.num_classes, (2, 64, 64), generator=gen)
    onehot = torch.nn.functional.one_hot(labels, arch.num_classes).double()
    valid = torch.tensor([1, 1], dtype=torch.int32)
    out = step({"image": images, "label": onehot, "valid": valid})
    names = [n for n in weights if ref.is_trainable(n)]
    leaves = {n: weights[n].clone().requires_grad_(True) for n in names}
    value, _ = ref_train.loss(arch, dict(weights, **leaves), None, images, onehot, valid.double(),
                              conf["hps"]["weight_decay"], ref_train.dropout_generator(seed, 0, "cpu"))
    grads = dict(zip(names, torch.autograd.grad(value, [leaves[n] for n in names])))
    assert float(out["loss"]) == pytest.approx(float(value.detach()), rel=1e-12)
    norms = {n: float(g.norm()) for n, g in grads.items()}
    median = float(np.median(list(norms.values())))
    params = dict(seg.model.named_parameters())
    for n in names:
        gap = float((params[n].grad - grads[n]).norm()) / max(norms[n], median)
        assert gap < 1e-9, n


@pytest.mark.parametrize("name", CONFIGS)
def test_one_segment_call(name):
    conf, arch, weights, seg, images, _ = _setup(name)
    labels = seg.segment(images.numpy())
    with torch.no_grad():
        logits, up = ref.logits(ref.Run(weights, train=False), arch, images)
        logits = ref.upsample(logits, up)
    served = torch.as_tensor(labels).long()
    best = logits.max(1).values
    at = logits.gather(1, served[:, None])[:, 0]
    assert float((best - at).max()) < 1e-9 * float(logits.abs().max())
