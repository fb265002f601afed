"""Readings that set a cell's correctness limits (not part of a run).  Each
reading is a run of the cell through ``run.execute``, with a short window,
and with something put in the program's place by the loop's ``patch``
before the warm-up, so that it goes through the harness's own check:

- ``program``: nothing; the numbers a sound run compares;
- ``control``: the plain reference in the program's place, in the nearest
  precision below the configuration's (TF32 convolutions and matmuls for
  float32 with TF32 off): :class:`TrainStandIn`, fed by the program's data
  path, or :class:`ServeStandIn`;
- faults planted in the program: for a training cell ``half_batch`` (each
  step sees the first half of its rows, the mean taken over them),
  ``unchanged_state`` (each step restores the parameters) and
  ``unchanged_stats`` (each step restores BN's running statistics); for a
  serving cell ``altered_label`` (each call's first image's labels moved
  to the next class).

    python3 -m benchmark.control --workload <cell> --seeds <n,n,...> --readings <r,r,...> [--seconds <s>]

prints one JSON line per seed and reading: ``correct``, the compared
numbers and the check's detail.  On the card only.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import torch

from . import cells, run
from .reference import model as ref
from .reference import train as ref_train


@contextlib.contextmanager
def tf32(on: bool):
    old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


class _Model:
    """The stand-in's state as the train loop reads a model's."""

    def __init__(self, params: dict, names: list):
        self.params, self.names = params, names

    def named_parameters(self):
        return ((n, self.params[n]) for n in self.names)

    def state_dict(self) -> dict:
        return self.params


class _Optimizer:
    """The stand-in's Adam state as the train loop reads the program's."""

    def __init__(self, trainer: ref_train.Trainer):
        self.trainer = trainer

    def state_dict(self) -> dict:
        return {"m": [self.trainer.opt.m[n] for n in self.trainer.names]}


class TrainStandIn:
    """The reference's training step in TF32 in the program's place, from
    the same weights; the program's data path (``_loader``, ``_batches``)
    still feeds it."""

    def __init__(self, loop):
        self.seg = loop.seg
        params = {k: v.clone() for k, v in loop.weights.items()}
        self.trainer = ref_train.Trainer(loop.arch, loop.conf["hps"], params,
                                         loop.cell.config["dropout_seed"])
        self.classes = loop.arch.num_classes
        self.model = _Model(params, self.trainer.names)
        self.optimizer = _Optimizer(self.trainer)

    def _loader(self, *args, **kwargs):
        return self.seg._loader(*args, **kwargs)

    def _batches(self, loader):
        return self.seg._batches(loader)

    def train_step(self, batch: dict) -> dict:
        label, valid = batch["label"], batch["valid"]
        with tf32(True):
            loss, probs = self.trainer.step(batch["image"], label.float(), valid)
        keep = valid.bool()
        truth, pred = label.argmax(-1)[keep].flatten(), probs.argmax(-1)[keep].flatten()
        cm = torch.bincount(truth * self.classes + pred, minlength=self.classes ** 2)
        return {"loss": loss, "cm": cm.reshape(self.classes, self.classes).int()}


class ServeStandIn:
    """The reference's labels in TF32 in the program's place, from the same
    weights."""

    def __init__(self, loop):
        self.model = loop.seg.model
        self.arch, self.weights, self.device = loop.arch, loop.weights, loop.device

    @torch.no_grad()
    def segment(self, images):
        with tf32(True):
            x = torch.as_tensor(images, device=self.device)
            logits, up = ref.logits(ref.Run(self.weights, train=False), self.arch, x)
            return ref.upsample(logits, up).argmax(1).int().cpu().numpy()


def control(loop) -> None:
    loop.seg = (TrainStandIn if loop.kind == "train" else ServeStandIn)(loop)


def _restoring(loop, tensors) -> None:
    """Each train step runs, then puts ``tensors(model)`` back as they were."""
    seg, step = loop.seg, loop.seg.train_step

    def frozen(batch):
        before = [t.detach().clone() for t in tensors(seg.model)]
        out = step(batch)
        with torch.no_grad():
            for t, b in zip(tensors(seg.model), before):
                t.copy_(b)
        return out

    seg.train_step = frozen


def unchanged_state(loop) -> None:
    _restoring(loop, lambda model: list(model.parameters()))


def unchanged_stats(loop) -> None:
    _restoring(loop, lambda model: [b for n, b in model.named_buffers()
                                    if n.endswith((".running_mean", ".running_var"))])


def half_batch(loop) -> None:
    """Each train step sees only the first half of its rows."""
    seg, step = loop.seg, loop.seg.train_step

    def half(batch):
        n = batch["image"].shape[0] // 2
        return step(dict(batch, image=batch["image"][:n], label=batch["label"][:n],
                         valid=batch["valid"][:n]))

    seg.train_step = half


def altered_label(loop) -> None:
    """Each call's first image's labels move to the next class."""
    seg, segment = loop.seg, loop.seg.segment
    classes = loop.arch.num_classes

    def altered(images):
        labels = segment(images)
        labels[0] = (labels[0] + 1) % classes
        return labels

    seg.segment = altered


READINGS = {"program": None, "control": control, "half_batch": half_batch,
            "unchanged_state": unchanged_state, "unchanged_stats": unchanged_stats,
            "altered_label": altered_label}


def reading(cell, seed: int, name: str, seconds: float, device: str = "cuda") -> dict:
    result = run.execute(cell, seed, seconds, False, device, patch=READINGS[name])
    detail = {k: v for k, v in result["detail"].items() if k != "history"}
    return {"workload": cell.name, "seed": seed, "reading": name,
            "correct": result["correct"],
            "numbers": {k: c["value"] for k, c in result["checks"].items()}, "detail": detail}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--readings", required=True, help=",".join(READINGS))
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control readings need a CUDA card", file=sys.stderr)
        return 2
    run.configure(cells.REPO)
    cell = cells.load(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        for name in args.readings.split(","):
            print(json.dumps(reading(cell, seed, name, args.seconds)), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
