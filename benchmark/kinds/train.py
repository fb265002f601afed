"""The ``train`` kind: the per-step loop of ``train()`` under
``cache_device``.  A seeded VOC-layout tree is written, the program caches
it on the card (``DeviceDataset``), and the window runs ``device_batches``
→ ``train_step`` with one-hot labels and a shuffle per epoch, keeping each
step's loss and confusion matrix on the device and reading them on the host
once an epoch, as ``train()`` does.  One rank.

The check: the plain reference follows the program's first three steps
(the warm-up's, through the window's own call and feed) from the same
weights on the same samples, decoding the same JPEGs itself, with the same
dropout stream (the configuration's ``dropout_seed``).  Compared: the
first step's loss; the worst leaf's first gradient, as Adam's first moment
gives it; the worst leaf's change after three steps; the worst BN running
statistic's change after three steps.
"""

from __future__ import annotations

import gc
import statistics
import time

import numpy as np
import torch

from benchmark import data_voc
from benchmark.loops import Loop as Base
from benchmark.loops import leaf_norms, port, relative_gaps
from benchmark.reference import model as ref
from benchmark.reference import prep as ref_prep
from benchmark.reference import train as ref_train

GIB = 2.0 ** 30


class Loop(Base):
    kind = "train"

    def setup(self) -> None:
        mix = self.cell.mix
        self.conf["resource_path"] = self.tmp
        data_voc.write_tree(self.tmp, self.seed, self.device, n=int(mix["images"]))
        self.phase("tree")
        self.weights = self.make_weights()
        self.phase("weights")
        self.build(self.weights)
        self.phase("program")
        _, voc, self.MeanIoU = port()
        # the training set cached on the card (the program's DeviceDataset)
        self.loader = self.seg._loader(voc.MODE_TRAIN, shuffle=True)
        self.phase("cache")
        self.batches = iter(self.seg._batches(self.loader))
        self.epoch_losses, self.miou = [], self.MeanIoU(self.arch.num_classes)
        self.history = []
        self.failed = 0
        self.checked = []  # per checked step: (names, valid)
        names = [n for n, _ in self.seg.model.named_parameters()]  # the order of Adam's m
        stat_names = [n for n in self.weights if not ref.is_trainable(n)]
        warm_losses = []
        self.warmup_s = []
        for i in range(int(mix["warmup_steps"])):
            t = time.perf_counter()
            batch = self._next()
            self.checked.append((list(batch["names"]), batch["valid"].cpu().numpy()))
            if i == 0:  # the data path's first output, for the check of that stage
                label = batch["label"]
                self.first_batch = (batch["image"].clone(),
                                    (label.argmax(-1) if label.dim() == 4 else label).to(
                                        torch.uint8))
            self._step(batch)
            warm_losses.append(self.epoch_losses[-1])
            if i == 0:  # the first gradient, as Adam's first moment holds it
                m = self.seg.optimizer.state_dict()["m"]
                b1 = float(self.conf["hps"]["beta_1"])
                self.grad_norms = dict(zip(names, (leaf_norms(m) / (1.0 - b1)).tolist()))
            if i == 2:  # the change of every parameter and statistic over three steps
                state = self.seg.model.state_dict()
                self.update_norms, self.stat_norms = (
                    dict(zip(keys, leaf_norms([state[n] - self.weights[n] for n in keys]).tolist()))
                    for keys in (names, stat_names))
            self.warmup_s.append(time.perf_counter() - t)
        self.checked = self.checked[:3]
        self.first_losses = [float(x) for x in warm_losses[:3]]  # waits for them
        self.phase("warmup")

    def _next(self) -> dict:
        batch = next(self.batches, None)
        if batch is None:  # the epoch's end: read it as train() does
            self._read_epoch()
            self.batches = iter(self.seg._batches(self.loader))
            batch = next(self.batches)
        return batch

    def _step(self, batch) -> int:
        batch.pop("names", None)
        out = self.seg.train_step(batch)
        self.epoch_losses.append(out["loss"])
        self.miou.update_from_cm(out["cm"])
        return int((batch["index"] >= 0).sum())

    def _read_epoch(self) -> None:
        if not self.epoch_losses:
            return
        with self.spans("read"):
            losses = torch.stack(self.epoch_losses).double().cpu().numpy()
            self.failed += int((~np.isfinite(losses)).sum())
            self.history.append((float(losses.mean()), self.miou.result()))
        self.epoch_losses, self.miou = [], self.MeanIoU(self.arch.num_classes)

    def window(self, seconds: float) -> dict:
        steps = images = self.failed = 0
        sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda: None)
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        with self.spans("window"):
            start = time.perf_counter()
            deadline = start + seconds
            while True:
                with self.spans("data"):
                    batch = self._next()
                with self.spans("step"):
                    images += self._step(batch)
                steps += 1
                if time.perf_counter() >= deadline:
                    break
            sync()
            end = time.perf_counter()
        self._read_epoch()
        peak = torch.cuda.max_memory_allocated() if self.device.type == "cuda" else 0
        window_s = end - start
        return {"units": steps, "attempted": steps, "failed": self.failed,
                "window_s": window_s, "memory_peak_bytes": peak,
                "metrics": {"train_images_per_s": images / window_s,
                            "train_peak_gib": peak / GIB}}

    def check(self) -> dict:
        """Three reference steps from the same weights on the same samples,
        against the program's first three steps."""
        self.free()
        self.loader = self.batches = None
        gc.collect()
        params = {n: t.clone() for n, t in self.weights.items()}
        prog_losses = self.first_losses

        data = {}

        def maker(names, valid):
            def make():
                images = torch.zeros((self.batch, self.size, self.size, 3), device=self.device)
                onehot = torch.zeros((self.batch, self.size, self.size, self.arch.num_classes),
                                     device=self.device)
                for j, name in enumerate(names):
                    img, lab = ref_prep.decode(*data_voc.sample_paths(self.tmp, name))
                    images[j], onehot[j] = ref_prep.prepare(img, lab, self.size,
                                                            self.arch.num_classes, self.device)
                if not data:  # the first step's batch against the program's
                    image_p, label_p = self.first_batch
                    data["image_max_abs"] = float((image_p - images).abs().max())
                    data["labels_differing"] = int((label_p != onehot.argmax(-1)).sum())
                return images, onehot, torch.as_tensor(valid, device=self.device)
            return make

        losses, first = ref_train.train_steps(
            self.arch, self.conf["hps"], params, [maker(n, v) for n, v in self.checked],
            self.cell.config["dropout_seed"])

        def changes(keys):
            return dict(zip(keys, leaf_norms([params[n] - self.weights[n] for n in keys]).tolist()))

        names = list(self.grad_norms)
        ref_grad = dict(zip(names, leaf_norms([first[n] for n in names]).tolist()))
        ref_update, ref_stats = changes(names), changes(list(self.stat_norms))
        med = statistics.median(ref_grad.values())
        moved = [n for n in names if ref_grad[n] >= 1e-3 * med]
        loss_gaps = [abs(p - r) / abs(r) for p, r in zip(prog_losses, losses)]
        grad_gap, grad_leaf = relative_gaps(self.grad_norms, ref_grad, names)
        update_gap, update_leaf = relative_gaps(self.update_norms, ref_update, moved)
        stats_gap, stats_leaf = relative_gaps(self.stat_norms, ref_stats, list(ref_stats))
        return {"numbers": {"loss1_gap": loss_gaps[0], "grad_gap": grad_gap,
                            "update_gap": update_gap, "stats_gap": stats_gap},
                "detail": {"losses": prog_losses, "reference_losses": losses,
                           "loss_gaps": loss_gaps, "first_batch": data,
                           "grad_leaf": grad_leaf, "update_leaf": update_leaf,
                           "stats_leaf": stats_leaf, "leaves": len(names),
                           "leaves_moved": len(moved), "statistics": len(ref_stats),
                           "history": self.history}}
