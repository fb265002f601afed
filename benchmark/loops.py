"""What every traffic kind shares.  A kind is a file ``kinds/<kind>.py``
that a mix file names under ``"kind"``; its ``Loop`` class (a subclass of
:class:`Loop`) drives the program through its public path in a closed loop
with one client.  A loop has ``setup`` (inputs, weights, the program,
warm-up: everything before the window), ``window`` (the measured loop) and
``check`` (after the program's state is freed: the plain reference on the
same inputs, and the numbers compared).  The program gets the weights the
harness made from the seed; the reference gets the same weights and the
same raw inputs and works out everything else again.
"""

from __future__ import annotations

import contextlib
import gc
import shutil
import statistics
import tempfile
import time

import torch

from .reference import model as ref


class Spans:
    """The harness's host spans: per name, the seconds of every entry
    (for the host metrics), and, in a traced run, a profiler range named
    ``bench.<name>``."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.seconds: dict[str, list[float]] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = torch.profiler.record_function(f"bench.{name}") if self.traced else None
        if rf is not None:
            rf.__enter__()
        t = time.perf_counter()
        try:
            yield
        finally:
            self.seconds.setdefault(name, []).append(time.perf_counter() - t)
            if rf is not None:
                rf.__exit__(None, None, None)


def site_hooks(model, weights: dict) -> list:
    """A ``bench.dw_site`` profiler range around every depthwise module's
    forward: the modules whose weight is a (C, 1, k, k) kernel with k > 1,
    found by the weights' names.  Returns the hook handles."""
    handles = []
    for name, w in weights.items():
        if w.dim() == 4 and w.shape[1] == 1 and w.shape[-1] > 1:
            mod = model.get_submodule(name.rsplit(".", 1)[0])
            stack = []

            def pre(_m, _a, stack=stack):
                rf = torch.profiler.record_function("bench.dw_site")
                rf.__enter__()
                stack.append(rf)

            def post(_m, _a, _o, stack=stack):
                stack.pop().__exit__(None, None, None)

            handles += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]
    return handles


def port():
    """The program's facade and data modules, imported when a run needs
    them (a directory that holds only the benchmark has no program)."""
    from deeplabv3plus_keras_tpu_torch import SemanticSegmentation
    from deeplabv3plus_keras_tpu_torch.data import voc
    from deeplabv3plus_keras_tpu_torch.train import MeanIoU

    return SemanticSegmentation, voc, MeanIoU


def _calibration_images(seed: int, batch: int, size: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    return torch.rand((batch, size, size, 3), generator=gen, device=device) * 2.0 - 1.0


def leaf_norms(tensors) -> torch.Tensor:
    return torch.stack([t.detach().double().norm() for t in tensors])


def relative_gaps(prog: dict, refv: dict, names) -> tuple[float, str]:
    """The worst leaf of |‖program‖ − ‖reference‖| over the larger of the
    reference's norm and the median leaf's; (gap, leaf)."""
    med = statistics.median(refv[n] for n in names)
    worst, leaf = 0.0, ""
    for n in names:
        gap = abs(prog[n] - refv[n]) / max(refv[n], med)
        if gap > worst or not leaf:
            worst, leaf = gap, n
    return worst, leaf


class Loop:
    """``patch``, when given, is called with the loop once the program is
    built, before the warm-up: it may wrap or replace ``loop.seg`` (a
    planted fault, or the reference put in the program's place)."""

    kind = ""

    def __init__(self, cell, seed: int, device, spans: Spans, patch=None):
        self.cell, self.seed, self.device, self.spans = cell, int(seed), torch.device(device), spans
        self.patch = patch
        self.conf = dict(cell.config["config"], **cell.mix.get("conf_extra", {}))
        self.arch = ref.arch_of(self.conf, cell.bench_dir / "reference" / "backbones")
        self.batch = int(self.conf["hps"]["batch_size"])
        self.size = int(self.conf["nn_arch"]["image_size"])
        self.tmp = tempfile.mkdtemp(prefix="dlv3-bench-")
        self.hooks = []
        self.phases: dict[str, float] = {}  # set-up seconds by phase
        self._mark = time.perf_counter()

    def phase(self, name: str) -> None:
        """Close the set-up phase ``name`` (seconds since the last mark)."""
        now = time.perf_counter()
        self.phases[name] = now - self._mark
        self._mark = now

    def make_weights(self) -> dict:
        """The weights from the seed, BN statistics from one training-mode
        pass of the reference over images made from the seed."""
        w = ref.random_weights(self.arch, self.seed, self.device)
        ref.calibrate_bn(self.arch, w, _calibration_images(self.seed, self.batch, self.size,
                                                           self.device), self.seed)
        return w

    def build(self, weights: dict) -> None:
        """The program as ``self.seg``, holding ``weights``; then ``patch``."""
        SemanticSegmentation = port()[0]
        self.seg = SemanticSegmentation(self.conf, work_dir=self.tmp, device=self.device)
        self.seg.model.load_state_dict(weights, strict=True)
        if self.patch is not None:
            self.patch(self)

    def close(self) -> None:
        for h in self.hooks:
            h.remove()
        self.hooks = []
        shutil.rmtree(self.tmp, ignore_errors=True)

    def free(self) -> None:
        """Drop the program's state before the reference runs."""
        for h in self.hooks:
            h.remove()
        self.hooks = []
        self.seg = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
