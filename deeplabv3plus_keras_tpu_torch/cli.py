"""Command line (port of ``deeplabv3plus_keras_tpu/cli.py:32-63``, the
reference's ``main()``, semantic_segmentation.py:1793-1845): reads the
JSON config (a path argument, or the reference's file name in the working
directory), seeds Python's and NumPy's generators with 1024, runs the
``mode`` (train, evaluate, test or convert_to_tf_lite, which writes a
``torch.export`` program into the working directory) on CUDA and prints
its time.

With ``multi_gpu`` and ``num_gpus`` N > 1 the mode runs over N ranks of a
``torch.distributed`` group (the JAX CLI uses N devices of one process):
started by torchrun, each process joins the group its environment
describes; started alone, the CLI starts N ranks itself
(``parallel/launch.py``), one card each over NCCL, or with ``--device cpu``
N CPU processes over gloo.  Fewer cards than N raise, unless the config's
``allow_fewer_devices`` shrinks N to the cards there are.  A rank that
fails stops the others and the CLI exits non-zero.

Usage:
    python -m deeplabv3plus_keras_tpu_torch.cli [conf.json] [--device cpu]
    torchrun --nproc_per_node N -m deeplabv3plus_keras_tpu_torch.cli conf.json
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time

import numpy as np
import torch

from .api import SemanticSegmentation, resolve_device
from .config import MODE_CONVERT_TO_TF_LITE, MODE_EVALUATE, MODE_TEST, MODE_TRAIN, Config
from .parallel import launch, mesh

DEFAULT_CONF = "semantic_segmentation_deeplabv3plus_conf.json"


def _run(conf: dict, device) -> None:
    """Run the config's mode in this process (one rank of a group, or
    alone)."""
    seed = 1024  # reference :1797-1802
    random.seed(seed)
    np.random.seed(seed)
    mode = conf.get("mode", MODE_TRAIN)
    ss = SemanticSegmentation(conf, device=device)
    start = time.time()
    if mode == MODE_TRAIN:
        ss.train()
    elif mode == MODE_EVALUATE:
        ss.evaluate(mode=conf.get("eval_data_mode", 1),
                    result_saving=conf.get("eval_result_saving", False))
    elif mode == MODE_TEST:
        ss.test()
    else:
        ss.convert_to_tf_lite()
    if mesh.rank() == 0:
        print(f"Elapsed time: {time.time() - start:.1f}s ({mode})")


def _rank_devices(conf: dict, device: str | None) -> list[str]:
    """One device a rank: N CPU processes for ``--device cpu``, else the
    first N cards (fewer with ``allow_fewer_devices``)."""
    n = int(conf.get("num_gpus", 1)) if conf.get("multi_gpu", False) else 1
    if device is not None and torch.device(device).type == "cpu":
        return ["cpu"] * n
    if device is not None:
        raise ValueError(f"--device {device}: {n} ranks take one card each; pass no "
                         "--device, or --device cpu")
    cards = torch.cuda.device_count()
    if cards < n:
        if not Config.from_dict(conf).extra.get("allow_fewer_devices", False):
            raise RuntimeError(
                f"config requests num_gpus={n} but only {cards} CUDA device(s) are attached; "
                "set the extra config key 'allow_fewer_devices': true to train on fewer")
        print(f"warning: num_gpus {n} > available devices {cards}; starting {cards} ranks "
              "(allow_fewer_devices)")
        n = cards
    return [f"cuda:{r}" for r in range(n)]


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m deeplabv3plus_keras_tpu_torch.cli")
    parser.add_argument("conf", nargs="?", default=DEFAULT_CONF)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the first CUDA card, or one card a rank; "
                             "'cpu' on request)")
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    device = resolve_device(args.device)  # a card, or the CPU on request
    with open(args.conf) as f:
        conf = json.load(f)
    mode = conf.get("mode", MODE_TRAIN)
    if mode not in (MODE_TRAIN, MODE_EVALUATE, MODE_TEST, MODE_CONVERT_TO_TF_LITE):
        raise ValueError(f"unknown mode {mode!r}")
    multi = conf.get("multi_gpu", False) and int(conf.get("num_gpus", 1)) > 1
    if not multi or mesh.launched_by_torchrun():
        # alone, or one rank of a group torchrun started
        _run(conf, args.device if multi else device)
        return 0
    devices = _rank_devices(conf, args.device)
    if len(devices) == 1:
        _run(conf, devices[0])
        return 0
    try:
        launch.spawn(_run, len(devices), (conf, args.device), devices=devices)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
