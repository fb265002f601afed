"""Command line (port of ``deeplabv3plus_keras_tpu/cli.py:32-63``, the
reference's ``main()``, semantic_segmentation.py:1793-1845): reads the
JSON config (a path argument, or the reference's file name in the working
directory), seeds Python's and NumPy's generators with 1024, runs the
``mode`` (train, evaluate, test or convert_to_tf_lite, which writes a
``torch.export`` program into the working directory) on CUDA and prints
its time.

Usage:
    python -m deeplabv3plus_keras_tpu_torch.cli [conf.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time

import numpy as np

from .api import SemanticSegmentation, resolve_device
from .config import MODE_CONVERT_TO_TF_LITE, MODE_EVALUATE, MODE_TEST, MODE_TRAIN

DEFAULT_CONF = "semantic_segmentation_deeplabv3plus_conf.json"


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m deeplabv3plus_keras_tpu_torch.cli")
    parser.add_argument("conf", nargs="?", default=DEFAULT_CONF)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the first CUDA card; 'cpu' on request)")
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    device = resolve_device(args.device)  # a card, or the CPU on request

    seed = 1024  # reference :1797-1802
    random.seed(seed)
    np.random.seed(seed)
    with open(args.conf) as f:
        conf = json.load(f)
    mode = conf.get("mode", MODE_TRAIN)
    if mode not in (MODE_TRAIN, MODE_EVALUATE, MODE_TEST, MODE_CONVERT_TO_TF_LITE):
        raise ValueError(f"unknown mode {mode!r}")
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
    print(f"Elapsed time: {time.time() - start:.1f}s ({mode})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
