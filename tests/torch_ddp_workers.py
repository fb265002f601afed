"""The rank side of the PyTorch port's multi-process tests
(tests/test_torch_ddp*.py, tests/test_torch_on_card.py).

Each function here runs in every rank that ``parallel.launch.spawn``
starts, after the process group is up, and writes what it measured into
an output directory the test reads.  This module imports no JAX: a rank
loads torch and the port only.
"""

from __future__ import annotations

import copy
import json
import os

import numpy as np
import torch

from torch_helpers import FLAGSHIP_MIDDLE, conf_dict, port_model

# the JAX package's N-against-1-device configuration (tests/test_sharding.py:
# 25-35): 32², one 1×1 conv middle op, no refinement, dropout 0, B = 8
SIZE, BATCH = 32, 8


def tiny_conf(dtype: str = "float64", refine: bool = False, **extra) -> dict:
    conf = conf_dict(SIZE, refine=refine, **extra)
    conf["nn_arch"].update(reduction_size=16, concat_channels=16, dropout_rate=0.0,
                           encoder_middle_conf=[{"op": "conv", "kernel": 1, "input": -1}])
    conf["hps"].update(dtype=dtype, batch_size=BATCH, lr=1e-4, decay=0.0)
    return conf


# case → (config, steps); every case's third batch... see global_batches
STEP_CASES = {
    "plain": (tiny_conf(), 3),
    "grad_accum": (tiny_conf(grad_accum=2), 3),
    "remat": (tiny_conf(remat=True), 3),
    "augment": (tiny_conf(augment=True), 3),
    "bfloat16": (tiny_conf("bfloat16"), 1),
    "unreached": ({**tiny_conf("float32"), "base_model": "nasnetmobile"}, 1),
    # the parity-decomposed tail (it needs the ×2 of boundary refinement):
    # the global valid-pixel count and the summed confusion matrix
    "fused_tail": (tiny_conf(refine=True, fused_tail=True), 3),
}


def global_batches(steps: int, dtype=np.float64, seed: int = 11) -> list[dict]:
    """Global batches of B = 8 from ``seed``; the second is ragged (its last
    three samples padding: one rank holds real and padded rows, and under
    grad_accum 2 one of its microbatches is all padding)."""
    rng = np.random.default_rng(seed)
    out = []
    for s in range(steps):
        valid = np.ones(BATCH, np.int32)
        if s == 1:
            valid[5:] = 0
        out.append({"image": rng.uniform(-1, 1, (BATCH, SIZE, SIZE, 3)).astype(dtype),
                    "label": rng.integers(0, 21, (BATCH, SIZE, SIZE)),
                    "valid": valid})
    return out


def case_model(case: str, variables):
    """The case's model on the CPU: the tiny configuration's weights from
    ``variables`` (float64 where the case computes in float64), or, for
    NASNet-Mobile and the refined decoder of ``fused_tail``, from a seed."""
    from deeplabv3plus_keras_tpu_torch.config import Config
    from deeplabv3plus_keras_tpu_torch.models import DeepLabV3Plus

    conf, _ = STEP_CASES[case]
    if case in ("unreached", "fused_tail"):
        model = DeepLabV3Plus(Config.from_dict(conf))
        model.init_weights(torch.Generator().manual_seed(5))
        model = model.to(memory_format=torch.channels_last)
    else:
        model = port_model(conf, variables)
    return model.to(torch.float64) if conf["hps"]["dtype"] == "float64" else model


def run_steps(case: str, variables, rows=None) -> dict:
    """The case's steps through ``build_train_step``: on this rank's
    ``rows`` of each global batch, or on all of them (one process)."""
    from deeplabv3plus_keras_tpu_torch.config import Config
    from deeplabv3plus_keras_tpu_torch.parallel import step

    conf, steps = STEP_CASES[case]
    model = case_model(case, variables)
    pconf = Config.from_dict(conf)
    opt = step.create_train_state(pconf, model)
    train_step = step.build_train_step(model, opt, pconf)
    dtype = np.float64 if conf["hps"]["dtype"] == "float64" else np.float32
    losses, cms = [], []
    for b in global_batches(steps, dtype):
        local = {k: torch.from_numpy(v if rows is None else v[rows]) for k, v in b.items()}
        out = train_step(local)
        losses.append(float(out["loss"]))
        cms.append(out["cm"].numpy())
    return {"losses": losses, "cms": cms,
            "state": {k: v.detach().clone() for k, v in model.state_dict().items()},
            "grads": {n: p.grad.detach().clone() for n, p in model.named_parameters()}}


def step_worker(variables_path: str, out_dir: str) -> None:
    """Every case of STEP_CASES on this rank's rows; one file a case."""
    from deeplabv3plus_keras_tpu_torch.parallel import mesh

    torch.set_num_threads(1)
    variables = torch.load(variables_path, weights_only=False)
    for case, (conf, _) in STEP_CASES.items():
        rows = mesh.row_indices(BATCH, accum=int(conf.get("grad_accum", 1)))
        torch.save(run_steps(case, variables, rows),
                   os.path.join(out_dir, f"{case}_r{mesh.rank()}.pt"))


def facade_worker(conf: dict, work_dir: str, out_dir: str) -> None:
    """The facade over the group: train() (checkpoints by rank 0), then a
    ``model_loading`` facade's evaluate() with result panels and test();
    the histories, metrics and this rank's view of the files."""
    from deeplabv3plus_keras_tpu_torch import SemanticSegmentation
    from deeplabv3plus_keras_tpu_torch.parallel import mesh

    torch.set_num_threads(1)
    seg = SemanticSegmentation(conf, work_dir=work_dir, device="cpu")
    history = seg.train()
    restored = SemanticSegmentation({**conf, "model_loading": True}, work_dir=work_dir,
                                    device="cpu")
    same = all(torch.equal(a, b) for a, b in zip(seg.model.state_dict().values(),
                                                  restored.model.state_dict().values()))
    miou = restored.evaluate(result_saving=True)
    restored.test()
    # more ranks asked for than the group has: refused, or shrunk on request
    refused = ""
    try:
        SemanticSegmentation({**conf, "num_gpus": 4}, work_dir=work_dir, device="cpu")
    except RuntimeError as e:
        refused = str(e)
    shrunk = SemanticSegmentation({**conf, "num_gpus": 4, "allow_fewer_devices": True},
                                  work_dir=work_dir, device="cpu").world
    with open(os.path.join(out_dir, f"facade_r{mesh.rank()}.json"), "w") as f:
        json.dump({"history": history, "val_miou": miou.result(),
                   "cm": miou.total_cm.tolist(), "restored_equals_last": same,
                   "refused": refused, "shrunk_world": shrunk}, f)


def int8_worker(conf: dict, work_dir: str, out_dir: str) -> None:
    """``int8_infer`` over the group: a ``model_loading`` facade's
    evaluate(), calibrated on each rank's rows of the training batches (the
    ranges the maximum over the ranks); the metric, the confusion matrix
    and the ranges."""
    from deeplabv3plus_keras_tpu_torch import SemanticSegmentation
    from deeplabv3plus_keras_tpu_torch.parallel import mesh

    torch.set_num_threads(1)
    seg = SemanticSegmentation({**conf, "model_loading": True, "int8_infer": True},
                               work_dir=work_dir, device="cpu")
    miou = seg.evaluate()
    with open(os.path.join(out_dir, f"int8_r{mesh.rank()}.json"), "w") as f:
        json.dump({"val_miou": miou.result(), "cm": miou.total_cm.tolist(),
                   "ranges": {k: v.item() for k, v in seg._quant.items()}}, f)


def preempt_worker(conf: dict, work_dir: str, out_dir: str) -> None:
    """train() for 3 epochs where rank 1 alone gets a SIGTERM during its
    second step: every rank must stop at the same step, rank 0 save the
    resume slot, and train() return on both."""
    import signal

    from deeplabv3plus_keras_tpu_torch import SemanticSegmentation
    from deeplabv3plus_keras_tpu_torch.parallel import mesh

    torch.set_num_threads(1)
    seg = SemanticSegmentation({**conf, "hps": {**conf["hps"], "epochs": 3}}, work_dir=work_dir,
                               device="cpu")
    step, calls = seg._train_step, []

    def train_step(batch):
        calls.append(1)
        if mesh.rank() == 1 and len(calls) == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return step(batch)

    seg._train_step = train_step
    history = seg.train()
    with open(os.path.join(out_dir, f"preempt_r{mesh.rank()}.json"), "w") as f:
        json.dump({"epochs": len(history["loss"]), "steps": len(calls),
                   "iterations": seg.optimizer.iterations}, f)


def failing_worker() -> None:
    """Rank 1 raises; rank 0 waits for it in an all-reduce."""
    from deeplabv3plus_keras_tpu_torch.parallel import mesh

    if mesh.rank() == 1:
        raise RuntimeError("rank 1 fails on purpose")
    mesh.all_reduce_(torch.zeros(1))


def on_card_worker(out_dir: str) -> None:
    """One flagship-shaped step at 4 × 128² a rank on this rank's card, and
    the K2–K5 launches it made."""
    from deeplabv3plus_keras_tpu_torch import SemanticSegmentation, kernels
    from deeplabv3plus_keras_tpu_torch.parallel import mesh

    torch.backends.cudnn.allow_tf32 = False
    conf = conf_dict(128)
    conf["hps"]["batch_size"] = 8
    # element-wise dropout draws from each rank's own stream
    conf["nn_arch"].update(encoder_middle_conf=copy.deepcopy(FLAGSHIP_MIDDLE), dropout_rate=0.0)
    seg = SemanticSegmentation({**conf, "multi_gpu": True, "num_gpus": mesh.world_size()},
                               device=torch.device("cuda", torch.cuda.current_device()))
    rng = np.random.default_rng(0)
    rows = mesh.row_indices(8)
    batch = {"image": rng.uniform(-1, 1, (8, 128, 128, 3)).astype(np.float32)[rows],
             "label": rng.integers(0, 21, (8, 128, 128))[rows]}
    kernels.reset_launch_counts()
    out = seg.train_step(batch)
    torch.cuda.synchronize()
    with open(os.path.join(out_dir, f"card_r{mesh.rank()}.json"), "w") as f:
        json.dump({"launches": kernels.launch_counts(), "loss": float(out["loss"])}, f)
