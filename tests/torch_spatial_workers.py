"""The rank side of the port's spatial-sharding tests (tests/
test_torch_spatial.py, tests/test_torch_on_card.py): ports of the JAX
package's tests/test_sharding.py cases, run on every rank of a
(data, space) grid of ``mesh.init_grid``.  This module imports no JAX: a
rank loads torch and the port only."""

from __future__ import annotations

import copy
import os

import numpy as np
import torch

from torch_helpers import XCEPTION_MIDDLE, conf_dict, port_model

ONE_BY_ONE = [{"op": "conv", "kernel": 1, "input": -1}]
# tests/test_sharding.py enriched_middle_conf: dilations past every shard
# and a pyramid pooling whose window spans every shard
ENRICHED = [
    {"op": "conv", "kernel": 3, "rate": [1, 1], "input": -1},
    {"op": "conv", "kernel": 3, "rate": [18, 15], "input": 0},
    {"op": "conv", "kernel": 3, "rate": [6, 21], "input": 0},
    {"op": "pyramid_pooling", "kernel": 4, "input": 0, "target_size_factor": [4, 4]},
]
# tests/test_sharding.py nondegenerate_middle_conf: halos inside a shard
NONDEGENERATE = [
    {"op": "conv", "kernel": 1, "input": -1},
    {"op": "conv", "kernel": 3, "rate": [3, 3], "input": 0},
    {"op": "conv", "kernel": 3, "rate": [6, 6], "input": 0},
    {"op": "pyramid_pooling", "kernel": 4, "input": 0, "target_size_factor": [4, 4]},
]


def case_conf(size: int, batch: int, middle, refine: bool = False, base: str = "mobilenetv2",
              output_stride: int = 16, **extra) -> dict:
    """tests/test_sharding.py ``tiny_conf`` (reduction and concat 16,
    dropout 0: element-wise dropout draws from each rank's stream) at
    ``size`` in float64, Keras Adam at lr 1e-4."""
    conf = conf_dict(size, output_stride, refine=refine, **extra)
    conf["base_model"] = base
    conf["nn_arch"].update(reduction_size=16, concat_channels=16, dropout_rate=0.0,
                           encoder_middle_conf=copy.deepcopy(middle))
    conf["hps"].update(dtype="float64", batch_size=batch, lr=1e-4, decay=0.0)
    return conf


# case → (config, "train" steps or "eval"), after tests/test_sharding.py
CASES = {
    # :51 (32²: 4-way, the 2-row os-16 map leaves two ranks no rows)
    "tiny_train": (case_conf(32, 8, ONE_BY_ONE), 2),
    # the same under grad_accum 2 (a rank's slice of each microbatch; the
    # JAX accumulating step carries a float32 loss, so one process only)
    "tiny_accum": (case_conf(32, 8, ONE_BY_ONE, grad_accum=2), 2),
    # :78
    "tiny_eval": (case_conf(32, 8, ONE_BY_ONE), "eval"),
    # :161, the reference's Xception ASPP at 64² (127- and 253-row maps)
    "xception_aspp": (case_conf(64, 4, XCEPTION_MIDDLE, base="xception"), "eval"),
    # :180
    "pyramid_eval": (case_conf(64, 8, ENRICHED), "eval"),
    # :191
    "pyramid_train": (case_conf(64, 8, ENRICHED), 1),
    # :240, :277 (halos strictly inside a shard)
    "halo_eval": (case_conf(256, 4, NONDEGENERATE, refine=True), "eval"),
    "halo_train": (case_conf(256, 4, NONDEGENERATE, refine=True), 1),
    # :254
    "os8_eval": (case_conf(128, 4, NONDEGENERATE, refine=True, output_stride=8), "eval"),
    # :312
    "refine_fused": (case_conf(32, 8, ONE_BY_ONE, refine=True, fused_upconv=True), "eval"),
    "refine_unfused": (case_conf(32, 8, ONE_BY_ONE, refine=True, fused_upconv=False), "eval"),
}
# the (n_data, n_space) grids, by world size
GRIDS = {2: [(1, 2)], 4: [(2, 2), (1, 4)]}


def batches(case: str, steps: int) -> list[dict]:
    """The case's global batches (numpy, float64 images in (−1, 1),
    integer labels), the second of a train case with one padded sample."""
    conf, _ = CASES[case]
    B, S = conf["hps"]["batch_size"], conf["nn_arch"]["image_size"]
    rng = np.random.default_rng(3)
    out = []
    for s in range(steps):
        valid = np.ones(B, np.int32)
        if s == 1:
            valid[-1] = 0
        out.append({"image": rng.uniform(-1, 1, (B, S, S, 3)),
                    "label": rng.integers(0, 21, (B, S, S)), "valid": valid})
    return out


def run_case(case: str, variables, grid=None) -> dict:
    """The case on the CPU in float64: on this rank's batch rows and image
    rows of each global batch under ``grid``, else on all of it (one
    process).  Train: losses, confusion matrices and the state after the
    steps.  Eval: loss, confusion matrix and probabilities (this rank's
    samples, their whole height)."""
    from deeplabv3plus_keras_tpu_torch.config import Config
    from deeplabv3plus_keras_tpu_torch.parallel import mesh, step

    conf, kind = CASES[case]
    model = port_model(conf, variables).to(torch.float64)
    pconf = Config.from_dict(conf)
    B = conf["hps"]["batch_size"]

    def local(b: dict) -> dict:
        if grid is None:
            return {k: torch.from_numpy(v) for k, v in b.items()}
        rows = mesh.row_indices(B, grid.n_data, grid.d, int(conf.get("grad_accum", 1)))
        a, e = grid.rows_of(b["image"].shape[1])
        return {"image": torch.from_numpy(b["image"][rows, a:e]),
                "label": torch.from_numpy(b["label"][rows, a:e]),
                "valid": torch.from_numpy(b["valid"][rows])}

    if kind == "eval":
        out = step.build_eval_step(model, pconf, with_probs=True)(local(batches(case, 1)[0]))
        return {"loss": float(out["loss"]), "cm": out["cm"].numpy(), "probs": out["probs"]}
    opt = step.create_train_state(pconf, model)
    train_step = step.build_train_step(model, opt, pconf)
    losses, cms = [], []
    for b in batches(case, kind):
        out = train_step(local(b))
        losses.append(float(out["loss"]))
        cms.append(out["cm"].numpy())
    return {"losses": losses, "cms": cms,
            "state": {k: v.detach().clone() for k, v in model.state_dict().items()}}


def spatial_worker(variables_dir: str, out_dir: str, cases=None, units: bool = True) -> None:
    """Every case (of ``cases``, default all) on every grid of this world
    size; one file a case, grid and rank (what the rank computed, and the
    exchanges it made); then, with ``units``, :func:`unit_worker`."""
    from deeplabv3plus_keras_tpu_torch.parallel import mesh, spatial

    torch.set_num_threads(1)
    for n_data, n_space in GRIDS[mesh.world_size()]:
        grid = mesh.init_grid(n_space)
        for case in cases or CASES:
            variables = torch.load(os.path.join(variables_dir, f"{case}.pt"), weights_only=False)
            spatial.reset_counts()
            out = run_case(case, variables, grid)
            out["exchanges"] = dict(spatial.counts)
            torch.save(out, os.path.join(out_dir, f"{case}_{n_data}x{n_space}_r{mesh.rank()}.pt"))
    if units:
        unit_worker(out_dir)


def unit_worker(out_dir: str) -> None:
    """On a (1 × world) grid: ``fetch_rows`` against slices of the whole
    tensor and its backward against its forward (⟨F x, g⟩ = ⟨x, Fᵀ g⟩
    summed over the ranks, float64), for requests past a whole shard and
    off the image; and the label step's halo-and-crop around K1's plain
    version against the whole logits."""
    from deeplabv3plus_keras_tpu_torch.kernels import upsample_argmax
    from deeplabv3plus_keras_tpu_torch.parallel import mesh, spatial

    world = mesh.world_size()
    grid = mesh.init_grid(world)
    S, s = world, grid.s
    H = 11  # uneven over 2 (6, 5), 3 (4, 4, 3) and 4 (3, 3, 3, 2) ranks
    gen = torch.Generator().manual_seed(0)
    xg = torch.randn(2, 3, H, 5, generator=gen, dtype=torch.float64)
    a, b = mesh.rows_of(H, S, s)
    x = xg[:, :, a:b].contiguous(memory_format=torch.channels_last).requires_grad_()
    result = {}
    # each rank's request: its rows and a halo of 5 above (wider than a shard),
    # 2 below, off the image at both ends
    reqs = {"halo": ([mesh.rows_of(H, S, q)[0] - 5 for q in range(S)],
                     [mesh.rows_of(H, S, q)[1] + 2 for q in range(S)]),
            "far": ([(7 * q) % H - 3 for q in range(S)], [(7 * q) % H + 4 for q in range(S)]),
            "none": ([0] * S, [0] * S)}
    for name, (lo, hi) in reqs.items():
        for edge in ("zero", "clamp"):
            if name == "none" and edge == "clamp":
                continue
            y = spatial.fetch_rows(x, lo, hi, H, edge)
            idx = torch.arange(lo[s], hi[s])
            inside = (idx >= 0) & (idx < H)
            want = xg.index_select(2, idx.clamp(0, H - 1))
            if edge == "zero":
                want = want * inside[None, None, :, None]
            g = torch.randn(y.shape, generator=gen, dtype=torch.float64)
            (gx,) = torch.autograd.grad(y, x, g)
            dots = torch.stack([(y * g).sum(), (x * gx).sum()]).detach()
            mesh.all_reduce_(dots)
            result[f"{name}_{edge}"] = {"forward_error": float((y - want).abs().max()) if y.numel()
                                        else 0.0, "dots": dots.tolist()}
    # K1 halo-and-crop: logits of h = 7 rows at ×4 and ×2
    for up in (2, 4):
        logits = torch.randn(2, 7, 7, 21, generator=torch.Generator().manual_seed(up))
        whole = upsample_argmax(logits, up)
        a, b = mesh.rows_of(7, S, s)
        mine = logits[:, a:b].permute(0, 3, 1, 2)
        labels = spatial.resize_rows(
            mine, up, lambda xb: upsample_argmax(xb.permute(0, 2, 3, 1).contiguous(), up),
            out_width=7 * up, out_channels=0, row_dim=1)
        full = spatial.gather_rows(labels, 7 * up, 1).to(torch.int32)
        result[f"k1_x{up}"] = bool(torch.equal(full, whole))
    torch.save(result, os.path.join(out_dir, f"unit_{world}_r{mesh.rank()}.pt"))
    mesh.init_grid(1)


def facade_conf(root: str, **extra) -> dict:
    """The flagship's head on MobileNetV2 at 32², float32, B = 4, one epoch
    over a synthetic VOC tree at ``root``, dropout 0."""
    conf = conf_dict(32, resource_type="pascal_voc_2012", resource_path=root, workers=1,
                     max_queue_size=4, **extra)
    conf["hps"].update(epochs=1, batch_size=4)
    conf["nn_arch"]["dropout_rate"] = 0.0
    return conf


def facade_restored(conf: dict, work_dir: str, result_saving: bool) -> dict:
    """A ``model_loading`` facade's ``evaluate()`` (and, with
    ``result_saving``, its panels and ``test()``'s PNGs in ``work_dir``)
    and ``segment()`` of the test images."""
    from PIL import Image

    from deeplabv3plus_keras_tpu_torch import SemanticSegmentation
    from deeplabv3plus_keras_tpu_torch.data import MODE_TEST

    seg = SemanticSegmentation({**conf, "model_loading": True}, work_dir=work_dir, device="cpu")
    miou = seg.evaluate(result_saving=result_saving)
    images, names = [], []
    for b in seg._batches(seg._loader(MODE_TEST, with_labels=False), with_labels=False):
        images.append(b["image"])
        names += [n for n, v in zip(b["names"], b["valid"].tolist()) if v]
    out = {"val_miou": miou.result(), "cm": miou.total_cm, "names": names,
           "labels": seg.segment(torch.cat(images))[:len(names)]}
    if result_saving:
        seg.test()
        if not seg._writes_samples():  # space position 0 writes them
            return out
        png_dir = os.path.join(work_dir, "test_results")
        out["pngs"] = {n: np.asarray(Image.open(os.path.join(png_dir, f"{n}.png"))) for n in names}
        out["panels"] = sorted(os.listdir(os.path.join(work_dir, "results")))
    return out


def facade_train(conf: dict, work_dir: str) -> dict:
    """``train()`` on the CPU: the history."""
    from deeplabv3plus_keras_tpu_torch import SemanticSegmentation

    torch.set_num_threads(1)
    return SemanticSegmentation(conf, work_dir=work_dir, device="cpu").train()


def facade_worker(root: str, work_dir: str, out_dir: str) -> None:
    """The JSON-config entry points over the group as one (1 × world) grid
    (``mesh_space`` = world): ``train()`` (rank 0 writes the checkpoint),
    then a restored facade's ``evaluate()`` with result panels, ``test()``
    (space position 0 writes the PNGs) and ``segment()``, and ``train()``
    again from the device-resident dataset (``cache_device``); every
    rank's results."""
    from deeplabv3plus_keras_tpu_torch.parallel import mesh

    world = mesh.world_size()
    conf = {**facade_conf(root), "multi_gpu": True, "num_gpus": world, "mesh_space": world}
    out = {"history": facade_train(conf, work_dir), **facade_restored(conf, work_dir, True),
           "history_cached": facade_train({**conf, "cache_device": True}, work_dir + "_cached")}
    torch.save(out, os.path.join(out_dir, f"facade_r{mesh.rank()}.pt"))


def on_card_spatial_worker(out_dir: str) -> None:
    """One flagship-shaped step (the five-branch ASPP, 128², B = 2) with
    ``mesh_space`` = world on this rank's card: its image rows of the same
    global batch; the loss and the kernels' launches."""
    import json

    from deeplabv3plus_keras_tpu_torch import SemanticSegmentation, kernels
    from deeplabv3plus_keras_tpu_torch.parallel import mesh
    from torch_helpers import FLAGSHIP_MIDDLE

    torch.backends.cudnn.allow_tf32 = False
    world = mesh.world_size()
    conf = conf_dict(128)
    conf["nn_arch"].update(encoder_middle_conf=copy.deepcopy(FLAGSHIP_MIDDLE), dropout_rate=0.0)
    seg = SemanticSegmentation({**conf, "multi_gpu": True, "num_gpus": world, "mesh_space": world},
                               device=torch.device("cuda", torch.cuda.current_device()))
    rng = np.random.default_rng(0)
    batch = {"image": rng.uniform(-1, 1, (2, 128, 128, 3)).astype(np.float32),
             "label": rng.integers(0, 21, (2, 128, 128))}
    kernels.reset_launch_counts()
    out = seg.train_step(batch)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    labels = seg.segment(batch["image"])
    with open(os.path.join(out_dir, f"spatial_card_r{mesh.rank()}.json"), "w") as f:
        json.dump({"launches": launches, "loss": float(out["loss"]),
                   "labels": labels.tolist()}, f)
