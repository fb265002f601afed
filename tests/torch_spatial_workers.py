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


def int8_conf(base: str) -> dict:
    """``int8_infer`` on the flagship (with a pyramid pooling branch, whose
    2 × 2 pooled map leaves ranks of a 4-way split no rows) or on Xception
    with the reference's ASPP, 64², B = 4, float64."""
    conf = conf_dict(64, pyramid=base == "mobilenetv2", int8_infer=True)
    if base == "xception":
        conf["base_model"] = base
        conf["nn_arch"]["encoder_middle_conf"] = copy.deepcopy(XCEPTION_MIDDLE)
    conf["nn_arch"]["dropout_rate"] = 0.0
    conf["hps"].update(dtype="float64", batch_size=4)
    return conf


# ops/quant.MAX_QUANT_PIXELS of an int8 case: above the pixels of the sites
# that quantize, and at least a shard's pixels of a map whose sites stay
# float (a gate on the shard's shape would quantize them): the flagship's
# 2 × 2 pooling conv quantizes, its 4 × 4 ASPP (8 pixels a rank of 2)
# stays float; Xception's 8 × 8 and smaller maps quantize (block 4's
# stride-2 shortcut on a row window), its 15 × 15 block 3 (120 pixels a
# rank of 2) stays float
INT8_MAX_PIXELS = {"int8_eval": 8, "xception_int8_eval": 120}


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
    # the step options under a space split: the parity tail on row windows
    # of the 16-row logits (a site's label rows follow the logits' rows)
    "tail_fused_train": (case_conf(32, 8, ONE_BY_ONE, refine=True, fused_tail=True), 2),
    # the backbone recomputed in the backward, its exchanges replayed (the
    # 2-row os-16 map leaves ranks of the 4-way split no rows)
    "remat_train": (case_conf(32, 8, ONE_BY_ONE, remat=True), 2),
    # whole images flipped and scaled before the rows are cut; the port
    # draws from torch's generator, JAX from jax.random: one process only
    "augment_train": (case_conf(64, 8, ONE_BY_ONE,
                                augment={"random_flip": True, "scale_range": [0.5, 2.0]}), 1),
    # test-time augmentation: 48² and 80² variants, flipped, resized back
    # to each rank's rows of 64² (80 → 64 antialiased)
    "tta_eval": (case_conf(64, 8, ONE_BY_ONE, eval_scales=[0.75, 1.25], eval_flip=True), "eval"),
    # C3: the facade's segment(), eval_step() (plain and flip-only TTA) and
    # train_step() on (64, 96) and (96, 64) images, 2 ranks only
    "nonsquare": (case_conf(64, 2, ONE_BY_ONE, refine=True), "nonsquare"),
    # the other backbones' families, one train step each: DenseNet's
    # zero-padded stem pool; EfficientNet's squeeze-excite mean over every
    # rank's rows, k = 5 windows, stochastic depth drawn per sample (64²);
    # NASNet at 48²: its VALID stem (23-, 12-, 6- and 3-row maps: uneven
    # splits, ranks with no rows), its correct_pad pools, its
    # count-excluding average pool and its shifted stride-2 adjustment of
    # 12 rows over 4 ranks and 6 over 2 (ranks that start at an odd row)
    "densenet_train": (case_conf(64, 4, ONE_BY_ONE, base="densenet121"), 1),
    "efficientnet_train": (case_conf(64, 4, ONE_BY_ONE, base="efficientnetb0"), 1),
    "nasnet_train": (case_conf(48, 4, ONE_BY_ONE, base="nasnetmobile"), 1),
    "nasnet_eval": (case_conf(48, 4, ONE_BY_ONE, base="nasnetmobile"), "eval"),
    # int8_infer: calibration on the ranks' rows, then the eval and label
    # steps with the eligible sites in int8 (INT8_MAX_PIXELS)
    "int8_eval": (int8_conf("mobilenetv2"), "int8"),
    "xception_int8_eval": (int8_conf("xception"), "int8"),
}
# the cases of tests/test_torch_spatial_backbones.py
BACKBONE_CASES = ("densenet_train", "efficientnet_train", "nasnet_train", "nasnet_eval",
                  "int8_eval", "xception_int8_eval")
# the (n_data, n_space) grids, by world size
GRIDS = {2: [(1, 2)], 4: [(2, 2), (1, 4)]}
# the cases run on some grids only
CASE_GRIDS = {"nonsquare": [(1, 2)]}
NONSQUARE = ((64, 96), (96, 64))


def case_grids(case: str) -> list:
    return CASE_GRIDS.get(case, [g for grids in GRIDS.values() for g in grids])


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
    """The case on the CPU in float64: on this rank's batch rows of each
    global batch under ``grid`` (whole images: the step cuts the image
    rows), else on all of it (one process).  Train: losses, confusion
    matrices and the state after the steps.  Eval: loss, confusion matrix
    and probabilities (this rank's samples, their whole height)."""
    from deeplabv3plus_keras_tpu_torch.config import Config
    from deeplabv3plus_keras_tpu_torch.parallel import mesh, step

    conf, kind = CASES[case]
    if kind == "nonsquare":
        return run_nonsquare(conf, variables, grid)
    if kind == "int8":
        return run_int8(case, variables, grid)
    model = port_model(conf, variables).to(torch.float64)
    pconf = Config.from_dict(conf)
    B = conf["hps"]["batch_size"]

    def local(b: dict) -> dict:
        """This rank's data position's samples, whole images (the step
        cuts the image rows)."""
        if grid is None:
            return {k: torch.from_numpy(v) for k, v in b.items()}
        rows = mesh.row_indices(B, grid.n_data, grid.d, int(conf.get("grad_accum", 1)))
        return {k: torch.from_numpy(v[rows]) for k, v in b.items()}

    if kind == "eval":
        out = step.build_eval_step(model, pconf, with_probs=True, **tta_keys(conf))(
            local(batches(case, 1)[0]))
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


def run_int8(case: str, variables, grid) -> dict:
    """An int8 case (float64, ``MAX_QUANT_PIXELS`` = ``INT8_MAX_PIXELS``):
    ``quant.calibrate`` on this rank's data position's samples (whole
    images: it cuts the image rows), then the eval step with probabilities
    and the label step of the whole batch, both at the calibrated sites:
    the ranges, the sites that ran int8 (name → calls), those a gate on
    the shard's pixels would have quantized and the eval step kept in
    float, the loss, matrix, probabilities and labels."""
    from deeplabv3plus_keras_tpu_torch.config import Config
    from deeplabv3plus_keras_tpu_torch.ops import quant
    from deeplabv3plus_keras_tpu_torch.parallel import mesh, spatial, step

    conf, _ = CASES[case]
    model = port_model(conf, variables).to(torch.float64)
    pconf = Config.from_dict(conf)
    b = batches(case, 1)[0]
    mine = b
    if grid is not None:
        mine = {k: v[mesh.row_indices(len(v), grid.n_data, grid.d)] for k, v in b.items()}
    mine = {k: torch.from_numpy(v) for k, v in mine.items()}
    limit = INT8_MAX_PIXELS[case]
    # the sites a gate on the shard's pixels would quantize and the image's
    # pixels keep in float
    shard_only = set()

    def gate_probe(name):
        def hook(mod, args):
            x = args[0]
            if spatial.active() and min(mod.weight.shape[:2]) >= quant.MIN_QUANT_CHANNELS and (
                    0 < x.shape[-2] * x.shape[-1] <= limit < spatial.global_height(x) * x.shape[-1]):
                shard_only.add(name)
        return hook

    saved = quant.MAX_QUANT_PIXELS
    quant.MAX_QUANT_PIXELS = limit
    try:
        ranges = quant.calibrate(model, [mine["image"]])
        quant.reset_counts()
        probes = [m.register_forward_pre_hook(gate_probe(n)) for n, m in model.named_modules()
                  if getattr(m, "quantizable", False)]
        out = step.build_eval_step(model, pconf, with_probs=True, quant=ranges)(mine)
        for h in probes:
            h.remove()
        eval_sites = dict(quant.sites)
        labels = step.build_label_step(model, quant=ranges)(torch.from_numpy(b["image"]))
    finally:
        quant.MAX_QUANT_PIXELS = saved
    return {"loss": float(out["loss"]), "cm": out["cm"].numpy(), "probs": out["probs"],
            "ranges": {k: float(v) for k, v in ranges.items()}, "sites": eval_sites,
            "shard_gate_only": sorted(shard_only), "labels": labels.numpy()}


def tta_keys(conf: dict) -> dict:
    """The eval step's test-time augmentation, from the extra keys."""
    return {"tta_scales": conf.get("eval_scales"), "tta_flip": bool(conf.get("eval_flip", False))}


def run_nonsquare(conf: dict, variables, grid) -> dict:
    """(64, 96) and (96, 64) images, B = 2: for each shape the label step's
    whole labels, the eval step's loss, matrix and probabilities, those of
    the eval step with the flip alone as test-time augmentation, then a
    train step's (float64, from ``variables``); whether an eval step with a
    test-time scale refused the shape (JAX's resizes to squares); the state
    after the steps; and the facade's ``segment()`` of the same images
    (float32, its own random weights; under ``grid``: ``mesh_space`` over
    its ranks)."""
    from deeplabv3plus_keras_tpu_torch import SemanticSegmentation
    from deeplabv3plus_keras_tpu_torch.config import Config
    from deeplabv3plus_keras_tpu_torch.parallel import step

    model = port_model(conf, variables).to(torch.float64)
    pconf = Config.from_dict(conf)
    train_step = step.build_train_step(model, step.create_train_state(pconf, model), pconf)
    eval_step = step.build_eval_step(model, pconf, with_probs=True)
    flip_step = step.build_eval_step(model, pconf, with_probs=True, tta_flip=True)
    scaled_step = step.build_eval_step(model, pconf, with_probs=True, tta_scales=[1.25])
    label_step = step.build_label_step(model)
    rng = np.random.default_rng(5)
    images = [rng.uniform(-1, 1, (2, H, W, 3)) for H, W in NONSQUARE]
    out = {"labels": [], "losses": [], "cms": [], "probs": [], "scaled_tta_refused": []}
    for x in images:
        b = {"image": torch.from_numpy(x), "valid": torch.ones(2, dtype=torch.int32),
             "label": torch.from_numpy(rng.integers(0, 21, x.shape[:3]))}
        out["labels"].append(label_step(b["image"]).numpy())
        evs = [eval_step(b), flip_step(b)]
        out["probs"] += [ev["probs"] for ev in evs]
        for m in (*evs, train_step(b)):
            out["losses"].append(float(m["loss"]))
            out["cms"].append(m["cm"].numpy())
        try:
            scaled_step(b)
            out["scaled_tta_refused"].append(False)
        except ValueError:
            out["scaled_tta_refused"].append(True)
    out["state"] = {k: v.detach().clone() for k, v in model.state_dict().items()}
    fconf = {**conf, "hps": {**conf["hps"], "dtype": "float32"}}
    if grid is not None:
        fconf.update(multi_gpu=True, num_gpus=grid.n_data * grid.n_space, mesh_space=grid.n_space)
    seg = SemanticSegmentation(fconf, device="cpu")
    out["segment"] = [seg.segment(x.astype(np.float32)) for x in images]
    return out


def spatial_worker(variables_dir: str, out_dir: str, cases=None, units: bool = True) -> None:
    """Every case (of ``cases``, default all) on every grid of this world
    size; one file a case, grid and rank (what the rank computed, and the
    exchanges it made); then, with ``units``, :func:`unit_worker`."""
    from deeplabv3plus_keras_tpu_torch.parallel import mesh, spatial

    torch.set_num_threads(1)
    for n_data, n_space in GRIDS[mesh.world_size()]:
        grid = mesh.init_grid(n_space)
        for case in cases or CASES:
            if (n_data, n_space) not in case_grids(case):
                continue
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
        with spatial.use_heights({7: 7}):
            labels = spatial.resize_rows(
                mine, up, lambda xb: upsample_argmax(xb.permute(0, 2, 3, 1).contiguous(), up),
                out_width=7 * up, out_channels=0, row_dim=1)
        full = spatial.gather_rows(labels, 7 * up, 1).to(torch.int32)
        result[f"k1_x{up}"] = bool(torch.equal(full, whole))
    result.update(tail_rows(S, s))
    torch.save(result, os.path.join(out_dir, f"unit_{world}_r{mesh.rank()}.pt"))
    mesh.init_grid(1)


def tail_rows(S: int, s: int) -> dict:
    """The fused tail (``ops/parity_tail.tail_loss_cm``, its plain version)
    on this rank's rows of h = 7 and h = 3 logits rows, against the whole
    map's in one process (``spatial.local``): the loss summed over the
    ranks, the matrix, and the logits' gradient gathered (the fetch's
    transpose returns the context rows' share to their owners), float64.
    ⌈2h/S⌉ is odd at S = 2 and 3, so a site's label rows are not
    ``rows_of(2h)``'s; at S = 4 a rank holds no site of h = 3."""
    from deeplabv3plus_keras_tpu_torch.ops.parity_tail import tail_loss_cm
    from deeplabv3plus_keras_tpu_torch.parallel import mesh, spatial

    out = {}
    C = 5
    pw, nw = np.linspace(0.3, 0.99, C), np.linspace(0.7, 0.01, C)
    for h in (7, 3):
        gen = torch.Generator().manual_seed(h)
        logits = torch.randn(2, h, 4, C, generator=gen, dtype=torch.float64)
        label = torch.randint(0, C, (2, 2 * h, 8), generator=gen)
        valid = torch.tensor([1, 1])
        with spatial.local():
            x = logits.clone().requires_grad_()
            loss, cm = tail_loss_cm(x, label, pw, nw, C, valid)
            (grad,) = torch.autograd.grad(loss, x)
        a, b = mesh.rows_of(h, S, s)
        mine = logits[:, a:b].clone().requires_grad_()
        with spatial.use_heights({4: h}):
            share, cm_rows = tail_loss_cm(mine, label, pw, nw, C, valid)
        (g,) = torch.autograd.grad(share, mine)
        total = mesh.all_reduce_(torch.cat([share.detach().reshape(1), cm_rows.reshape(-1).double()]))
        out[f"tail_h{h}"] = {
            "loss_rel": abs(float(total[0]) - loss.item()) / loss.item(),
            "cm_equal": bool(torch.equal(total[1:].reshape(C, C).to(torch.int32), cm)),
            "grad_rel": float((spatial.gather_rows(g, h, 1) - grad).abs().max() / grad.abs().max())}
    return out


# the facade's runs of tests/test_torch_spatial_backbones.py: the three
# backbones' families, and int8_infer on the flagship and on Xception
FACADE_BACKBONES = ("densenet121", "efficientnetb0", "nasnetmobile", "int8_mobilenetv2",
                    "int8_xception")


def facade_backbones(world: int | None, names=FACADE_BACKBONES) -> dict:
    """``SemanticSegmentation(conf, device="cpu")`` at 32², B = 2, float32,
    dropout 0 (its own random weights), with ``mesh_space`` = ``world``
    over the process group, or one process (None), for each of ``names``
    (of :data:`FACADE_BACKBONES`): a backbone's ``train_step()`` (loss and
    matrix), ``eval_step()`` and ``segment()``; under ``int8_infer``,
    ``segment()`` (which calibrates on its images), then the int8 eval
    step, the sites that ran int8 and the ranges."""
    from deeplabv3plus_keras_tpu_torch import SemanticSegmentation
    from deeplabv3plus_keras_tpu_torch.ops import quant

    torch.set_num_threads(1)
    rng = np.random.default_rng(21)
    images = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    batch = {"image": images, "label": rng.integers(0, 21, (2, 32, 32))}
    out = {}
    for name in names:
        int8 = name.startswith("int8_")
        base = name.removeprefix("int8_")
        conf = conf_dict(32, int8_infer=int8)
        conf["base_model"] = base
        if base == "xception":
            conf["nn_arch"]["encoder_middle_conf"] = copy.deepcopy(XCEPTION_MIDDLE)
        conf["nn_arch"]["dropout_rate"] = 0.0
        if world:
            conf.update(multi_gpu=True, num_gpus=world, mesh_space=world)
        seg = SemanticSegmentation(conf, device="cpu")
        r = {}
        if int8:
            quant.reset_counts()
            r["labels"] = seg.segment(images)
            m = seg._int8_step("eval", with_probs=False)(seg._batch(batch))
            r.update(sites=dict(quant.sites), ranges={k: float(v) for k, v in seg._quant.items()})
        else:
            m = seg.train_step(batch)
            r.update(train_loss=float(m["loss"]), train_cm=m["cm"].numpy())
            m = seg.eval_step(batch)
            r["labels"] = seg.segment(images)
        r.update(eval_loss=float(m["loss"]), eval_cm=m["cm"].numpy())
        out[name] = r
    return out


def facade_backbones_worker(out_dir: str, names=FACADE_BACKBONES) -> None:
    """:func:`facade_backbones` of ``names`` over the process group as one
    (1 × world) grid; every rank's results."""
    from deeplabv3plus_keras_tpu_torch.parallel import mesh

    out = facade_backbones(mesh.world_size(), names)
    torch.save(out, os.path.join(out_dir, f"facade_backbones_r{mesh.rank()}.pt"))


def facade_build_worker(out_dir: str, conf: dict) -> None:
    """``SemanticSegmentation(conf, device="cpu")`` over the process group:
    this rank's world, its (data, space) grid and whether it serves int8."""
    from deeplabv3plus_keras_tpu_torch import SemanticSegmentation
    from deeplabv3plus_keras_tpu_torch.parallel import mesh

    seg = SemanticSegmentation(conf, device="cpu")
    torch.save({"world": seg.world, "grid": (seg.grid.n_data, seg.grid.n_space),
                "int8": seg._int8}, os.path.join(out_dir, f"facade_build_r{mesh.rank()}.pt"))


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
