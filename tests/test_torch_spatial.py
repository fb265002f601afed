"""Spatial sharding on the port (``mesh_space``, ``parallel/spatial.py``):
ranks of a gloo process group on the CPU, each holding some rows of every
image, against one process and against the JAX package's spatially sharded
step.

The cases are the JAX package's tests/test_sharding.py (a tiny train and
eval step at 32², where a 4-way split leaves ranks no rows of the 2-row
os-16 map; Xception's ASPP at 64², whose 127- and 253-row maps split
unevenly; dilations wider than a shard and a pyramid pooling whose window
spans every shard, in eval and train; halos strictly inside a shard at 256²
in eval and train; os 8; the refinement decoder with and without the fused
upsample-conv) and the tiny train step under ``grad_accum`` 2 (against
one process only: the JAX accumulating step carries a float32 loss), in
float64 on the (n_data, n_space) grids (1, 2), (2, 2) and (1, 4).  The
step options under a space split: ``fused_tail`` (the parity tail on row
windows of the logits), ``remat`` (the backbone's exchanges recomputed),
``augment`` (against one process only: the port draws its flips and
scales from torch's generator, JAX from ``jax.random``) and test-time
augmentation; ``remat`` computes the unrematerialised step's numbers, so
its JAX reference is ``tiny_train``'s (no further compile).  And the
facade's ``segment()``, ``eval_step()`` and ``train_step()`` on (64, 96)
and (96, 64) images on the 2-rank grid (labels equal to one process's at
every pixel): the JAX package's spatial steps take both shapes, its
test-time augmentation neither (it resizes to squares), and the port's
alike.  One spawn of 2 ranks and one of 4 carry every case of a file
(``torch_spatial_workers.py``), with a deadline; the JAX steps and the one
process run meanwhile.  The 128² and 256² cases, whose JAX steps take most
of the compile time, run from tests/test_torch_spatial_halo.py, so that
the two files run side by side.

Tolerances (float64):

- the ranks against the port's one process: losses to 1e-12 relative,
  parameters and BN statistics to 1e-12 absolute, probabilities to 1e-12,
  confusion matrices equal, as tests/test_torch_ddp.py holds a data split.
  Measured: ≤ 2e-14 on the statistics, ≤ 2e-15 on the probabilities.
- against JAX ``shard_step(..., spatial=True)`` on a mesh of the same
  shape (``jax_enable_x64``, the 8 virtual CPU devices of conftest.py):
  losses, probabilities and parameters and statistics after the steps to
  1e-10 relative to each tensor's scale.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_spatial_workers as workers
from deeplabv3plus_keras_tpu.config import Config as JaxConfig
from deeplabv3plus_keras_tpu.parallel import build_eval_step as jax_build_eval_step
from deeplabv3plus_keras_tpu.parallel import build_train_step as jax_build_train_step
from deeplabv3plus_keras_tpu.parallel import create_train_state as jax_create_train_state
from deeplabv3plus_keras_tpu.parallel import make_mesh, shard_step
from deeplabv3plus_keras_tpu_torch.data import make_synthetic_voc
from deeplabv3plus_keras_tpu_torch.kernels import depthwise as dw
from deeplabv3plus_keras_tpu_torch.parallel import launch, mesh
from deeplabv3plus_keras_tpu_torch.utils.jax_weights import export_jax_variables
from torch_helpers import jax_model_and_traced_variables, port_model

torch.set_num_threads(1)
HALO_CASES = ["halo_eval", "halo_train", "os8_eval"]
# tests/test_torch_spatial_halo.py and tests/test_torch_spatial_backbones.py
# run the others
CASES = [c for c in workers.CASES if c not in HALO_CASES and c not in workers.BACKBONE_CASES]
GRIDS = [g for grids in workers.GRIDS.values() for g in grids]
# the mesh each case's JAX step runs on (one of the ranks' grids)
JAX_MESH = {"tiny_train": (1, 2), "tiny_eval": (2, 2), "xception_aspp": (1, 4),
            "pyramid_eval": (1, 4), "pyramid_train": (2, 2), "halo_eval": (1, 2),
            "halo_train": (2, 2), "os8_eval": (1, 2), "refine_fused": (1, 4),
            "refine_unfused": (2, 2), "tail_fused_train": (1, 4), "tta_eval": (2, 2),
            "remat_train": (1, 2), "nasnet_eval": (1, 2)}
# a case whose JAX step computes another's numbers: that one's reference
JAX_REF = {"remat_train": "tiny_train"}


def case_grid_params(cases):
    """(case, grid) of every case on each grid it runs on."""
    return [pytest.param(c, g, id=f"{c}-{g[0]}x{g[1]}") for c in cases
            for g in workers.case_grids(c)]


def _jax_case(case: str, jm, variables) -> dict:
    """The case's JAX step, sharded with ``spatial=True`` over its mesh."""
    conf, kind = workers.CASES[case]
    jconf = JaxConfig.from_dict(conf)
    v = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, np.float64)), variables)
    state, tx = jax_create_train_state(jconf, v)
    m = make_mesh(*JAX_MESH[case])
    steps = 1 if kind == "eval" else kind
    bs = [{k: jnp.asarray(b[k]) for k in ("image", "label", "valid")}
          for b in workers.batches(case, steps)]
    if kind == "eval":
        step = jax_build_eval_step(jm, jconf, **workers.tta_keys(conf))
        out = shard_step(step, m, kind="eval", spatial=True)(state, bs[0])
        return {"loss": float(out["loss"]), "probs": np.asarray(out["probs"])}
    step = shard_step(jax_build_train_step(jm, tx, jconf), m, kind="train", spatial=True)
    losses = []
    for b in bs:
        state, metrics = step(state, b, jax.random.PRNGKey(3))
        losses.append(float(metrics["loss"]))
    return {"losses": losses, "params": jax.tree_util.tree_map(np.asarray, state.params),
            "batch_stats": jax.tree_util.tree_map(np.asarray, state.batch_stats)}


def spatial_runs(tmp, cases, units: bool):
    """Every rank's results of ``cases`` on every grid, the one process's
    and the JAX steps', and (``units``) the unit checks of 2, 3 and 4
    ranks and the facade's entry points over 2 ranks and in one process
    from a VOC tree."""
    models = {}
    for case in cases:
        jm, variables = jax_model_and_traced_variables(workers.CASES[case][0], seed=7)
        torch.save(variables, tmp / f"{case}.pt")
        models[case] = (jm, variables)
    with ThreadPoolExecutor(3) as pool:
        spawns = [pool.submit(launch.spawn, workers.spatial_worker, n,
                              (str(tmp), str(tmp), cases, units), devices=["cpu"] * n,
                              timeout_s=300, group_timeout_s=120)
                  for n in (2, 4)]
        if units:
            spawns.append(pool.submit(launch.spawn, workers.unit_worker, 3, (str(tmp),),
                                      devices=["cpu"] * 3, timeout_s=120, group_timeout_s=60))
            root = make_synthetic_voc(str(tmp / "voc"), n_train=8, n_val=4, n_test=3,
                                      min_size=40, max_size=90)
            spawns.append(pool.submit(launch.spawn, workers.facade_worker, 2,
                                      (root, str(tmp / "ranks"), str(tmp)), devices=["cpu"] * 2,
                                      timeout_s=240, group_timeout_s=120))
        one = {case: workers.run_case(case, models[case][1]) for case in cases}
        if units:
            one["facade"] = workers.facade_train(workers.facade_conf(root), str(tmp / "one"))
            one["facade_cached"] = workers.facade_train(
                {**workers.facade_conf(root), "cache_device": True}, str(tmp / "one_cached"))
        from deeplabv3plus_keras_tpu.kernels import depthwise3

        single = depthwise3._single_device_mesh  # shard_step sets it for the mesh
        jax.config.update("jax_enable_x64", True)
        try:
            ref = {case: _jax_case(case, *models[case]) for case in cases
                   if case in JAX_MESH and case not in JAX_REF}
            ref.update({case: ref[JAX_REF[case]] for case in cases if case in JAX_REF})
        finally:
            jax.config.update("jax_enable_x64", False)
            depthwise3.set_single_device_mesh(single)
        for s in spawns:
            s.result()

    def load(name):
        return torch.load(tmp / name, weights_only=False)

    ranks = {(case, g): [load(f"{case}_{g[0]}x{g[1]}_r{r}.pt") for r in range(g[0] * g[1])]
             for case in cases for g in workers.case_grids(case)}
    unit = {n: [load(f"unit_{n}_r{r}.pt") for r in range(n)] for n in (2, 3, 4)} if units else {}
    if units:
        unit["facade"] = [load(f"facade_r{r}.pt") for r in range(2)]
        # one process evaluating and labelling the ranks' checkpoint
        unit["facade_one"] = workers.facade_restored(workers.facade_conf(root), str(tmp / "ranks"),
                                                     False)
    return ranks, one, ref, unit, models


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return spatial_runs(tmp_path_factory.mktemp("spatial"), CASES, units=True)


def _probs(rs: list, grid) -> torch.Tensor:
    """The global batch's probabilities from the ranks of space position 0
    (each holds its data position's samples at their whole height)."""
    n_data, n_space = grid
    return torch.cat([rs[d * n_space]["probs"] for d in range(n_data)])


@pytest.mark.parametrize("case,grid", case_grid_params(CASES))
def test_spatial_ranks_equal_one_process(runs, case, grid):
    """float64: every rank's losses, confusion matrices and, after the
    train steps, parameters and BN statistics against one process; eval's
    probabilities of every sample, whole height; ``segment()``'s labels of
    non-square images at every pixel."""
    check_one_process(runs, case, grid)


def check_one_process(runs, case, grid):
    rs, one = runs[0][(case, grid)], runs[1][case]
    r0 = rs[0]
    if "losses" in one:
        for a, b in zip(r0["losses"], one["losses"]):
            assert abs(a - b) <= 1e-12 * abs(b), (case, grid, a, b)
        for a, b in zip(r0["cms"], one["cms"]):
            np.testing.assert_array_equal(a, b)
        for k, v in one["state"].items():
            if v.is_floating_point():
                assert float((r0["state"][k] - v).abs().max()) <= 1e-12, (case, grid, k)
            else:
                assert torch.equal(r0["state"][k], v), (case, grid, k)
        for r in rs:  # non-square images: every rank's whole labels
            for key in ("labels", "segment"):
                for a, b in zip(r.get(key, ()), one.get(key, ())):
                    assert a.shape == b.shape and np.array_equal(a, b), (case, grid, key)
        for a, b in zip(r0.get("probs", ()), one.get("probs", ())):
            assert a.shape == b.shape and float((a - b).abs().max()) <= 1e-12, (case, grid)
    else:
        assert abs(r0["loss"] - one["loss"]) <= 1e-12 * abs(one["loss"]), (case, grid)
        np.testing.assert_array_equal(r0["cm"], one["cm"])
        assert float((_probs(rs, grid) - one["probs"]).abs().max()) <= 1e-12, (case, grid)


def test_nonsquare_tta_refuses_a_scale_and_serves_the_flip(runs):
    """Non-square images: test-time augmentation at a scale that changes
    the height raises (JAX's resizes to and from squares) in one process
    and on every rank alike, while the flip alone, at the input size,
    serves both shapes (its probabilities held to one process above)."""
    one = runs[1]["nonsquare"]
    assert one["scaled_tta_refused"] == [True] * len(workers.NONSQUARE)
    for grid in workers.case_grids("nonsquare"):
        for r in runs[0][("nonsquare", grid)]:
            assert r["scaled_tta_refused"] == one["scaled_tta_refused"], grid
            assert [tuple(p.shape[1:3]) for p in r["probs"]] == [
                hw for hw in workers.NONSQUARE for _ in range(2)], grid


@pytest.mark.parametrize("case,grid", case_grid_params(CASES))
def test_spatial_ranks_agree_and_exchange_alike(runs, case, grid):
    """Every rank ends a train case with the same parameters and
    statistics bit for bit and the same losses, holds an eval case's loss
    and matrix, and made as many exchanges as every other rank (all enter
    every exchange, ranks with no rows included) and at least one."""
    check_ranks_agree(runs, case, grid)


def check_ranks_agree(runs, case, grid):
    rs = runs[0][(case, grid)]
    counts = {r["exchanges"]["exchanges"] for r in rs}
    assert len(counts) == 1 and counts.pop() > 0, [r["exchanges"] for r in rs]
    for r in rs[1:]:
        if "losses" in r:
            assert r["losses"] == rs[0]["losses"]
            for k in r["state"]:
                assert torch.equal(r["state"][k], rs[0]["state"][k]), (case, grid, k)
        else:
            assert r["loss"] == rs[0]["loss"]
            np.testing.assert_array_equal(r["cm"], rs[0]["cm"])


@pytest.mark.parametrize("case", [c for c in CASES if c in JAX_MESH])
def test_spatial_ranks_equal_jax_spatial_mesh(runs, case):
    """float64: the ranks of the case's grid against the JAX step sharded
    with ``spatial=True`` over a mesh of the same (data, space) shape, from
    the same weights and batches: losses, probabilities, and after the
    train steps every parameter and BN statistic, to 1e-10 of each
    tensor's scale."""
    check_jax(runs, case)


def check_jax(runs, case):
    ranks, _, ref, _, models = runs
    grid = JAX_MESH[case]
    rs, want = ranks[(case, grid)], ref[case]
    if "losses" in want:
        for a, b in zip(rs[0]["losses"], want["losses"]):
            assert abs(a - b) <= 1e-10 * abs(b), (case, a, b)
        conf, _ = workers.CASES[case]
        model = port_model(conf, models[case][1]).to(torch.float64)
        model.load_state_dict(rs[0]["state"])
        got = export_jax_variables(model)
        for tree, jt in ((got["params"], want["params"]), (got["batch_stats"], want["batch_stats"])):
            for path, leaf in jax.tree_util.tree_leaves_with_path(jt):
                mine = tree
                for k in path:
                    mine = mine[k.key]
                scale = max(float(np.abs(leaf).max()), 1e-12)
                assert float(np.abs(np.asarray(mine) - leaf).max()) <= 1e-10 * scale, (case, path)
    else:
        assert abs(rs[0]["loss"] - want["loss"]) <= 1e-10 * abs(want["loss"]), case
        probs = _probs(rs, grid).numpy()
        assert float(np.abs(probs - want["probs"]).max()) <= 1e-10 * float(np.abs(want["probs"]).max())


def test_facade_train_evaluate_test_over_a_space_split(runs):
    """``SemanticSegmentation`` with ``mesh_space`` 2 over two ranks, float32,
    from a synthetic VOC tree (tests/test_torch_ddp_api.py's bounds for a
    data split): ``train()``'s first epoch, streamed and from the
    device-resident dataset (``cache_device``), against one process (losses to
    1e-3 relative, mIoUs to 5e-3: float32 sums in another order, which
    Keras Adam at β₁ = 0.5 can turn into a whole ±lr update); the ranks'
    checkpoint evaluated by a restored facade on the ranks against one
    process (the mIoU to 1e-4, the confusion matrix's total exactly),
    ``test()``'s PNGs (space position 0 writes them) and ``segment()``'s
    whole labels on both ranks equal to one process's labels of that
    checkpoint, and the result panels written."""
    r0, r1 = runs[3]["facade"]
    one, one_eval = runs[1]["facade"], runs[3]["facade_one"]
    for mine, ref in ((r0["history"], one), (r0["history_cached"], runs[1]["facade_cached"])):
        for k in ("loss", "val_loss"):
            assert abs(mine[k][0] - ref[k][0]) <= 1e-3 * abs(ref[k][0]), k
        for k in ("miou", "val_miou"):
            assert abs(mine[k][0] - ref[k][0]) <= 5e-3, k
    assert r0["history"] == r1["history"] and r0["history_cached"] == r1["history_cached"]
    assert abs(r0["val_miou"] - one_eval["val_miou"]) <= 1e-4 and r1["val_miou"] == r0["val_miou"]
    assert r0["cm"].sum() == one_eval["cm"].sum()
    assert r0["names"] == one_eval["names"] and len(r0["names"]) == 3
    for r in (r0, r1):
        np.testing.assert_array_equal(r["labels"], one_eval["labels"])
    for n, lab in zip(one_eval["names"], one_eval["labels"]):
        np.testing.assert_array_equal(r0["pngs"][n], lab.astype(np.uint8))
    assert len(r0["panels"]) == 4 and "pngs" not in r1


@pytest.mark.parametrize("world", [2, 3, 4])
def test_fetch_rows_backward_is_its_transpose(runs, world):
    """``fetch_rows`` over 2, 3 and 4 ranks (an 11-row tensor, uneven
    shards), float64: the rows each rank asks for (its own with 5 rows
    above, wider than a shard, and 2 below; a far window; nothing) equal
    slices of the whole tensor, zero or clamped off its edges, and
    ⟨F x, g⟩ = ⟨x, Fᵀ g⟩ summed over the ranks to 1e-13 relative: the
    backward is the forward's transpose (one exchange each way)."""
    for r, res in enumerate(runs[3][world]):
        for name, v in res.items():
            if name.startswith(("k1", "tail")):
                continue
            assert v["forward_error"] == 0.0, (world, r, name)
            a, b = v["dots"]
            assert abs(a - b) <= 1e-13 * max(abs(a), 1.0), (world, r, name, a, b)


@pytest.mark.parametrize("world", [2, 3, 4])
def test_label_step_halo_and_crop_equals_whole_logits(runs, world):
    """The label step's K1 path under a space split: each rank runs the
    kernel (its plain version here) on the logits rows its label rows need,
    clamped at the image's edges, keeps its rows, and the gathered labels
    equal K1 on the whole logits, at ×2 and ×4, over uneven shards of 7
    logits rows."""
    for res in runs[3][world]:
        assert res["k1_x2"] and res["k1_x4"]


@pytest.mark.parametrize("world", [2, 3, 4])
def test_fused_tail_rows_equal_the_whole_tail(runs, world):
    """``fused_tail`` under a space split (``ops/parity_tail.py``): each
    rank's sites of h = 7 and h = 3 logits rows on a row window with a
    fetched, edge-clamped context row each side and its sites' label rows
    (⌈2h/S⌉ odd at 2 and 3 ranks; no site on a rank of h = 3 at 4): the
    ranks' loss shares sum to the whole map's loss to 1e-12 relative,
    their matrices to its matrix, and the gathered gradients equal its
    gradient to 1e-12 of their largest, float64."""
    for res in runs[3][world]:
        for h in (7, 3):
            t = res[f"tail_h{h}"]
            assert t["loss_rel"] <= 1e-12 and t["cm_equal"] and t["grad_rel"] <= 1e-12, (world, h, t)


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_remat_recomputes_the_backbone_exchanges(runs, grid):
    """``remat`` under a space split: the ranks' state after the steps
    equals the unrematerialised ``tiny_train``'s to 1e-12, and each rank
    made more exchanges (the backbone's forward fetches again in the
    backward's recompute, on every rank alike, ranks with no rows of the
    os-16 map included)."""
    remat, plain = runs[0][("remat_train", grid)], runs[0][("tiny_train", grid)]
    for k, v in plain[0]["state"].items():
        if v.is_floating_point():
            assert float((remat[0]["state"][k] - v).abs().max()) <= 1e-12, (grid, k)
    for r, p in zip(remat, plain):
        assert r["exchanges"]["exchanges"] > p["exchanges"]["exchanges"], (grid, r["exchanges"])


def test_rows_of_uneven_and_empty_splits():
    """⌈H/S⌉ rows a position in order, the last shorter or empty; the
    positions partition [0, H)."""
    assert [mesh.rows_of(7, 2, s) for s in range(2)] == [(0, 4), (4, 7)]
    assert [mesh.rows_of(2, 4, s) for s in range(4)] == [(0, 1), (1, 2), (2, 2), (2, 2)]
    assert [mesh.rows_of(9, 4, s) for s in range(4)] == [(0, 3), (3, 6), (6, 9), (9, 9)]
    assert mesh.rows_of(0, 3, 1) == (0, 0)
    for H in range(0, 40):
        for S in (1, 2, 3, 4, 8):
            spans = [mesh.rows_of(H, S, s) for s in range(S)]
            assert spans[0][0] == 0 and spans[-1][1] == H
            assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
            assert all(lo <= hi for lo, hi in spans)


# (H, k, stride, dilation, C): stride 1 up to dilation 18, stride 2 at odd
# and even heights, k 3/5/7
WINDOW_SITES = [(17, 3, 1, 1, 8), (33, 3, 1, 18, 8), (12, 3, 1, 6, 5), (19, 5, 1, 1, 8),
                (16, 3, 2, 1, 16), (17, 3, 2, 1, 4), (253, 3, 2, 1, 8), (20, 5, 2, 1, 8),
                (21, 7, 2, 1, 8)]


@pytest.mark.parametrize("site", WINDOW_SITES, ids=lambda s: "H{}k{}s{}d{}".format(*s))
def test_depthwise_row_windows_equal_unsharded_plain(site):
    """K2–K5's window mode (output rows Ho and the padding rows above the
    given rows, pad_t): for the output rows of each shard of 2 and 3 (and
    an interior band), the window's plain forward and backward equal the
    unsharded plain versions' rows, and the kernels' emulations (their
    tiles and walks by ``_fwd_plan``/``_bwd_plan`` of the window) equal the
    window's plain versions, float64."""
    H, k, s, d, C = site
    gen = torch.Generator().manual_seed(H + k)
    x = torch.randn(2, C, H, 9, generator=gen, dtype=torch.float64)
    w = torch.randn(C, 1, k, k, generator=gen, dtype=torch.float64)
    full = dw.depthwise_conv_plain(x, w, s, (d, d))
    Ho, pt, _ = dw.same_pads(H, k, s, d)
    spans = [mesh.rows_of(Ho, S, q) for S in (2, 3) for q in range(S)] + [(1, Ho - 1)]
    for o0, o1 in spans:
        lo, hi = o0 * s - pt, (o1 - 1) * s - pt + d * (k - 1) + 1
        c0, c1 = max(lo, 0), min(hi, H)
        xw = x[:, :, c0:c1].contiguous(memory_format=torch.channels_last)
        win = (o1 - o0, c0 - lo)
        y = dw.depthwise_conv_plain(xw, w, s, (d, d), window=win)
        torch.testing.assert_close(y, full[:, :, o0:o1], rtol=0, atol=1e-12)
        g = torch.randn(y.shape, generator=gen, dtype=torch.float64).contiguous(
            memory_format=torch.channels_last)
        dx, dk = dw.depthwise_conv_backward_plain(xw, w, g, s, (d, d), window=win)
        gf = torch.zeros_like(full)
        gf[:, :, o0:o1] = g
        dxf, dkf = dw.depthwise_conv_backward_plain(x, w, gf, s, (d, d))
        torch.testing.assert_close(dx, dxf[:, :, c0:c1], rtol=0, atol=1e-12)
        torch.testing.assert_close(dk, dkf, rtol=0, atol=1e-11)
        plan = dw._fwd_plan(2, C, c1 - c0, 9, k, s, (d, d), torch.float32, 16, win)
        torch.testing.assert_close(dw.depthwise_conv_tiled_emulation(xw, w, s, (d, d), plan), y,
                                   rtol=0, atol=1e-12)
        bplan = dw._bwd_plan(2, C, c1 - c0, 9, k, s, (d, d), torch.float32, 16, win)
        edx, edk = dw.depthwise_conv_backward_tiled_emulation(xw, w, g, s, (d, d), bplan)
        torch.testing.assert_close(edx, dx, rtol=0, atol=1e-12)
        torch.testing.assert_close(edk, dk, rtol=0, atol=1e-11)


@pytest.mark.parametrize("k", [3])
def test_channels_first_row_window_equals_unsharded(k):
    """Under ``DLV3_DW_LAYOUT=bhcw`` a 3×3 stride-1 window takes the
    symmetric one-row halo, zero-padded at the image's edges, runs K6/K7's
    route (its plain version here) and crops: forward and backward equal
    the unsharded rows, float64."""
    import os

    gen = torch.Generator().manual_seed(1)
    H, C = 13, 6
    x = torch.randn(2, C, H, 7, generator=gen, dtype=torch.float64)
    w = torch.randn(C, 1, k, k, generator=gen, dtype=torch.float64)
    old = os.environ.get("DLV3_DW_LAYOUT")
    os.environ["DLV3_DW_LAYOUT"] = "bhcw"
    try:
        full = dw.depthwise_conv_plain(x, w)
        for o0, o1 in [mesh.rows_of(H, 3, q) for q in range(3)]:
            lo, hi = o0 - 1, o1 + 1
            c0, c1 = max(lo, 0), min(hi, H)
            xw = x[:, :, c0:c1].contiguous(memory_format=torch.channels_last).requires_grad_()
            y = dw.depthwise_conv(xw, w, 1, (1, 1), window=(o1 - o0, c0 - lo))
            torch.testing.assert_close(y, full[:, :, o0:o1], rtol=0, atol=1e-12)
            g = torch.randn(y.shape, generator=gen, dtype=torch.float64)
            dx, dk = dw.depthwise_conv_backward(xw.detach(), w, g, 1, (1, 1),
                                                window=(o1 - o0, c0 - lo))
            (ax,) = torch.autograd.grad(y, xw, g)
            rdx, rdk = dw.depthwise_conv_backward_plain(xw.detach(), w, g, window=(o1 - o0, c0 - lo))
            torch.testing.assert_close(dx, rdx, rtol=0, atol=1e-12)
            torch.testing.assert_close(ax, rdx, rtol=0, atol=1e-12)
            torch.testing.assert_close(dk, rdk, rtol=0, atol=1e-12)
    finally:
        if old is None:
            os.environ.pop("DLV3_DW_LAYOUT")
        else:
            os.environ["DLV3_DW_LAYOUT"] = old
