"""Spatial sharding (``mesh_space``) of the backbones other than
MobileNetV2 and Xception, and of ``int8_infer``: ranks of a gloo process
group on the CPU against the port's one process, whose numbers
tests/test_torch_backbones_parity.py, tests/test_torch_backbones_train.py
and tests/test_torch_int8.py hold to the JAX package.

- One float64 train step each of DenseNet-121, EfficientNet-B0 (stochastic
  depth on: every rank of a space group keeps the same samples) at 64²
  and NASNet-Mobile at 48² (where ranks start at odd rows of its strided
  adjustments), B = 4, and NASNet-Mobile's eval step, on the grids
  (1, 2), (2, 2) and (1, 4): losses to 1e-12 relative, parameters, BN
  statistics and probabilities to 1e-12, confusion matrices equal
  (tests/test_torch_spatial.py's bounds); the eval step also against the
  JAX package's ``shard_step(..., spatial=True)`` on a (1, 2) mesh to
  1e-10 of each tensor's scale.
- ``int8_infer`` on the flagship and on Xception, float64, with
  ``MAX_QUANT_PIXELS`` between a site's shard pixels and its image pixels
  (``torch_spatial_workers.INT8_MAX_PIXELS``), so that a gate on the
  shard's shape would quantize sites one process keeps in float: the
  calibrated ranges to 1e-12, the sites that ran int8 equal by name and
  calls, the eval step's loss, matrix and probabilities as above, the
  label step's labels equal at every pixel.
- The facade, ``SemanticSegmentation(conf, device="cpu")`` with
  ``mesh_space`` 2 over two ranks, float32 at 32²: ``train_step()``,
  ``eval_step()`` and ``segment()`` of the three backbones, and
  ``segment()`` and the int8 eval step of the flagship and Xception under
  ``int8_infer``, against one process: losses to 1e-5 relative, matrices
  and labels equal, the int8 sites equal and their ranges to 1e-6
  relative.

One spawn of 2 ranks and one of 4 carry the cases, beside the one
process; the facade's spawn of 2 ranks comes after them, beside its one
process, so that at most 7 processes of this file compute at once.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import torch_spatial_workers as workers
from deeplabv3plus_keras_tpu_torch.parallel import launch
from test_torch_spatial import check_jax, check_one_process, check_ranks_agree, spatial_runs

CASES = list(workers.BACKBONE_CASES)
INT8_CASES = [c for c in CASES if workers.CASES[c][1] == "int8"]
GRIDS = [g for grids in workers.GRIDS.values() for g in grids]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spatial_backbones")
    out = spatial_runs(tmp, CASES, units=False)
    with ThreadPoolExecutor(1) as pool:
        facade = pool.submit(launch.spawn, workers.facade_backbones_worker, 2, (str(tmp),),
                             devices=["cpu"] * 2, timeout_s=300, group_timeout_s=120)
        one = workers.facade_backbones(None)
        facade.result()
    import torch

    ranks = [torch.load(tmp / f"facade_backbones_r{r}.pt", weights_only=False) for r in (0, 1)]
    return out, one, ranks


def _params(cases):
    return [pytest.param(c, g, id=f"{c}-{g[0]}x{g[1]}") for c in cases for g in GRIDS]


@pytest.mark.parametrize("case,grid", _params(CASES))
def test_backbone_ranks_equal_one_process(runs, case, grid):
    """float64: every rank's train-step loss, matrix, parameters and BN
    statistics (the backbones) or eval loss, matrix and probabilities
    (int8) against one process."""
    check_one_process(runs[0], case, grid)


@pytest.mark.parametrize("case,grid", _params(CASES))
def test_backbone_ranks_agree_and_exchange_alike(runs, case, grid):
    """Every rank ends with the same state and losses bit for bit and made
    as many exchanges as every other, ranks with no rows of a map
    included."""
    check_ranks_agree(runs[0], case, grid)


def test_nasnet_eval_ranks_equal_jax_spatial_mesh(runs):
    """float64: NASNet-Mobile's eval step on two ranks against the JAX
    step sharded with ``spatial=True`` over a (1, 2) mesh: loss and
    probabilities to 1e-10 of their scale."""
    check_jax(runs[0], "nasnet_eval")


@pytest.mark.parametrize("case,grid", _params(INT8_CASES))
def test_int8_ranks_quantize_the_sites_one_process_does(runs, case, grid):
    """int8 under a space split: each rank's calibrated ranges equal one
    process's to 1e-12 relative (the maximum over the ranks' rows is the
    image's), the same sites ran int8 as many times, by name, on every
    rank (the gate reads the image's pixels, not the shard's), some site
    stayed float that a shard-shape gate would have quantized, and the
    label step's whole labels equal one process's at every pixel."""
    rs, one = runs[0][0][(case, grid)], runs[0][1][case]
    assert one["sites"] and set(one["sites"]) <= set(one["ranges"])
    for r in rs:
        assert r["sites"] == one["sites"], (case, grid)
        assert sorted(r["ranges"]) == sorted(one["ranges"]), (case, grid)
        for name, v in one["ranges"].items():
            assert v > 0 and abs(r["ranges"][name] - v) <= 1e-12 * v, (case, grid, name)
        np.testing.assert_array_equal(r["labels"], one["labels"])
        assert r["shard_gate_only"] and not set(r["shard_gate_only"]) & set(r["sites"]), (
            case, grid, r["shard_gate_only"])


@pytest.mark.parametrize("name", workers.FACADE_BACKBONES)
def test_facade_over_a_space_split(runs, name):
    """``SemanticSegmentation`` with ``mesh_space`` 2 over two ranks,
    float32: the backbones train (the step's loss and matrix), evaluate
    and segment; ``int8_infer`` segments (calibrating on its images) and
    evaluates at the sites one process quantizes; both ranks against one
    process."""
    _, one, ranks = runs
    want = one[name]
    for r in ranks:
        got = r[name]
        for k in ("train_loss", "eval_loss"):
            if k in want:
                assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), (name, k, got[k], want[k])
        for k in ("train_cm", "eval_cm", "labels"):
            if k in want:
                np.testing.assert_array_equal(got[k], want[k])
        if "sites" in want:
            assert want["sites"] and got["sites"] == want["sites"], name
            for s, v in want["ranges"].items():
                assert abs(got["ranges"][s] - v) <= 1e-6 * v, (name, s)
