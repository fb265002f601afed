"""The port's train step over two ranks of a gloo process group on the CPU,
against one process and against the JAX package's step on a 2-device mesh.

The two ranks run every case of ``torch_ddp_workers.STEP_CASES`` in one
spawned pair (``parallel.launch.spawn``, with a deadline: a broken
collective fails these tests instead of hanging the suite); each rank takes
its rows of the same global batches of 8 (the JAX package's own sharding
test's batch, tests/test_sharding.py), the second of them ragged.

Tolerances:

- float64 (Keras Adam, lr 1e-4): two ranks against one process, losses to
  1e-12 relative and every parameter and BN statistic to 1e-12 absolute,
  over 3 steps.  Measured: ≤ 2.5e-13.  The one process alone moves by
  2.4e-13 between 1 and 4 CPU threads (the summation order of its
  reductions), so this is rounding.  At B = 4 under grad_accum 2 a
  microbatch holds one sample a rank, and BN over the 2×2 ASPP maps
  amplifies that rounding to 2.3e-12 (measured): hence B = 8.
- against the JAX step sharded over ``make_mesh(n_data=2)`` with
  ``jax_enable_x64``: losses, parameters and BN statistics to 1e-10
  relative to each tensor's scale (the port's one-process step holds 5e-8
  on the loss and 1e-10 on the statistics against JAX, tests/
  test_torch_train.py).
- bfloat16: one step, the bounds tests/test_torch_dtype.py holds the port
  to against JAX in bfloat16 (loss 1e-3 relative, BN statistics 3e-2 in
  norm, each update within 2·lr, 60 % of the updates' signs agreeing).
- across ranks: bit for bit, every parameter and every BN statistic.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_ddp_workers as workers
from deeplabv3plus_keras_tpu.config import Config as JaxConfig
from deeplabv3plus_keras_tpu.parallel import build_train_step as jax_build_train_step
from deeplabv3plus_keras_tpu.parallel import create_train_state as jax_create_train_state
from deeplabv3plus_keras_tpu.parallel import make_mesh, shard_step
from deeplabv3plus_keras_tpu_torch.parallel import launch, mesh
from deeplabv3plus_keras_tpu_torch.utils.jax_weights import export_jax_variables
from torch_helpers import jax_model_and_traced_variables, port_model

torch.set_num_threads(1)
CASES = list(workers.STEP_CASES)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(rank 0's, rank 1's, one process's) results of every case, and the
    tiny configuration's JAX model and weights."""
    tmp = tmp_path_factory.mktemp("ddp")
    jm, variables = jax_model_and_traced_variables(workers.tiny_conf(), seed=7)
    torch.save(variables, tmp / "variables.pt")
    with ThreadPoolExecutor(1) as pool:  # the one process's runs meanwhile
        ranks = pool.submit(launch.spawn, workers.step_worker, 2,
                            (str(tmp / "variables.pt"), str(tmp)), devices=["cpu", "cpu"],
                            timeout_s=300, group_timeout_s=120)
        one = {case: workers.run_steps(case, variables) for case in CASES}
        ranks.result()
    out = {case: tuple(torch.load(tmp / f"{case}_r{r}.pt", weights_only=False) for r in (0, 1))
           + (one[case],) for case in CASES}
    return out, jm, variables


@pytest.mark.parametrize("case", ["plain", "grad_accum", "remat", "augment", "fused_tail"])
def test_two_ranks_equal_one_process_fp64(runs, case):
    """float64, 3 steps, the ragged batch included: two ranks' losses,
    confusion matrices, parameters and BN statistics against one
    process's (augment: the flip and scale draws of the global batch,
    sliced; remat: BN's all-reduces issued again by the recompute;
    fused_tail: each rank's share of the parity-decomposed loss over the
    global valid-pixel count)."""
    r0, _, one = runs[0][case]
    for step, (a, b) in enumerate(zip(r0["losses"], one["losses"]), 1):
        assert abs(a - b) <= 1e-12 * abs(b), (case, step, a, b)
    for a, b in zip(r0["cms"], one["cms"]):
        np.testing.assert_array_equal(a, b)
    assert r0["cms"][1].sum() == 5 * workers.SIZE ** 2  # the ragged batch's 5 real samples
    for k, v in one["state"].items():
        if v.is_floating_point():
            assert float((r0["state"][k] - v).abs().max()) <= 1e-12, (case, k)
        else:
            assert torch.equal(r0["state"][k], v), (case, k)


@pytest.mark.parametrize("case", CASES)
def test_ranks_hold_identical_parameters_and_statistics(runs, case):
    """After the steps every parameter, BN statistic and gradient is bit
    for bit the same on both ranks: the statistics come from the same
    all-reduced sums, the gradients from one all-reduce."""
    r0, r1, _ = runs[0][case]
    assert r0["state"].keys() == r1["state"].keys()
    for k in r0["state"]:
        assert torch.equal(r0["state"][k], r1["state"][k]), (case, k)
    for n in r0["grads"]:
        assert torch.equal(r0["grads"][n], r1["grads"][n]), (case, n)
    assert r0["losses"] == r1["losses"]


def test_bfloat16_batchnorm_backward_on_two_ranks(runs):
    """One bfloat16 step: the synchronised 16-bit BN (float32 statistics
    over both ranks' rows, its backward's Σg and Σg·x̂ all-reduced) against
    one process, within test_torch_dtype.py's bounds."""
    r0, _, one = runs[0]["bfloat16"]
    lr = workers.STEP_CASES["bfloat16"][0]["hps"]["lr"]
    assert abs(r0["losses"][0] - one["losses"][0]) <= 1e-3 * one["losses"][0]
    stats = [k for k in one["state"] if k.endswith(("running_mean", "running_var"))]
    ps = torch.cat([r0["state"][k].flatten() for k in stats])
    js = torch.cat([one["state"][k].flatten() for k in stats])
    assert float((ps - js).norm()) <= 3e-2 * float(js.norm())
    model0 = workers.case_model("bfloat16", runs[2])
    p0 = torch.cat([p.detach().flatten() for p in model0.parameters()])
    names = [n for n, _ in model0.named_parameters()]
    d2 = torch.cat([r0["state"][n].flatten() for n in names]) - p0
    d1 = torch.cat([one["state"][n].flatten() for n in names]) - p0
    assert float((d2 - d1).abs().max()) <= 2 * lr * 1.01
    assert float((torch.sign(d2) == torch.sign(d1)).double().mean()) >= 0.6
    assert all(v.dtype == torch.float32 for v in r0["state"].values() if v.is_floating_point())


def test_parameters_the_loss_does_not_reach_take_a_step(runs):
    """NASNet-Mobile's last normal cell feeds nothing after the cut: its
    parameters get zero gradients on both ranks, the gradient all-reduce
    takes them with the rest, and the step equals one process's."""
    r0, r1, one = runs[0]["unreached"]
    zero = [n for n, g in one["grads"].items() if not g.any()]
    assert len(zero) >= 10 and all(not r0["grads"][n].any() for n in zero)
    assert abs(r0["losses"][0] - one["losses"][0]) <= 1e-5 * one["losses"][0]
    for n, g in one["grads"].items():
        assert float((r0["grads"][n] - g).abs().max()) <= 1e-4 * max(float(g.abs().max()), 1e-6), n


def test_two_ranks_equal_jax_two_device_mesh(runs):
    """The plain case's 3 float64 steps against the JAX package's
    ``shard_step`` over ``make_mesh(n_data=2)`` (the 8 virtual CPU
    devices of tests/conftest.py; parameters replicated, the batch sharded,
    flax's BN over the global batch), from the same weights."""
    results, jm, variables = runs
    r0 = results["plain"][0]
    from deeplabv3plus_keras_tpu.kernels import depthwise3

    single = depthwise3._single_device_mesh  # shard_step sets it for the mesh
    jax.config.update("jax_enable_x64", True)
    try:
        conf = workers.tiny_conf()
        jconf = JaxConfig.from_dict(conf)
        v = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, np.float64)), variables)
        state, tx = jax_create_train_state(jconf, v)
        step = shard_step(jax_build_train_step(jm, tx, jconf), make_mesh(n_data=2), kind="train")
        losses = []
        for b in workers.global_batches(3):
            batch = {"image": jnp.asarray(b["image"]),
                     "label": jnp.asarray(b["label"]),
                     "valid": jnp.asarray(b["valid"])}
            state, metrics = step(state, batch, jax.random.PRNGKey(3))
            losses.append(float(metrics["loss"]))
        params = jax.tree_util.tree_map(np.asarray, state.params)
        stats = jax.tree_util.tree_map(np.asarray, state.batch_stats)
    finally:
        jax.config.update("jax_enable_x64", False)
        depthwise3.set_single_device_mesh(single)
    for a, b in zip(r0["losses"], losses):
        assert abs(a - b) <= 1e-10 * abs(b), (a, b)
    model = port_model(conf, variables).to(torch.float64)
    model.load_state_dict(r0["state"])
    got = export_jax_variables(model)
    for tree, ref in ((got["params"], params), (got["batch_stats"], stats)):
        for path, leaf in jax.tree_util.tree_leaves_with_path(ref):
            mine = tree
            for k in path:
                mine = mine[k.key]
            scale = max(float(np.abs(leaf).max()), 1e-12)
            assert float(np.abs(np.asarray(mine) - leaf).max()) <= 1e-10 * scale, path


def test_row_indices_cut_each_microbatch():
    """Rank r's rows: [r·B/N, (r+1)·B/N), or under grad_accum A its slice
    of each of the A microbatches; together the ranks hold each row once."""
    assert mesh.row_indices(8, 2, 1).tolist() == [4, 5, 6, 7]
    assert mesh.row_indices(8, 2, 0, accum=2).tolist() == [0, 1, 4, 5]
    assert mesh.row_indices(8, 2, 1, accum=2).tolist() == [2, 3, 6, 7]
    for world, accum in ((1, 1), (2, 2), (4, 2), (8, 1)):
        rows = np.concatenate([mesh.row_indices(16, world, r, accum) for r in range(world)])
        assert sorted(rows.tolist()) == list(range(16))
    with pytest.raises(ValueError, match="divisible"):
        mesh.row_indices(6, 4)
    with pytest.raises(ValueError, match="grad_accum"):
        mesh.row_indices(8, 2, 0, accum=3)
