"""The extra key ``remat`` on the port: the backbone's activations are
recomputed in the backward pass (``torch.utils.checkpoint``), which changes
memory and operations, never the result (mirrors tests/test_remat.py).

On the CPU every operation is deterministic, so a step with remat equals
the step without it bit for bit: loss, confusion matrix, gradients,
updated parameters, Adam moments and BN running statistics.  The recompute
runs the backbone's BatchNorms a second time; they must not move their
running statistics again (flax's ``nn.remat`` has no such effect).  Against
the JAX package: the float64 remat step, loss to 5e-8 relative as in
tests/test_torch_train.py.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplabv3plus_keras_tpu.config import Config as JaxConfig
from deeplabv3plus_keras_tpu.parallel import step as jax_step
from deeplabv3plus_keras_tpu_torch import SemanticSegmentation
from deeplabv3plus_keras_tpu_torch.config import Config
from deeplabv3plus_keras_tpu_torch.models.blocks import BatchNorm, running_stats_frozen
from deeplabv3plus_keras_tpu_torch.parallel import step as port_step

from torch_helpers import conf_dict, jax_model_and_traced_variables, port_model

torch.set_num_threads(1)


def _conf(remat, dtype="float32", **extra):
    conf = conf_dict(32, remat=remat, **extra)
    conf["hps"].update(dtype=dtype, lr=1e-3, decay=0.0)
    conf["nn_arch"]["dropout_rate"] = 0.5  # dropout stays outside the recompute
    return conf


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"image": torch.from_numpy(rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)),
            "label": torch.from_numpy(rng.integers(0, 21, (2, 32, 32))),
            "valid": torch.ones(2, dtype=torch.int32)}


def _train(conf, v, steps=2):
    model = port_model(conf, v)
    pconf = Config.from_dict(conf)
    opt = port_step.create_train_state(pconf, model)
    step = port_step.build_train_step(model, opt, pconf, seed=7)
    outs = [step(_batch(i)) for i in range(steps)]
    return model, opt, outs


@pytest.mark.parametrize("dtype,extra", [("float32", {}), ("bfloat16", {}),
                                         ("float32", {"grad_accum": 2})])
def test_remat_step_equals_the_plain_step(dtype, extra):
    """Two steps (dropout drawn, BN in training mode), bit for bit."""
    _, v = jax_model_and_traced_variables(_conf(False), seed=3)
    plain, plain_opt, plain_out = _train(_conf(False, dtype, **extra), v)
    remat, remat_opt, remat_out = _train(_conf(True, dtype, **extra), v)
    assert remat.remat and not plain.remat
    for a, b in zip(plain_out, remat_out):
        assert torch.equal(a["loss"], b["loss"]) and torch.equal(a["cm"], b["cm"])
    for (name, p), q in zip(plain.named_parameters(), remat.parameters()):
        assert torch.equal(p.grad, q.grad), name
        assert torch.equal(p, q), name
    for (name, a), b in zip(plain.named_buffers(), remat.buffers()):
        assert torch.equal(a, b), name
    for a, b in zip(plain_opt.m + plain_opt.v, remat_opt.m + remat_opt.v):
        assert torch.equal(a, b)


def test_remat_moves_running_statistics_once_a_step():
    """With remat the backbone's forward runs twice a step (the recompute);
    its BatchNorms move their running statistics once, by the first
    forward: m·old + (1 − m)·batch, as without remat."""
    conf = _conf(True)
    conf["nn_arch"]["dropout_rate"] = 0.0
    _, v = jax_model_and_traced_variables(conf, seed=4)
    model = port_model(conf, v)
    calls = []
    forward = model.base.forward

    def counted(x, generator):  # the recompute calls the module's forward again
        calls.append(1)
        return forward(x, generator)

    model.base.forward = counted
    bn = model.base.bn_Conv1
    before = bn.running_mean.clone()
    batch = {}

    def keep_stem(mod, args, out):
        batch.setdefault("x", args[0].detach().clone())

    hook = bn.register_forward_hook(keep_stem)
    pconf = Config.from_dict(conf)
    port_step.build_train_step(model, port_step.create_train_state(pconf, model), pconf)(_batch())
    hook.remove()
    assert len(calls) == 2  # the forward and the recompute
    m = bn.momentum
    expect = m * before + (1 - m) * batch["x"].mean((0, 2, 3))
    torch.testing.assert_close(bn.running_mean, expect, rtol=0, atol=1e-6)

    # the guard itself: a training forward under running_stats_frozen()
    # normalises with the batch statistics and leaves every BN alone
    bns = [b for b in model.modules() if isinstance(b, BatchNorm)]
    stats = [(b.running_mean.clone(), b.running_var.clone()) for b in bns]
    model.train()
    x = _batch(1)["image"]
    frozen_model = copy.deepcopy(model)
    with torch.no_grad():
        free = model(x, generator=torch.Generator().manual_seed(0))
        with running_stats_frozen():
            frozen = frozen_model(x, generator=torch.Generator().manual_seed(0))
    assert torch.equal(free, frozen)
    for b, (mean, var) in zip((b for b in frozen_model.modules() if isinstance(b, BatchNorm)),
                              stats):
        assert torch.equal(b.running_mean, mean) and torch.equal(b.running_var, var)
    assert any(not torch.equal(b.running_mean, mean) for b, (mean, _) in zip(bns, stats))


def test_remat_only_in_training():
    """Eval (and inference mode) runs the backbone once, no checkpoint; the
    facade takes the key."""
    seg = SemanticSegmentation(_conf(True), device="cpu")
    assert seg.model.remat
    calls = []
    seg.model.base.register_forward_hook(lambda *a: calls.append(1))
    seg.segment(np.zeros((1, 32, 32, 3), np.float32))
    assert len(calls) == 1


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def test_remat_step_matches_jax_remat_fp64(x64):
    """The port's remat step against the JAX package's (``nn.remat``), float64."""
    conf = _conf(True, "float64")
    conf["nn_arch"]["dropout_rate"] = 0.0
    jm, v = jax_model_and_traced_variables(conf, seed=5)
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v)
    pm = port_model(conf, v).double()
    jconf, pconf = JaxConfig.from_dict(conf), Config.from_dict(conf)
    jstate, tx = jax_step.create_train_state(jconf, jax.tree_util.tree_map(jnp.asarray, v))
    jtrain = jax.jit(jax_step.build_train_step(jm, tx, jconf))
    ptrain = port_step.build_train_step(pm, port_step.create_train_state(pconf, pm), pconf)
    b = _batch()
    eye = np.eye(21)
    jstate, jout = jtrain(jstate, {"image": jnp.asarray(b["image"].numpy(), jnp.float64),
                                   "label": jnp.asarray(eye[b["label"].numpy()]),
                                   "valid": jnp.ones(2, jnp.int32)}, jax.random.PRNGKey(3))
    pout = ptrain({"image": b["image"].double(),
                   "label": torch.from_numpy(eye[b["label"].numpy()]), "valid": b["valid"]})
    jl, pl = float(jout["loss"]), float(pout["loss"])
    assert abs(pl - jl) <= 5e-8 * abs(jl), (pl, jl)
    np.testing.assert_array_equal(pout["cm"].numpy(), np.asarray(jout["cm"]))
