"""The port trains the learnable synthetic task as the JAX package does.

The port's counterpart of tests/test_accuracy_parity.py (the JAX package
against tf.keras): the same recipe, with the port in the place of tf.keras.
Both sides start from the same initial weights (in the slow test the JAX
package's own, ``init_model(conf, PRNGKey(k))``, which the port gets
through ``utils/jax_weights.load_jax_variables``), take the same batches of the task
of tests/synthetic_task.py (pixel class a function of pixel colour) and are
scored by the same batch-statistics eval on one held-out set.  The
configuration is tests/test_full_model_parity.py's (``torch_helpers.
accuracy_conf_dict``: 96², MobileNetV2, output stride 16, boundary
refinement, widths 32, the three-op middle, BN momentum 0.9, weight decay
4e-5), trained with dropout 0, lr 1e-3, no decay, B = 4, one-hot labels.

Batch-statistics eval (the JAX suite's docstring measures why): a
train-mode forward and an argmax.  The JAX side discards its mutated
``batch_stats``; the port restores every BatchNorm's running statistics
(``torch_helpers.batch_stats_probs``).

- ``test_trained_accuracy_matches_jax`` (slow): K seeds × N steps (knobs
  ``DLV3_TORCH_ACC_PARITY_SEEDS``/``_STEPS``, default 3 × 250), each seed's
  score the mean of 5 evals 25 steps apart ending at the last step; the
  across-seed means must both reach 0.15 (3× chance) and lie within 0.05
  of each other, the JAX suite's band (float32 β₁ = 0.5 Adam is chaotic, so
  the two trajectories part after a few dozen steps and only the outcome
  can agree).  Measured on an 8-core CPU, 3 × 250 steps (6 min): port
  0.1946, JAX 0.1914 (|Δ| 0.0032); per seed port 0.1824 / 0.2020 / 0.1993,
  JAX 0.2042 / 0.1898 / 0.1801 (JAX's seed 0 checkpoints are those that
  tests/test_bf16_quality.py's docstring gives for its float32 arm).
- ``test_synthetic_trajectory_matches_jax_fp64`` (parity, so tier-1): the
  same recipe in float64 for ``DLV3_TORCH_TRAJ_STEPS`` (default 10) steps.
  Every step's loss lies within 5e-8 relative of JAX's, the JAX package's
  own 10-step bound against tf.keras (tests/test_trajectory_parity.py);
  then one batch-statistics eval of the held-out set, whose confusion
  matrices must be equal outside the pixels whose top two probabilities
  lie within 1e-9 of each other (measured: none, matrices equal), and
  which must leave the port's weights and running statistics as they
  were.  It runs at 32², not 96² or 64²: XLA's CPU convolutions in
  float64 are slow (one float64 JAX step of this configuration takes 24 s
  on one core at 96², 8.9 s at 64², 1.2 s at 32²; the JAX train step's
  compile ~20 s at any side), and the file takes ~48 s on one core.  Its
  weights are seed 0's of the port's ``init_weights``, handed to JAX by
  ``export_jax_variables``: JAX's own init would add its compile (11 s on
  one core).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplabv3plus_keras_tpu.config import Config as JaxConfig
from deeplabv3plus_keras_tpu.models import init_model
from deeplabv3plus_keras_tpu.models.deeplab import create_model
from deeplabv3plus_keras_tpu.parallel import step as jax_step
from deeplabv3plus_keras_tpu_torch.config import Config
from deeplabv3plus_keras_tpu_torch.models import DeepLabV3Plus
from deeplabv3plus_keras_tpu_torch.parallel import step as port_step
from deeplabv3plus_keras_tpu_torch.utils.jax_weights import export_jax_variables, load_jax_variables

from synthetic_task import checkpoint_steps, make_batch, miou, np_cm
from torch_helpers import accuracy_conf_dict, batch_stats_probs

torch.set_num_threads(1)

N_STEPS = int(os.environ.get("DLV3_TORCH_ACC_PARITY_STEPS", "250"))
N_SEEDS = int(os.environ.get("DLV3_TORCH_ACC_PARITY_SEEDS", "3"))
TRAJ_STEPS = int(os.environ.get("DLV3_TORCH_TRAJ_STEPS", "10"))
BATCH, SIZE, CLASSES = 4, 96, 21
TRAJ_SIZE = 32  # the float64 trajectory's side: see the module docstring
N_EVAL_BATCHES = 4
N_CHECKPOINTS, EVAL_EVERY = 5, 25
BAND = 0.05
TIE = 1e-9  # top-two probability gap under which float64 argmaxes may differ


def eval_set(size: int = SIZE):
    """The held-out set of tests/test_accuracy_parity.py (at ``size``)."""
    return [make_batch(np.random.default_rng(1000 + i), BATCH, size)
            for i in range(N_EVAL_BATCHES)]


def data_stream(seed: int):
    """Seed ``seed``'s training batches, as tests/test_accuracy_parity.py draws them."""
    return np.random.default_rng(11 + 1000 * seed)


class Pair:
    """The JAX package's train step and the port's, from the same weights
    ``variables``, in ``dtype`` (float32 or float64)."""

    def __init__(self, variables, dtype: str, size: int = SIZE):
        conf = accuracy_conf_dict(dtype, size)
        self.np_dtype = np.dtype(dtype)
        variables = jax.tree_util.tree_map(lambda a: np.asarray(a, self.np_dtype), variables)
        jconf, pconf = JaxConfig.from_dict(conf), Config.from_dict(conf)
        self.jmodel = create_model(jconf)
        self.jstate, tx = jax_step.create_train_state(
            jconf, jax.tree_util.tree_map(jnp.asarray, variables))
        self.jtrain = jax.jit(jax_step.build_train_step(self.jmodel, tx, jconf))
        self.jprobs = jax.jit(lambda v, x: self.jmodel.apply(
            v, x, train=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(0)})[0])
        pm = DeepLabV3Plus(pconf)
        load_jax_variables(pm, variables)
        self.pmodel = pm.to(getattr(torch, dtype)).to(memory_format=torch.channels_last)
        self.ptrain = port_step.build_train_step(
            self.pmodel, port_step.create_train_state(pconf, self.pmodel), pconf)
        self.eye = np.eye(CLASSES, dtype=self.np_dtype)

    def step(self, x, lab):
        """One step of each side on one batch: (JAX loss, port loss)."""
        x, y = x.astype(self.np_dtype), self.eye[lab]
        valid = np.ones(BATCH, np.int32)
        self.jstate, jout = self.jtrain(
            self.jstate, {"image": jnp.asarray(x), "label": jnp.asarray(y),
                          "valid": jnp.asarray(valid)}, jax.random.PRNGKey(3))
        pout = self.ptrain({"image": torch.from_numpy(x), "label": torch.from_numpy(y),
                            "valid": torch.from_numpy(valid)})
        return float(jout["loss"]), float(pout["loss"])

    def probs(self, x):
        """Batch-statistics probabilities of each side: (JAX, port)."""
        x = x.astype(self.np_dtype)
        jv = {"params": self.jstate.params, "batch_stats": self.jstate.batch_stats}
        return (np.asarray(self.jprobs(jv, jnp.asarray(x))),
                batch_stats_probs(self.pmodel, torch.from_numpy(x)).numpy())

    def mious(self, held_out):
        cms = [np.zeros((CLASSES, CLASSES), np.int64) for _ in range(2)]
        for x, lab in held_out:
            for cm, p in zip(cms, self.probs(x)):
                cm += np_cm(lab, p.argmax(-1))
        return miou(cms[0]), miou(cms[1])


@pytest.mark.slow
def test_trained_accuracy_matches_jax():
    held_out = eval_set()
    eval_at = checkpoint_steps(N_STEPS, N_CHECKPOINTS, EVAL_EVERY)
    per_seed = {"jax": [], "port": []}
    for seed in range(N_SEEDS):
        _, variables = init_model(JaxConfig.from_dict(accuracy_conf_dict()),
                                  jax.random.PRNGKey(seed))
        pair = Pair(jax.device_get(variables), "float32")
        rng = data_stream(seed)
        marks = {"jax": [], "port": []}
        for i in range(N_STEPS):
            losses = pair.step(*make_batch(rng, BATCH, SIZE))
            assert np.isfinite(losses).all(), (seed, i, losses)
            if i in eval_at:
                for side, m in zip(("jax", "port"), pair.mious(held_out)):
                    marks[side].append(m)
        for side in marks:
            per_seed[side].append(float(np.mean(marks[side])))
        print(f"seed {seed}: port {per_seed['port'][-1]:.4f} {np.round(marks['port'], 3)} "
              f"jax {per_seed['jax'][-1]:.4f} {np.round(marks['jax'], 3)}", flush=True)
    m_port, m_jax = float(np.mean(per_seed["port"])), float(np.mean(per_seed["jax"]))
    print(f"port {m_port:.4f} jax {m_jax:.4f} |delta| {abs(m_port - m_jax):.4f}", flush=True)
    assert m_port >= 0.15, per_seed
    assert m_jax >= 0.15, per_seed
    assert abs(m_port - m_jax) <= BAND, per_seed


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.mark.parity
def test_synthetic_trajectory_matches_jax_fp64(x64):
    conf = Config.from_dict(accuracy_conf_dict("float64", TRAJ_SIZE))
    drawn = DeepLabV3Plus(conf)
    drawn.init_weights(torch.Generator().manual_seed(0))
    pair = Pair(export_jax_variables(drawn), "float64", TRAJ_SIZE)
    rng = data_stream(0)
    for i in range(TRAJ_STEPS):
        jl, pl = pair.step(*make_batch(rng, BATCH, TRAJ_SIZE))
        assert abs(pl - jl) <= 5e-8 * abs(jl), (i, pl, jl)

    before = {k: v.clone() for k, v in pair.pmodel.state_dict().items()}
    cms = [np.zeros((CLASSES, CLASSES), np.int64) for _ in range(2)]
    ties = differ = 0
    for x, lab in eval_set(TRAJ_SIZE):
        jp, pp = pair.probs(x)
        top2 = np.sort(jp, -1)[..., -2:]
        clear = top2[..., 1] - top2[..., 0] > TIE
        ties += int((~clear).sum())
        jl, pl = jp.argmax(-1), pp.argmax(-1)
        differ += int((jl != pl).sum())
        for cm, pred in zip(cms, (jl, pl)):
            cm += np_cm(lab[clear], pred[clear])
    print(f"near-tie pixels {ties}, labels differing {differ}", flush=True)
    np.testing.assert_array_equal(cms[1], cms[0])
    assert differ <= ties, (differ, ties)
    assert cms[0].sum() + ties == N_EVAL_BATCHES * BATCH * TRAJ_SIZE**2
    for k, v in pair.pmodel.state_dict().items():
        assert torch.equal(v, before[k]), f"the eval moved {k}"
