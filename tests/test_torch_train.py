"""The port's training path against the JAX package's, on the CPU.

Loss, L2, confusion matrix, Keras Adam, dropout and the train step of the
flagship model, with the same inputs (numpy, from a seed) and the same
weights (``load_jax_variables``) on both sides.  Tolerances:

- float64 (JAX with ``jax_enable_x64``, the port's model in double): pins
  the formulas.  Both sides sum in different orders, so losses agree to
  ~1e-15 and BN statistics to ~1e-12; the bounds are those of the JAX
  package's own trajectory suite (tests/test_trajectory_parity.py: loss
  5e-8) and 1e-10 for the BN statistics.
- float32: β₁ = 0.5 Adam is sign-like per parameter, so one-ulp gradient
  differences flip whole ±lr·α updates and the trajectories drift apart
  chaotically (tests/test_trajectory_parity.py explains the measurement);
  the loss stays within 2e-3 over 3 steps, the bound used there.
- confusion matrices are integer counts: exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from deeplabv3plus_keras_tpu.config import Config as JaxConfig
from deeplabv3plus_keras_tpu.config import HParams as JaxHParams
from deeplabv3plus_keras_tpu.parallel import step as jax_step
from deeplabv3plus_keras_tpu.train import loss as jax_loss
from deeplabv3plus_keras_tpu.train import metrics as jax_metrics
from deeplabv3plus_keras_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from deeplabv3plus_keras_tpu.train.optimizer import set_learning_rate as jax_set_lr
from deeplabv3plus_keras_tpu_torch import SemanticSegmentation
from deeplabv3plus_keras_tpu_torch.config import Config, HParams
from deeplabv3plus_keras_tpu_torch.models.encoder import Dropout
from deeplabv3plus_keras_tpu_torch.parallel import step as port_step
from deeplabv3plus_keras_tpu_torch.train import loss, metrics
from deeplabv3plus_keras_tpu_torch.train.optimizer import KerasAdam, make_optimizer, set_learning_rate
from deeplabv3plus_keras_tpu_torch.utils.jax_weights import export_jax_variables

from torch_helpers import conf_dict, jax_model_and_variables, port_model

torch.set_num_threads(1)


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _probs(rng, shape):
    z = rng.normal(size=shape) * 3
    e = np.exp(z - z.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("valid", [None, (1, 0, 1)])
def test_class_balanced_loss_matches_jax(sparse, valid):
    rng = np.random.default_rng(3)
    probs = _probs(rng, (3, 8, 8, 21))
    labels = rng.integers(0, 21, (3, 8, 8))
    y = labels if sparse else np.eye(21, dtype=np.float32)[labels]
    v = None if valid is None else np.asarray(valid, np.int32)
    jfn = jax_loss.class_balanced_loss_sparse if sparse else jax_loss.class_balanced_loss
    pfn = loss.class_balanced_loss_sparse if sparse else loss.class_balanced_loss
    ref = float(jfn(jnp.asarray(y), jnp.asarray(probs), valid=None if v is None else jnp.asarray(v)))
    got = pfn(torch.from_numpy(y), torch.from_numpy(probs), valid=None if v is None else torch.from_numpy(v))
    assert got.dtype == torch.float32
    assert abs(float(got) - ref) <= 1e-6 * abs(ref)


def test_sparse_and_dense_loss_agree_and_padded_batch_is_zero():
    rng = np.random.default_rng(4)
    probs = torch.from_numpy(_probs(rng, (2, 6, 6, 21))).double()
    labels = torch.from_numpy(rng.integers(0, 21, (2, 6, 6)))
    onehot = torch.nn.functional.one_hot(labels, 21).double()
    torch.testing.assert_close(
        loss.class_balanced_loss(onehot, probs), loss.class_balanced_loss_sparse(labels, probs),
        rtol=1e-12, atol=0)
    assert float(loss.class_balanced_loss(onehot, probs, valid=torch.zeros(2))) == 0.0


def test_l2_penalty_matches_jax():
    conf = conf_dict(32)
    _, v = jax_model_and_variables(conf, seed=5)
    pm = port_model(conf, v)
    ref = float(jax_loss.l2_penalty(jax.tree_util.tree_map(jnp.asarray, v["params"]), 4e-5))
    got = float(loss.l2_penalty(pm, 4e-5).detach())
    assert abs(got - ref) <= 1e-6 * ref
    n_l2 = sum(any("_l2" in p for p in n.split(".")) for n, _ in pm.named_parameters())
    assert n_l2 == 8  # 5 ASPP 1×1 convs, projection, refinement 48, classifier
    assert loss.l2_penalty(pm, 0.0) == 0.0


@pytest.mark.parametrize("sparse", [False, True])
def test_confusion_matrix_matches_jax_exactly(sparse):
    rng = np.random.default_rng(5)
    probs = _probs(rng, (3, 16, 16, 21))
    probs[0, 0, 0, :2] = 0.5  # a tie: both take the first class
    labels = rng.integers(0, 21, (3, 16, 16))
    y = labels if sparse else np.eye(21, dtype=np.float32)[labels]
    for valid in (None, np.array([1, 0, 1], np.int32)):
        jfn = jax_metrics.confusion_matrix_update_sparse if sparse else jax_metrics.confusion_matrix_update
        pfn = metrics.confusion_matrix_update_sparse if sparse else metrics.confusion_matrix_update
        ref = np.asarray(jfn(jnp.asarray(y), jnp.asarray(probs), 21,
                             None if valid is None else jnp.asarray(valid)))
        got = pfn(torch.from_numpy(y), torch.from_numpy(probs), 21,
                  None if valid is None else torch.from_numpy(valid))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)
        assert got.sum() == (3 if valid is None else 2) * 256


def test_mean_iou_matches_jax():
    rng = np.random.default_rng(6)
    cms = [rng.integers(0, 50, (21, 21)).astype(np.int32) for _ in range(3)]
    cms[0][4, :] = cms[0][:, 4] = 0  # a class never seen: skipped in the mean
    ref_m, got_m = jax_metrics.MeanIoU(21), metrics.MeanIoU(21)
    for cm in cms:
        ref_m.update_from_cm(jnp.asarray(cm))
        got_m.update_from_cm(torch.from_numpy(cm))
    assert got_m.result() == pytest.approx(ref_m.result(), rel=1e-12)
    np.testing.assert_array_equal(got_m.total_cm, ref_m.total_cm)
    np.testing.assert_allclose(got_m.per_class_iou(), ref_m.per_class_iou(), rtol=1e-12)
    assert got_m.report().splitlines()[-1] == ref_m.report().splitlines()[-1]
    np.testing.assert_allclose(
        float(metrics.mean_iou_from_cm(torch.from_numpy(cms[0]))),
        float(jax_metrics.mean_iou_from_cm(jnp.asarray(cms[0]))), rtol=1e-6)


@pytest.mark.parametrize("g_mag", [0.5, 1e-6, 1e-8])
def test_keras_adam_matches_jax(g_mag, x64):
    """5 steps in float64 with iteration decay and an LR override after
    step 2; ≤1e-9 per step, the bound the JAX package holds against Keras."""
    hp = dict(lr=0.01, beta_1=0.5, beta_2=float(np.float32(0.99)), decay=0.1)
    tx = jax_make_optimizer(JaxHParams(**hp))
    p = {"w": jnp.array([1.0, 2.0, -3.0], jnp.float64)}
    st = tx.init(p)
    w = torch.tensor([1.0, 2.0, -3.0], dtype=torch.float64, requires_grad=True)
    opt = make_optimizer([w], HParams(**hp))
    rng = np.random.default_rng(7)
    for step in range(5):
        if step == 2:
            st = jax_set_lr(st, 0.005)
            set_learning_rate(opt, 0.005)
        g = g_mag * rng.choice([-1.0, 1.0], 3)
        updates, st = tx.update({"w": jnp.asarray(g)}, st, p)
        p = optax.apply_updates(p, updates)
        w.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(p["w"]), atol=1e-9, rtol=0,
                                   err_msg=f"g={g_mag} step={step}")
    assert opt.iterations == 5


def test_keras_adam_is_not_torch_adam():
    """Where √v ≈ ε the two ε placements differ about 2×: at g = 1e-6
    torch.optim.Adam moves a parameter 0.0091, Keras 0.0050."""
    w1 = torch.zeros(1, dtype=torch.float64, requires_grad=True)
    w2 = torch.zeros(1, dtype=torch.float64, requires_grad=True)
    keras, ref = KerasAdam([w1], 0.01, 0.5, 0.99), torch.optim.Adam([w2], 0.01, (0.5, 0.99), 1e-7)
    for w, opt in ((w1, keras), (w2, ref)):
        w.grad = torch.full((1,), 1e-6, dtype=torch.float64)
        opt.step()
    assert w1.item() == pytest.approx(-0.01 * 0.2 * 5e-7 / (1e-7 + 1e-7), rel=1e-12)
    assert abs(w2.item()) > 1.5 * abs(w1.item())
    with pytest.raises(RuntimeError, match="no gradient"):
        w1.grad = None
        keras.step()


def test_dropout_draws_from_the_given_generator_only():
    d = Dropout(0.25).train()
    x = torch.ones(4, 64, 8, 8)
    g1 = port_step.step_generator(0, 3, "cpu")
    g2 = port_step.step_generator(0, 3, "cpu")
    torch.manual_seed(0)
    a = d(x, g1)
    torch.manual_seed(1)  # the global generator plays no part
    torch.testing.assert_close(a, d(x, g2), rtol=0, atol=0)
    assert not torch.equal(a, d(x, port_step.step_generator(0, 4, "cpu")))
    assert set(a.unique().tolist()) == {0.0, torch.tensor(1.0 / 0.75).item()}
    assert abs((a == 0).float().mean().item() - 0.25) < 0.02
    with pytest.raises(ValueError, match="Generator"):
        d(x)
    assert d.eval()(x) is x


def _train_conf(size, np_dtype, **extra):
    conf = conf_dict(size, **extra)
    conf["hps"].update(dtype=np.dtype(np_dtype).name, lr=1e-4, decay=0.0)
    conf["nn_arch"]["dropout_rate"] = 0.0  # the one stochastic layer; off on both sides
    return conf


def _leaf(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


def _run_both(np_dtype, steps, sparse=False, valid=(1, 1), **extra):
    """Per step: (jax loss, port loss, jax cm, port cm, worst BN-stat rel)."""
    conf = _train_conf(32, np_dtype, **extra)
    jm, v = jax_model_and_variables(conf, seed=7)
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, np_dtype), v)
    pm = port_model(conf, v).to(torch.float64 if np_dtype == np.float64 else torch.float32)
    jconf, pconf = JaxConfig.from_dict(conf), Config.from_dict(conf)
    jstate, tx = jax_step.create_train_state(jconf, jax.tree_util.tree_map(jnp.asarray, v))
    jtrain = jax.jit(jax_step.build_train_step(jm, tx, jconf))
    ptrain = port_step.build_train_step(pm, port_step.create_train_state(pconf, pm), pconf)
    rng = np.random.default_rng(11)
    eye = np.eye(21, dtype=np_dtype)
    out = []
    for _ in range(steps):
        x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np_dtype)
        labels = rng.integers(0, 21, (2, 32, 32))
        y = labels if sparse else eye[labels]
        val = np.asarray(valid, np.int32)
        jstate, jout = jtrain(jstate, {"image": jnp.asarray(x), "label": jnp.asarray(y),
                                       "valid": jnp.asarray(val)}, jax.random.PRNGKey(3))
        pout = ptrain({"image": torch.from_numpy(x), "label": torch.from_numpy(y),
                       "valid": torch.from_numpy(val)})
        stats = export_jax_variables(pm)["batch_stats"]
        worst = max(
            float(np.abs(np.asarray(a) - _leaf(stats, path)).max() / np.abs(np.asarray(a)).max())
            for path, a in jax.tree_util.tree_leaves_with_path(jstate.batch_stats)
        )
        out.append((float(jout["loss"]), float(pout["loss"]), np.asarray(jout["cm"]),
                    pout["cm"].numpy(), worst))
    return out


def test_train_step_matches_jax_fp64(x64):
    for step, (jl, pl, jcm, pcm, bs_rel) in enumerate(_run_both(np.float64, 3), 1):
        assert abs(pl - jl) <= 5e-8 * abs(jl), (step, pl, jl)
        assert bs_rel <= 1e-10, (step, bs_rel)
        np.testing.assert_array_equal(pcm, jcm)


def test_train_step_matches_jax_fp32():
    for step, (jl, pl, _, pcm, _) in enumerate(_run_both(np.float32, 3), 1):
        assert abs(pl - jl) <= 2e-3 * abs(jl), (step, pl, jl)
        assert pcm.sum() == 2 * 32 * 32


def test_grad_accum_sparse_padded_matches_jax():
    """grad_accum 2 over a batch whose second sample is padding, integer
    labels: microbatch BN statistics threaded through, losses averaged,
    confusion matrices summed, one update, as the JAX step's scan.  One
    float32 step (the JAX scan carries a float32 loss, so it takes no
    float64 run): the loss to float32 rounding, 1e-5.  The BN statistics
    to 2e-3: a microbatch of one sample leaves 4 values per channel on the
    ASPP's 2×2 maps, where flax's one-pass float32 variance E[x²] − E[x]²
    loses digits to the mean (measured worst: 8e-4, an ASPP ``var``).
    Those differences can flip the argmax of a pixel whose top two classes
    tie within float32 rounding (measured: 1 of 1024), so the confusion
    matrices agree exactly in their rows (the labels) and to 4 flipped
    pixels in their columns."""
    [(jl, pl, jcm, pcm, bs_rel)] = _run_both(np.float32, 1, sparse=True, valid=(1, 0), grad_accum=2)
    assert abs(pl - jl) <= 1e-5 * abs(jl), (pl, jl)
    assert bs_rel <= 2e-3, bs_rel
    np.testing.assert_array_equal(pcm.sum(1), jcm.sum(1))
    assert np.abs(pcm - jcm).sum() <= 2 * 4
    assert pcm.sum() == 32 * 32  # the padded sample counts nothing


def test_grad_accum_equals_a_manual_loop():
    """The accumulated step on the whole batch equals two single-sample
    forward/backward passes by hand with BN statistics threaded through:
    the same loss, confusion matrix, gradients and update."""
    conf = _train_conf(32, np.float32, grad_accum=2)
    _, v = jax_model_and_variables(conf, seed=8)
    pa, pb = port_model(conf, v), port_model(conf, v)
    pconf = Config.from_dict(conf)
    rng = np.random.default_rng(2)
    batch = {"image": torch.from_numpy(rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)),
             "label": torch.from_numpy(rng.integers(0, 21, (2, 32, 32))),
             "valid": torch.ones(2, dtype=torch.int32)}
    out = port_step.build_train_step(pa, port_step.create_train_state(pconf, pa), pconf)(batch)

    opt = port_step.create_train_state(pconf, pb)
    pb.train()
    losses, cm = [], 0
    for i in range(2):
        probs = pb(batch["image"][i:i + 1])
        l_i = loss.class_balanced_loss_sparse(batch["label"][i:i + 1], probs, valid=batch["valid"][i:i + 1])
        l_i = l_i + loss.l2_penalty(pb, pconf.hps.weight_decay)
        l_i.backward()
        losses.append(l_i.detach())
        cm = cm + metrics.confusion_matrix_update_sparse(batch["label"][i:i + 1], probs.detach(), 21)
    for p in opt.params:
        p.grad /= 2
    grads = [p.grad.clone() for p in opt.params]
    opt.step()
    assert float(out["loss"]) == float((losses[0] + losses[1]) / 2)
    assert torch.equal(out["cm"], cm)
    for (name, p), q, g in zip(pa.named_parameters(), pb.parameters(), grads):
        assert torch.equal(p.grad, g), name
        assert torch.equal(p, q), name
    for (name, a), b in zip(pa.named_buffers(), pb.buffers()):
        assert torch.equal(a, b), name


def test_grad_accum_must_divide_batch():
    raw = _train_conf(32, np.float32, grad_accum=3)
    pm, conf = port_model(raw, jax_model_and_variables(raw)[1]), Config.from_dict(raw)
    step = port_step.build_train_step(pm, port_step.create_train_state(conf, pm), conf)
    with pytest.raises(ValueError, match="grad_accum"):
        step({"image": torch.zeros(2, 32, 32, 3), "label": torch.zeros(2, 32, 32, dtype=torch.long),
              "valid": torch.ones(2)})


def test_facade_trains_evaluates_and_serves():
    """Through the public facade: train steps in train mode, then eval and
    segment() in eval mode on running statistics, then train again."""
    seg = SemanticSegmentation(conf_dict(32), device="cpu")
    rng = np.random.default_rng(9)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    y = np.eye(21, dtype=np.float32)[rng.integers(0, 21, (2, 32, 32))]
    before = {k: t.clone() for k, t in seg.model.state_dict().items()}
    out = seg.train_step({"image": x, "label": y})
    assert np.isfinite(float(out["loss"])) and int(out["cm"].sum()) == 2 * 32 * 32
    assert seg.optimizer.iterations == 1
    after = seg.model.state_dict()
    moved = [k for k in before if not torch.equal(before[k], after[k])]
    assert len(moved) == len(before)  # every weight and BN statistic moved
    assert all(p.grad is not None and p.grad.abs().sum() > 0 for p in seg.model.parameters())
    labels = seg.segment(x)
    assert not seg.model.training and labels.shape == (2, 32, 32)
    ev = seg.eval_step({"image": x, "label": y, "valid": np.array([1, 0])})
    assert int(ev["cm"].sum()) == 32 * 32 and "probs" not in ev
    np.testing.assert_array_equal(seg.segment(x), labels)  # eval mode changes nothing
    seg.train_step({"image": x, "label": y.argmax(-1)})
    assert seg.optimizer.iterations == 2


@pytest.mark.parametrize("key,item", [("augment", "item 9"), ("fused_tail", "item 16"),
                                      ("eval_scales", "item 8"), ("eval_flip", "item 8")])
def test_unported_step_options_name_the_roadmap_item(key, item):
    value = [0.5, 1.0] if key == "eval_scales" else True
    with pytest.raises(NotImplementedError, match=item):
        SemanticSegmentation(conf_dict(32, **{key: value}), device="cpu")


def test_jax_variables_round_trip_through_the_port():
    conf = conf_dict(32)
    _, v = jax_model_and_variables(conf, seed=3)
    e = export_jax_variables(port_model(conf, v))
    flat_v = dict(jax.tree_util.tree_leaves_with_path(v))
    flat_e = dict(jax.tree_util.tree_leaves_with_path(e))
    assert flat_v.keys() == flat_e.keys()
    for path, a in flat_v.items():
        assert flat_e[path].dtype == np.float32
        np.testing.assert_array_equal(flat_e[path], a, err_msg=jax.tree_util.keystr(path))
