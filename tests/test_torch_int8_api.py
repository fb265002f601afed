"""``int8_infer`` through the port's facade, on the CPU: ``segment()``,
``evaluate()`` and ``test()`` quantized (JAX ``api.py:282-337, 537-538,
616, 638-643``), the "no quantizable conv" error, the 16-bit output dtype
against the JAX package's ``QuantConv``, training untouched by a
calibration, test-time augmentation's per-call gate, and the int8
``.pt2``.

The int8 path on the CPU is the plain version (an exact integer product),
so a quantized forward repeats bit for bit: the loaded program equals the
in-process int8 forward exactly.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplabv3plus_keras_tpu.models.blocks import QuantConv as JaxQuantConv
from deeplabv3plus_keras_tpu_torch import SemanticSegmentation
from deeplabv3plus_keras_tpu_torch.api import EXPORT_INT8_MODEL_PATH, EXPORT_MODEL_PATH
from deeplabv3plus_keras_tpu_torch.data import make_synthetic_voc
from deeplabv3plus_keras_tpu_torch.models.blocks import QuantConv
from deeplabv3plus_keras_tpu_torch.ops import quant as pq
from deeplabv3plus_keras_tpu_torch.parallel.step import build_label_step, build_predict_step

from torch_helpers import conf_dict

torch.set_num_threads(1)
SIZE = 64


def _images(n, size=SIZE, seed=1):
    return np.random.default_rng(seed).uniform(-1, 1, (n, size, size, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_synthetic_voc(str(tmp_path_factory.mktemp("voc")), n_train=4, n_val=2, n_test=2,
                              min_size=40, max_size=80)


def _conf(root, **extra):
    conf = conf_dict(SIZE, resource_type="pascal_voc_2012", resource_path=root, workers=1,
                     int8_infer=True, int8_calib_batches=2, **extra)
    conf["hps"]["batch_size"] = 2
    return conf


def test_segment_calibrates_on_its_images_and_serves_int8(tree, tmp_path):
    seg = SemanticSegmentation(_conf(tree), work_dir=str(tmp_path), device="cpu")
    x = _images(4)
    pq.reset_counts()
    labels = seg.segment(x)
    assert labels.shape == (4, SIZE, SIZE) and labels.dtype == np.int32
    assert 0 <= labels.min() and labels.max() < 21
    # calibrated on the given images (two batches of hps.batch_size), then
    # every calibrated site ran int8 once
    ranges = pq.calibrate(seg.model, [x[:2], x[2:]])
    assert {k: v.item() for k, v in seg._quant.items()} == {k: v.item() for k, v in ranges.items()}
    assert pq.counts["int8_conv"] == len(ranges) >= 10
    np.testing.assert_array_equal(build_label_step(seg.model, ranges)(torch.from_numpy(x)).numpy(),
                                  labels)
    # a second call keeps the ranges
    seg.segment(_images(2, seed=5))
    assert seg._quant is not None and all(seg._quant[k].item() == v.item()
                                          for k, v in ranges.items())


def test_evaluate_and_test_run_int8_from_the_training_split(tree, tmp_path):
    seg = SemanticSegmentation(_conf(tree), work_dir=str(tmp_path), device="cpu")
    pq.reset_counts()
    miou = seg.evaluate()
    # calibrated on int8_calib_batches (2) training batches: 2 × 10 float
    # sites recorded, then the 2 validation samples' batch in int8
    n_sites = len(seg._quant)
    assert n_sites >= 10 and pq.counts["int8_conv"] == n_sites
    assert 0.0 <= miou.result() <= 1.0
    float_seg = SemanticSegmentation({**_conf(tree), "int8_infer": False},
                                     work_dir=str(tmp_path / "f"), device="cpu")
    assert float_seg.evaluate().result() >= 0.0
    seg.evaluate(result_saving=True)
    assert len(os.listdir(tmp_path / "results")) == 2
    pq.reset_counts()
    seg.test()
    pngs = sorted(os.listdir(tmp_path / "test_results"))
    assert len(pngs) == 2 and pq.counts["int8_conv"] == n_sites


def test_no_quantizable_conv_names_both_gates():
    conf = conf_dict(SIZE, int8_infer=True)
    conf["nn_arch"].update(reduction_size=64, concat_channels=64)
    seg = SemanticSegmentation(conf, device="cpu")
    with pytest.raises(ValueError, match="MIN_QUANT_CHANNELS=128.*MAX_QUANT_PIXELS=4096"):
        seg.segment(_images(1))


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_low_precision_int8_conv_dtype_matches_jax(dtype):
    """A calibrated QuantConv on a 16-bit input returns that dtype, the
    activation quantized from float32 (JAX ``models/blocks.py:121-126``)."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 4, 4, 128)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    jmod = JaxQuantConv(256, dtype=jdt)
    params = jmod.init(__import__("jax").random.PRNGKey(0), jnp.asarray(x))["params"]
    amax = np.float32(np.abs(x).max())
    ref = jmod.apply({"params": params, "quant": {"in_absmax": jnp.asarray(amax)}},
                     jnp.asarray(x, jdt))
    pmod = QuantConv(128, 256, 1)
    with torch.no_grad():
        pmod.weight.copy_(torch.from_numpy(np.array(params["kernel"]).transpose(3, 2, 0, 1)))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(getattr(torch, dtype))
    with torch.no_grad(), pq.quantized(pmod, {"": torch.tensor(amax)}):
        got = pmod(xt)
    assert str(ref.dtype) == dtype and got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().permute(0, 2, 3, 1).numpy(),
                                  np.asarray(ref, np.float32))
    # the whole bfloat16 model under int8: probabilities at least float32
    conf = conf_dict(SIZE, int8_infer=True)
    conf["hps"]["dtype"] = dtype
    seg = SemanticSegmentation(conf, device="cpu")
    seg.calibrate_int8(_images(2))
    probs = build_predict_step(seg.model, seg._quant)(torch.from_numpy(_images(2)))
    assert probs.dtype == torch.float32 and torch.isfinite(probs).all()


def test_train_step_is_untouched_by_calibration():
    batch = {"image": _images(2, seed=3),
             "label": np.random.default_rng(4).integers(0, 21, (2, SIZE, SIZE))}
    a = SemanticSegmentation(conf_dict(SIZE, int8_infer=True), device="cpu")
    b = SemanticSegmentation(conf_dict(SIZE), device="cpu")
    a.segment(_images(2))  # calibrates and serves int8
    assert a._quant
    la, lb = a.train_step(batch)["loss"], b.train_step(batch)["loss"]
    assert la.item() == lb.item()
    for (n, pa), pb in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(pa, pb), n


def test_tta_checks_the_gate_at_each_scale(monkeypatch):
    """Under test-time augmentation the pixel count changes with the scale:
    a site calibrated at 1.0 runs int8 only where the scale keeps it under
    the spatial gate."""
    monkeypatch.setattr(pq, "MAX_QUANT_PIXELS", 16)  # 4² at 64²: the encoder's maps
    seg = SemanticSegmentation(conf_dict(SIZE, int8_infer=True, eval_scales=[1.0, 1.5]),
                               device="cpu")
    seg.calibrate_int8(_images(2))
    n_sites = len(seg._quant)
    step = seg._int8_step("eval", with_probs=False)
    pq.reset_counts()
    out = step({"image": torch.from_numpy(_images(2)),
                "label": torch.from_numpy(np.random.default_rng(0).integers(0, 21, (2, SIZE, SIZE))),
                "valid": torch.ones(2, dtype=torch.int32)})
    assert pq.counts["int8_conv"] == n_sites  # scale 1.5 (96², 6² maps): float
    assert torch.isfinite(out["loss"])


def test_int8_program_round_trips(tmp_path):
    seg = SemanticSegmentation(conf_dict(SIZE, int8_infer=True), work_dir=str(tmp_path),
                               device="cpu")
    calib = _images(2, seed=8)
    paths = seg.convert_to_tf_lite(representative_images=calib)
    assert [os.path.basename(p) for p in paths] == [EXPORT_MODEL_PATH, EXPORT_INT8_MODEL_PATH]
    program = torch.export.load(paths[1])
    ranges = pq.calibrate(seg.model, [calib])
    for b in (1, 3):
        x = torch.from_numpy(_images(b, seed=9))
        with torch.no_grad():
            got = program.module()(x)
        ref = build_predict_step(seg.model, ranges)(x)
        assert got.shape == (b, SIZE, SIZE, 21)
        assert torch.equal(got, ref)
        plain = build_predict_step(seg.model)(x)
        assert not torch.equal(got, plain)  # int8, not the float program
    with torch.no_grad():
        fp = torch.export.load(paths[0]).module()(x)
    assert torch.equal(fp, plain)
