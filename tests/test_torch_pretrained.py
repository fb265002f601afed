"""Pretrained Keras backbones on the port (``utils/keras_weights.py``,
``utils/pretrained.py``, the facade's ``backbone_weights``) against the
JAX package's converter (``deeplabv3plus_keras_tpu/utils/pretrained.py``).

Each backbone family's random-weight ``keras.applications`` model is saved
to an ``.h5`` (the offline file a user supplies) and loaded through both:
every backbone tensor must be equal (the same numbers, moved by the same
transposes), and the full model's logits within 1e-5 of their largest
magnitude (the float32 parity bound of tests/test_torch_model.py).  Needs
TensorFlow to build the Keras source, so marked ``parity`` as the JAX
package's tests/test_pretrained.py is.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplabv3plus_keras_tpu.config import Config as JaxConfig  # noqa: E402
from deeplabv3plus_keras_tpu.utils.pretrained import (  # noqa: E402
    load_pretrained_backbone as jax_load_pretrained_backbone,
)
from deeplabv3plus_keras_tpu_torch import SemanticSegmentation  # noqa: E402
from deeplabv3plus_keras_tpu_torch.config import Config  # noqa: E402
from deeplabv3plus_keras_tpu_torch.models import DeepLabV3Plus  # noqa: E402
from deeplabv3plus_keras_tpu_torch.utils import pretrained  # noqa: E402
from deeplabv3plus_keras_tpu_torch.utils.jax_weights import (  # noqa: E402
    export_jax_variables,
    load_jax_variables,
)

from torch_helpers import conf_dict, jax_model_and_traced_variables  # noqa: E402

pytestmark = pytest.mark.parity
torch.set_num_threads(1)
SIZE = 64
FAMILIES = ["mobilenetv2", "xception", "efficientnetb0", "nasnetmobile", "densenet121"]
# Keras builds Xception from 71² up: it runs at 96², the others at 64²
SIZES = {"xception": 96}


def _h5(base_model: str, path: str) -> str:
    """A random-weight Keras application of ``base_model``, saved."""
    build = pretrained.keras_builder(base_model, SIZES.get(base_model, SIZE), weights=None)
    model = build()
    # random BN statistics and shifts, so the converted statistics matter
    rng = np.random.default_rng(len(base_model))
    for layer in model.layers:
        if "BatchNormalization" in type(layer).__name__:
            gamma, beta, mean, var = layer.get_weights()
            layer.set_weights([rng.uniform(0.6, 1.4, gamma.shape), rng.normal(0, 0.2, beta.shape),
                               rng.normal(0, 0.2, mean.shape), rng.uniform(0.6, 1.4, var.shape)])
    model.save_weights(path)
    return path


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("keras")
    return {name: _h5(name, str(d / f"{name}.weights.h5")) for name in FAMILIES}


@pytest.mark.parametrize("base_model", FAMILIES)
def test_converted_backbone_equals_jax(base_model, files):
    size = SIZES.get(base_model, SIZE)
    conf = {**conf_dict(size), "base_model": base_model, "backbone_weights": files[base_model]}
    jm, v = jax_model_and_traced_variables(conf, seed=1)
    jv, report = jax_load_pretrained_backbone(JaxConfig.from_dict(conf), v)
    model = DeepLabV3Plus(Config.from_dict(conf))
    load_jax_variables(model, v)  # the same head and the same starting tree
    got = pretrained.load_pretrained_backbone(Config.from_dict(conf), model)
    assert got["used"] == report["used"] and not got["missing"]
    pv = export_jax_variables(model)
    n = 0
    for collection in ("params", "batch_stats"):
        ref = dict(_leaves(jv[collection]["base"]))
        mine = dict(_leaves(pv[collection]["base"]))
        assert ref.keys() == mine.keys()
        for path, a in ref.items():
            np.testing.assert_array_equal(mine[path], a, err_msg=f"{collection}/{path}")
            n += 1
    assert n > 50
    # the converted backbone moved: not the random start
    start = dict(_leaves(v["params"]["base"]))
    assert any(not np.array_equal(start[p], a) for p, a in _leaves(jv["params"]["base"]))
    # and the whole model's logits agree
    x = np.random.default_rng(0).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    jl = np.asarray(jax.jit(lambda v_, x_: jm.apply(v_, x_, train=False, return_presample=True)[0])(
        jv, jnp.asarray(x)))
    model = model.to(memory_format=torch.channels_last).eval()
    with torch.no_grad():
        pl = model(torch.from_numpy(x), return_presample=True)[0].numpy()
    assert np.isfinite(pl).all() and np.abs(jl).max() > 0
    np.testing.assert_allclose(pl, jl, rtol=0, atol=1e-5 * np.abs(jl).max())


def test_missing_layers_raise_and_leave_the_model(files, monkeypatch):
    """A Keras source that cannot cover the backbone fails loudly and
    loads nothing, rather than train half-random."""
    conf = Config.from_dict({**conf_dict(96), "base_model": "xception",
                             "backbone_weights": files["mobilenetv2"]})
    model = DeepLabV3Plus(conf)
    model.init_weights(torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    # Keras builds (and loads) a MobileNetV2 for the Xception backbone
    monkeypatch.setitem(pretrained._KERAS_APP, "xception", "MobileNetV2")
    with pytest.raises(RuntimeError, match="layers not found in the Keras source"):
        pretrained.load_pretrained_backbone(conf, model)
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


def test_unset_key_changes_nothing():
    for spec in (None, ""):
        conf = Config.from_dict({**conf_dict(SIZE), "backbone_weights": spec})
        model = DeepLabV3Plus(conf)
        model.init_weights(torch.Generator().manual_seed(0))
        before = {k: v.clone() for k, v in model.state_dict().items()}
        assert pretrained.load_pretrained_backbone(conf, model) is None
        assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


@pytest.mark.parametrize("base_model,image_size,name", [
    ("mobilenetv2", 64, "mobilenet_v2_weights_tf_dim_ordering_tf_kernels_1.0_224_no_top.h5"),
    ("mobilenetv2", 128, "mobilenet_v2_weights_tf_dim_ordering_tf_kernels_1.0_128_no_top.h5"),
    ("xception", 64, "xception_weights_tf_dim_ordering_tf_kernels_notop.h5"),
    ("efficientnetb3", 64, "efficientnetb3_notop.h5"),
    ("nasnetlarge", 64, "nasnet_large_no_top.h5"),
    ("densenet169", 64, "densenet169_weights_tf_dim_ordering_tf_kernels_notop.h5"),
])
def test_imagenet_without_the_cached_file_raises_naming_it(base_model, image_size, name,
                                                           tmp_path, monkeypatch):
    monkeypatch.setenv("KERAS_HOME", str(tmp_path))
    conf = Config.from_dict({**conf_dict(image_size), "base_model": base_model,
                             "backbone_weights": "imagenet"})
    with pytest.raises(FileNotFoundError, match=os.path.join(str(tmp_path), "models", name)):
        pretrained.load_pretrained_backbone(conf, torch.nn.Module())


def test_imagenet_reads_the_cached_file(files, tmp_path, monkeypatch):
    """With the file in the Keras cache, "imagenet" loads it (nothing is
    downloaded: the cache is a temporary directory).  The cached ImageNet
    files are Keras 2's legacy HDF5 layout: the same weights are written so."""
    import h5py
    from keras.src.legacy.saving import legacy_h5_format

    os.makedirs(tmp_path / "models")
    name = pretrained.imagenet_weight_file("mobilenetv2", SIZE)
    source = pretrained.keras_builder("mobilenetv2", SIZE)()
    source.load_weights(files["mobilenetv2"])
    with h5py.File(tmp_path / "models" / name, "w") as f:
        legacy_h5_format.save_weights_to_hdf5_group(f, source)
    monkeypatch.setenv("KERAS_HOME", str(tmp_path))
    conf = Config.from_dict({**conf_dict(SIZE), "backbone_weights": "imagenet"})
    a, b = DeepLabV3Plus(conf), DeepLabV3Plus(conf)
    pretrained.load_pretrained_backbone(conf, a)
    pretrained.load_pretrained_backbone(
        Config.from_dict({**conf_dict(SIZE), "backbone_weights": files["mobilenetv2"]}), b)
    assert all(torch.equal(v, b.state_dict()[k]) for k, v in a.state_dict().items()
               if k.startswith("base."))


def test_facade_starts_from_the_converted_weights_and_trains(files):
    keras_model = pretrained.keras_builder("mobilenetv2", SIZE)()
    keras_model.load_weights(files["mobilenetv2"])
    kernel = keras_model.get_layer("Conv1").get_weights()[0]
    seg = SemanticSegmentation({**conf_dict(SIZE), "backbone_weights": files["mobilenetv2"]},
                               device="cpu")
    w = seg.model.base.Conv1.weight.detach().permute(2, 3, 1, 0).numpy()
    np.testing.assert_array_equal(w, kernel)
    rng = np.random.default_rng(2)
    out = seg.train_step({"image": rng.uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32),
                          "label": rng.integers(0, 21, (2, SIZE, SIZE))})
    assert np.isfinite(out["loss"].item())
    assert not np.array_equal(seg.model.base.Conv1.weight.detach().permute(2, 3, 1, 0).numpy(),
                              kernel)


def test_loading_an_h5_pulls_in_no_jax(files):
    """The port loads a Keras file without importing jax (TensorFlow's
    TFLite module imports it where it is installed)."""
    code = f"""
import sys
from deeplabv3plus_keras_tpu_torch import SemanticSegmentation
conf = {{"base_model": "mobilenetv2", "backbone_weights": {files["mobilenetv2"]!r},
        "nn_arch": {{"image_size": {SIZE}}}}}
seg = SemanticSegmentation(conf, device="cpu")
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "flax", "deeplabv3plus_keras_tpu.")))
assert "tensorflow" in sys.modules
print("LEAKED", bad)
"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=600, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LEAKED []" in out.stdout, out.stdout
