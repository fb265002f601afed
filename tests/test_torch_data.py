"""The port's datasets, host loader and device batches against the JAX
package's (``data/voc.py``, ``data/openimages.py``, ``data/pipeline.py``), on
trees the test writes with the port's ``make_synthetic_*``."""

import os
import shutil

import numpy as np
import pytest
import torch

from deeplabv3plus_keras_tpu.data import openimages as joi
from deeplabv3plus_keras_tpu.data import pipeline as jpipe
from deeplabv3plus_keras_tpu.data import synthetic as jsyn
from deeplabv3plus_keras_tpu.data import voc as jvoc
from deeplabv3plus_keras_tpu.train.loss import compute_class_balance_weights as jax_weights
from deeplabv3plus_keras_tpu_torch import native
from deeplabv3plus_keras_tpu_torch.data import openimages as poi
from deeplabv3plus_keras_tpu_torch.data import pipeline as ppipe
from deeplabv3plus_keras_tpu_torch.data import synthetic as psyn
from deeplabv3plus_keras_tpu_torch.data import voc as pvoc
from deeplabv3plus_keras_tpu_torch.train.loss import compute_class_balance_weights

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("voc"))
    psyn.make_synthetic_voc(root, n_train=7, n_val=3, n_test=3, min_size=40, max_size=90)
    # one image larger than the 64 canvas: the host downscales it
    from PIL import Image

    rng = np.random.default_rng(0)
    voc = os.path.join(root, "VOCdevkit", "VOC2012")
    Image.fromarray(rng.integers(0, 256, (97, 71, 3)).astype(np.uint8)).save(
        os.path.join(voc, "JPEGImages", "tr_0002.jpg"), quality=90)
    Image.fromarray(rng.integers(0, 30, (97, 71)).astype(np.uint8)).save(
        os.path.join(voc, "SegmentationClassAug", "tr_0002.png"))
    return root


def _spec_tuples(specs):
    return [(s.name, s.image_path, s.label_path, s.label_remap_value, s.valid) for s in specs]


def test_synthetic_trees_equal_jax(tmp_path):
    """The port's copies of make_synthetic_voc/openimages write the same
    bytes as the JAX package's from the same seed."""
    for fn in ("make_synthetic_voc", "make_synthetic_openimages"):
        a, b = tmp_path / f"p_{fn}", tmp_path / f"j_{fn}"
        getattr(psyn, fn)(str(a), n_train=3, n_val=2)
        getattr(jsyn, fn)(str(b), n_train=3, n_val=2)
        files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
        assert files == sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
        for f in files:
            assert (a / f).read_bytes() == (b / f).read_bytes(), f


@pytest.mark.parametrize("mode", [pvoc.MODE_TRAIN, pvoc.MODE_VAL, pvoc.MODE_TEST])
def test_spec_lists_equal_jax(voc_root, tmp_path, mode):
    assert _spec_tuples(pvoc.pascal_voc_2012(voc_root, mode)) == _spec_tuples(
        jvoc.pascal_voc_2012(voc_root, mode))
    for r in (0.1, 0.3, 0.5):
        assert _spec_tuples(pvoc.pascal_voc_2012_ext(voc_root, mode, r)) == _spec_tuples(
            jvoc.pascal_voc_2012_ext(voc_root, mode, r))
    oi = str(tmp_path / "oi")
    psyn.make_synthetic_openimages(oi, n_train=6, n_val=3)
    assert _spec_tuples(poi.google_open_images_v5(oi, mode)) == _spec_tuples(
        joi.google_open_images_v5(oi, mode))
    assert poi.load_class_maps(oi) == joi.load_class_maps(oi)
    assert pvoc.CLASS_NAMES == jvoc.CLASS_NAMES


def _loader_args(voc_root, **kw):
    specs = pvoc.pascal_voc_2012(voc_root, pvoc.MODE_TRAIN)
    args = dict(batch_size=3, canvas_size=64, workers=2, max_queue_size=2, shuffle=True,
                oversize_target=48, label_clamp=21)
    args.update(kw)
    return specs, args


def _assert_batches_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in ("image_canvas", "label_canvas", "sizes", "valid"):
            if x[k] is None:
                assert y[k] is None
            else:
                assert x[k].dtype == y[k].dtype
                np.testing.assert_array_equal(x[k], y[k])
        assert x["names"] == y["names"]


@pytest.mark.parametrize("backend", ["pil", "native"])
def test_host_loader_equals_jax(voc_root, backend):
    """Canvases, sizes, valid and names, shuffled, epochs 0 and 1, a
    padded tail and one oversized image; then set_epoch replays epoch 1."""
    if backend == "native" and not native.native_available():
        pytest.skip("g++ or the libjpeg/libpng headers are missing here")
    specs, args = _loader_args(voc_root, backend=backend)
    jspecs = jvoc.pascal_voc_2012(voc_root, jvoc.MODE_TRAIN)
    p = ppipe.HostLoader(specs, **args)
    j = jpipe.HostLoader(jspecs, **{**args, "backend": "pil"})
    epochs = []
    for _ in range(2):
        got, ref = list(p), list(j)
        _assert_batches_equal(got, ref)
        epochs.append(got)
    assert [b["names"] for b in epochs[0]] != [b["names"] for b in epochs[1]]
    assert len(epochs[0]) == 3 and list(epochs[0][-1]["valid"]) == [1, 0, 0]
    # the oversized sample landed on the network geometry (48 wide side)
    sizes = {n: tuple(s) for b in epochs[0] for n, s in zip(b["names"], b["sizes"])}
    assert max(sizes["tr_0002"]) == 48
    p2 = ppipe.HostLoader(specs, **args)
    p2.set_epoch(1)
    _assert_batches_equal(list(p2), epochs[1])


def test_host_loader_cache_and_unlabelled(voc_root):
    specs, args = _loader_args(voc_root, cache=True, workers=1)
    loader = ppipe.HostLoader(specs, **args)
    first, second = list(loader), list(loader)
    assert len(loader._cache) == len(specs)
    ref = jpipe.HostLoader(jvoc.pascal_voc_2012(voc_root, jvoc.MODE_TRAIN),
                           **{**args, "backend": "pil"})
    _assert_batches_equal(first, list(ref))
    _assert_batches_equal(second, list(ref))
    test_specs = pvoc.pascal_voc_2012(voc_root, pvoc.MODE_TEST)
    unl = list(ppipe.HostLoader(test_specs, 2, canvas_size=64, with_labels=False))
    assert all(b["label_canvas"] is None for b in unl)
    with pytest.raises(ValueError, match="backend"):
        ppipe.HostLoader(specs, 2, backend="opencv")


@pytest.mark.parametrize("one_hot,host_prepro", [(True, False), (False, False), (True, True),
                                                 (False, True)])
def test_device_batches_equal_jax(voc_root, one_hot, host_prepro):
    """device_batches on the CPU: images ≤ 1e-6 of the JAX package's,
    labels and valid exact, names equal."""
    specs, args = _loader_args(voc_root, shuffle=False, workers=1, backend="pil")
    got = list(ppipe.device_batches(ppipe.HostLoader(specs, **args), 48, 21,
                                    one_hot_labels=one_hot, host_prepro=host_prepro,
                                    device="cpu"))
    ref = list(jpipe.device_batches(
        jpipe.HostLoader(jvoc.pascal_voc_2012(voc_root, jvoc.MODE_TRAIN), **args), 48, 21,
        one_hot_labels=one_hot, host_prepro=host_prepro))
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g["image"].device.type == "cpu" and g["image"].shape == (3, 48, 48, 3)
        np.testing.assert_allclose(g["image"].numpy(), np.asarray(r["image"]), rtol=0, atol=1e-6)
        assert g["label"].dtype == (torch.float32 if one_hot else torch.int32)
        np.testing.assert_array_equal(g["label"].numpy(), np.asarray(r["label"]))
        np.testing.assert_array_equal(g["valid"].numpy(), np.asarray(r["valid"]))
        assert g["names"] == r["names"]


def test_native_library_builds_beside_the_package():
    """The fastloader builds into build/native/ keyed by its source, and
    reproduces PIL's bytes (its self-check)."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ here")
    path = native.build_fastloader()
    if path is None:
        pytest.skip("the libjpeg/libpng headers are missing here")
    assert path.parent == native.BUILD_DIR and path.suffix == ".so"
    assert native.build_fastloader() == path  # built once, then reused
    assert native.native_available()


def test_class_balance_weights_equal_jax(voc_root):
    """The offline class-weight tool over the tree's label PNGs (ids above
    20, VOC's 255 among them, count as background)."""
    paths = [s.label_path for s in pvoc.pascal_voc_2012(voc_root, pvoc.MODE_TRAIN)]
    pw, nw = compute_class_balance_weights(paths, 21)
    rpw, rnw = jax_weights(paths, 21)
    np.testing.assert_array_equal(pw, rpw)
    np.testing.assert_array_equal(nw, rnw)
    assert pw.dtype == np.float32 and pw.shape == (21,) and np.allclose(pw + nw, 1.0)
