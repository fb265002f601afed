"""The port's data-path resize and preprocessing against the JAX package's
(``ops/resize.py``, ``ops/preprocess.py``), on the same numpy inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplabv3plus_keras_tpu.ops import preprocess as jpre
from deeplabv3plus_keras_tpu.ops import resize as jres
from deeplabv3plus_keras_tpu_torch.ops import preprocess as ppre
from deeplabv3plus_keras_tpu_torch.ops import resize as pres

torch.set_num_threads(1)


@pytest.mark.parametrize("mode", ["constant", "nearest"])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
@pytest.mark.parametrize("in_hw,out_hw", [((37, 53), (64, 64)), ((64, 48), (21, 33)),
                                          ((30, 30), (30, 45))])
def test_affine_resize_matches_jax(mode, dtype, in_hw, out_hw):
    rng = np.random.default_rng(sum(in_hw) + sum(out_hw))
    x = rng.uniform(0, 255, in_hw + (3,)).astype(dtype)
    ref = np.asarray(jres.affine_resize(jnp.asarray(x), *out_hw, mode=mode))
    got = pres.affine_resize(torch.from_numpy(x), *out_hw, mode=mode).numpy()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    if dtype == np.uint8:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * 255)


def test_symmetric_geometry_matches_jax_static_and_traced():
    hs = [1, 2, 7, 63, 64, 65, 99, 100, 257, 333, 500, 1023]
    for size in (32, 64, 65, 512):
        for h in hs:
            for w in hs:
                assert pres.symmetric_geometry(h, w, size) == jres.symmetric_geometry(h, w, size)
        hh, ww = np.meshgrid(np.array(hs, np.int32), np.array(hs, np.int32))
        ref = jres.symmetric_geometry(jnp.asarray(hh.ravel()), jnp.asarray(ww.ravel()), size)
        got = pres.symmetric_geometry(torch.from_numpy(hh.ravel()), torch.from_numpy(ww.ravel()), size)
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("hw", [(41, 64), (64, 41), (33, 27), (27, 33), (64, 64)])
def test_resize_symmetric_matches_jax(hw):
    x = np.random.default_rng(hw[0] * hw[1]).uniform(-1, 1, hw + (3,)).astype(np.float32)
    ref = jres.resize_symmetric(jnp.asarray(x), 48)
    got = pres.resize_symmetric(torch.from_numpy(x), 48)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=0, atol=1e-6)
    assert got[1:] == tuple(int(v) for v in ref[1:])


def _canvases(sizes, canvas, seed):
    rng = np.random.default_rng(seed)
    B = len(sizes)
    img = np.zeros((B, canvas, canvas, 3), np.uint8)
    lab = np.zeros((B, canvas, canvas), np.uint8)
    for i, (h, w) in enumerate(sizes):
        img[i, :h, :w] = rng.integers(0, 256, (h, w, 3))
        blocky = rng.integers(0, 25, (h // 4 + 1, w // 4 + 1)).astype(np.uint8)
        lab[i, :h, :w] = np.repeat(np.repeat(blocky, 4, 0), 4, 1)[:h, :w]
        lab[i, 0, 0] = 255  # VOC's ignore id
    return img, lab, np.asarray(sizes, np.int32)


@pytest.mark.parametrize("one_hot", [True, False])
def test_prepare_batch_matches_jax(one_hot):
    """Odd and even (h, w), wide and tall, the canvas filled whole, and a
    long side below the target (an upscale)."""
    sizes = [(37, 53), (53, 37), (80, 80), (1, 80), (80, 1), (17, 29)]
    img, lab, hw = _canvases(sizes, 80, seed=1)
    ref_i, ref_l = jpre.prepare_batch(jnp.asarray(img), jnp.asarray(hw), jnp.asarray(lab),
                                      size=48, num_classes=21, one_hot_labels=one_hot)
    got_i, got_l = ppre.prepare_batch(torch.from_numpy(img), torch.from_numpy(hw),
                                      torch.from_numpy(lab), size=48, num_classes=21,
                                      one_hot_labels=one_hot)
    np.testing.assert_allclose(got_i.numpy(), np.asarray(ref_i), rtol=0, atol=1e-6)
    assert got_l.dtype == (torch.float32 if one_hot else torch.int32)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(ref_l))
    assert np.abs(got_i.numpy()).max() <= 1.0


def test_prepare_batch_images_only():
    img, _, hw = _canvases([(30, 20), (20, 30)], 40, seed=2)
    ref_i, _ = jpre.prepare_batch(jnp.asarray(img), jnp.asarray(hw), None, size=32,
                                  with_labels=False)
    got_i, got_l = ppre.prepare_batch(torch.from_numpy(img), torch.from_numpy(hw), None,
                                      size=32, with_labels=False)
    assert got_l is None
    np.testing.assert_allclose(got_i.numpy(), np.asarray(ref_i), rtol=0, atol=1e-6)


@pytest.mark.parametrize("hw", [(37, 61), (61, 37), (90, 90)])
def test_host_paths_match_jax(hw):
    """The host SciPy path (prepro_device == -1) and the host downscale of
    an image larger than the canvas, exactly."""
    rng = np.random.default_rng(hw[0])
    img = rng.integers(0, 256, hw + (3,)).astype(np.uint8)
    lab = rng.integers(0, 30, hw).astype(np.uint8)
    ri, rl = jpre.host_prepare_sample(img, lab, 48, 21)
    gi, gl = ppre.host_prepare_sample(img, lab, 48, 21)
    np.testing.assert_array_equal(gi, ri)
    np.testing.assert_array_equal(gl, rl)
    ri, rl = jpre.host_symmetric_downscale(img, lab, 32, 21)
    gi, gl = ppre.host_symmetric_downscale(img, lab, 32, 21)
    np.testing.assert_array_equal(gi, ri)
    np.testing.assert_array_equal(gl, rl)


def test_normalize_clamp_one_hot_match_jax():
    x = np.arange(256, dtype=np.uint8).reshape(16, 16)
    np.testing.assert_array_equal(ppre.normalize_image(torch.from_numpy(x)).numpy(),
                                  np.asarray(jpre.normalize_image(jnp.asarray(x))))
    np.testing.assert_array_equal(ppre.clamp_label(torch.from_numpy(x), 21).numpy(),
                                  np.asarray(jpre.clamp_label(jnp.asarray(x), 21)))
    lab = (x % 21).astype(np.int32)[..., None]
    np.testing.assert_array_equal(ppre.one_hot(torch.from_numpy(lab), 21).numpy(),
                                  np.asarray(jpre.one_hot(jnp.asarray(lab), 21)))
