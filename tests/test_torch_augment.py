"""The port's on-device augmentation against the JAX package's
(``ops/augment.py``): the same parameters fed to both ``apply_augment``s,
since the port cannot reproduce ``jax.random``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplabv3plus_keras_tpu.ops import augment as jaug
from deeplabv3plus_keras_tpu_torch import SemanticSegmentation
from deeplabv3plus_keras_tpu_torch.ops import augment as paug

from torch_helpers import conf_dict

torch.set_num_threads(1)


def _params(B, seed):
    rng = np.random.default_rng(seed)
    return {"flip": rng.uniform(size=B) < 0.5,
            "z": rng.uniform(0.5, 2.0, B).astype(np.float32),
            "uy": rng.uniform(size=B).astype(np.float32),
            "ux": rng.uniform(size=B).astype(np.float32)}


@pytest.mark.parametrize("layout", ["one_hot", "sparse", "none"])
def test_apply_augment_matches_jax(layout):
    B, S = 6, 40
    rng = np.random.default_rng(3)
    image = rng.uniform(-1, 1, (B, S, S, 3)).astype(np.float32)
    ids = rng.integers(0, 21, (B, S, S)).astype(np.int32)
    label = {"one_hot": np.eye(21, dtype=np.float32)[ids], "sparse": ids, "none": None}[layout]
    params = _params(B, seed=4)
    # the edges of the zoom range and no zoom, flipped and not
    params["z"][:4] = [0.5, 2.0, 1.0, 1.0]
    params["flip"][:4] = [True, False, True, False]
    ri, rl = jaug.apply_augment(jnp.asarray(image), None if label is None else jnp.asarray(label),
                                {k: jnp.asarray(v) for k, v in params.items()})
    gi, gl = paug.apply_augment(torch.from_numpy(image),
                                None if label is None else torch.from_numpy(label),
                                {k: torch.from_numpy(v) for k, v in params.items()})
    np.testing.assert_allclose(gi.numpy(), np.asarray(ri), rtol=0, atol=1e-5)
    if label is None:
        assert gl is None and rl is None
    else:
        assert gl.dtype == torch.from_numpy(label).dtype
        np.testing.assert_array_equal(gl.numpy(), np.asarray(rl))
    # z = 1 and no flip is the identity
    np.testing.assert_array_equal(gi[3].numpy(), image[3])


@pytest.mark.parametrize("hw", [(96, 64), (64, 96)], ids=["tall", "wide"])
@pytest.mark.parametrize("layout", ["sparse", "none"])
def test_apply_augment_nonsquare_matches_jax(hw, layout):
    """Non-square batches: JAX samples both axes at S = H and clamps its
    out-of-range column gathers, so (2, 96, 64, 3) comes back (2, 96, 96)
    and (2, 64, 96, 3) comes back (2, 64, 64); the port returns the same
    shapes and values (images to 1e-6, labels exactly)."""
    H, W = hw
    rng = np.random.default_rng(11)
    image = rng.uniform(-1, 1, (2, H, W, 3)).astype(np.float32)
    label = rng.integers(0, 21, (2, H, W)).astype(np.int32) if layout == "sparse" else None
    params = _params(2, seed=12)
    # one sample zoomed in and flipped, one shrunk
    params["z"][:] = [1.6, 0.7]
    params["flip"][:] = [True, False]
    ri, rl = jaug.apply_augment(jnp.asarray(image), None if label is None else jnp.asarray(label),
                                {k: jnp.asarray(v) for k, v in params.items()})
    gi, gl = paug.apply_augment(torch.from_numpy(image),
                                None if label is None else torch.from_numpy(label),
                                {k: torch.from_numpy(v) for k, v in params.items()})
    assert tuple(gi.shape) == tuple(ri.shape) == (2, H, H, 3)
    np.testing.assert_allclose(gi.numpy(), np.asarray(ri), rtol=0, atol=1e-6)
    if label is None:
        assert gl is None and rl is None
    else:
        assert tuple(gl.shape) == tuple(rl.shape) == (2, H, H)
        np.testing.assert_array_equal(gl.numpy(), np.asarray(rl))


@pytest.mark.parametrize("value", [None, False, True, {}, {"random_flip": False},
                                   {"scale_range": [0.75, 1.25]},
                                   {"random_flip": False, "scale_range": None},
                                   {"random_flip": True, "scale_range": False}])
def test_parse_augment_conf_matches_jax(value):
    assert paug.parse_augment_conf(value) == jaug.parse_augment_conf(value)


def test_parse_augment_conf_rejects_bad_range():
    for bad in ([0.0, 1.0], [2.0, 1.0]):
        with pytest.raises(ValueError, match="scale_range"):
            paug.parse_augment_conf({"scale_range": bad})


def test_sample_params_reproducible_and_in_range():
    def draw(seed, flip=True, scale_range=(0.5, 2.0)):
        return paug.sample_params(torch.Generator().manual_seed(seed), 256, flip, scale_range)

    a, b, c = draw(7), draw(7), draw(8)
    for k in a:
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["z"], c["z"])
    assert a["flip"].dtype == torch.bool and 0.3 < a["flip"].float().mean() < 0.7
    assert float(a["z"].min()) >= 0.5 and float(a["z"].max()) <= 2.0
    for k in ("uy", "ux"):
        assert float(a[k].min()) >= 0.0 and float(a[k].max()) < 1.0
    off = draw(7, flip=False, scale_range=None)
    assert not off["flip"].any() and bool((off["z"] == 1.0).all())


def test_train_step_with_augment_draws_from_the_step_generator():
    """Augmentation on: the step is reproducible from (seed, step) and
    differs from the step without it."""
    conf = conf_dict(32, augment=True)
    conf["nn_arch"]["dropout_rate"] = 0.0
    rng = np.random.default_rng(5)
    batch = {"image": rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32),
             "label": rng.integers(0, 21, (2, 32, 32))}
    losses = []
    for c in (conf, conf, conf_dict(32)):
        c["nn_arch"]["dropout_rate"] = 0.0
        seg = SemanticSegmentation(c, device="cpu")
        losses.append(float(seg.train_step(batch)["loss"]))
    assert losses[0] == losses[1]
    assert losses[0] != losses[2]
