"""``parallel/multihost.py`` ``shard_specs`` (the port's own copy) against
the JAX package's, on the cases of tests/test_multihost.py: strided
shards padded to one step count, more processes than samples, and padding
marked invalid for evaluation; and a marked spec through the port's
loader.  Exact: lists of specs."""

import dataclasses

import numpy as np
import pytest

from deeplabv3plus_keras_tpu.data.voc import SampleSpec as JaxSpec
from deeplabv3plus_keras_tpu.parallel import shard_specs as jax_shard_specs
from deeplabv3plus_keras_tpu_torch.data import HostLoader
from deeplabv3plus_keras_tpu_torch.data.voc import SampleSpec
from deeplabv3plus_keras_tpu_torch.parallel.multihost import shard_specs


@pytest.mark.parametrize("n,count", [(10, 4), (2, 3), (5, 2), (7, 1), (8, 8), (1, 4)])
@pytest.mark.parametrize("mark", [False, True])
def test_shard_specs_equal_jax(n, count, mark):
    mine = [SampleSpec(name=f"s{i}", image_path=f"/x/{i}.jpg", label_path=None) for i in range(n)]
    ref = [JaxSpec(name=f"s{i}", image_path=f"/x/{i}.jpg", label_path=None) for i in range(n)]
    for pi in range(count):
        got = shard_specs(mine, pi, count, mark_duplicates=mark)
        want = jax_shard_specs(ref, pi, count, mark_duplicates=mark)
        assert [(s.name, s.valid) for s in got] == [(s.name, s.valid) for s in want]
    assert all(s.valid for s in mine)  # replaced, not mutated


def test_shard_specs_partitions_and_pads():
    specs = list(range(10))
    shards = [shard_specs(specs, pi, 4) for pi in range(4)]
    assert all(len(s) == 3 for s in shards)
    assert sorted(x for pi in range(4) for x in specs[pi::4]) == specs
    assert shards[2] == [2, 6, 2] and shards[3] == [3, 7, 3]
    assert shard_specs(specs, 0, 1) == specs
    # without a process group: this process is the only one
    assert shard_specs(specs) == specs


def test_loader_zeroes_validity_of_marked_duplicates(tmp_path):
    """A spec marked invalid is decoded (one batch shape) and flows through
    the port's HostLoader with validity 0."""
    from PIL import Image

    img_path = str(tmp_path / "a.jpg")
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(img_path)
    real = SampleSpec(name="a", image_path=img_path, label_path=None)
    pad = dataclasses.replace(real, valid=False)
    (batch,) = list(HostLoader([real, pad], batch_size=2, canvas_size=16, workers=1,
                               with_labels=False, backend="pil"))
    assert batch["valid"].tolist() == [1, 0]
