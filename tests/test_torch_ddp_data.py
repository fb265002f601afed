"""The port's input pipeline for one rank of N (``data/pipeline.py``), on
the CPU, without a process group (each rank's loader is built with its
``rank`` and ``world``):

- ``HostLoader``: every rank walks the one-process order and yields
  exactly its ``mesh.row_indices`` rows of each global batch, under
  shuffling and ``grad_accum``; canvases bit for bit;
- the sharded ``DeviceDataset``: each rank caches its shard and draws
  exactly what the JAX package's ``DeviceDataset._shard_draws`` draws for
  that shard (on a ``make_mesh(n_data=N)`` of the 8 virtual CPU devices),
  for a full and a partial cache, and its batches hold those samples with
  the streaming path's pixels (1e-6, as tests/test_torch_device_cache.py).
"""

import numpy as np
import pytest
import torch

from deeplabv3plus_keras_tpu.data import pipeline as jpipe
from deeplabv3plus_keras_tpu.data import voc as jvoc
from deeplabv3plus_keras_tpu.parallel import make_mesh
from deeplabv3plus_keras_tpu_torch.data import (
    MODE_TRAIN,
    DeviceDataset,
    HostLoader,
    device_batches,
    make_synthetic_voc,
    pascal_voc_2012,
)
from deeplabv3plus_keras_tpu_torch.parallel import mesh

torch.set_num_threads(1)
BPS = 64 * 64 * 4 + 8  # a cached sample's bytes at a 64² canvas


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    return make_synthetic_voc(str(tmp_path_factory.mktemp("voc")), n_train=11, n_val=0,
                              n_test=0, min_size=40, max_size=64)


def _loader(specs, **kw):
    args = dict(batch_size=8, canvas_size=64, workers=1, shuffle=True, seed=3)
    return HostLoader(specs, **{**args, **kw})


@pytest.mark.parametrize("world,accum", [(2, 1), (2, 2), (4, 2)])
def test_each_rank_loads_its_rows_of_the_global_batch(voc_root, world, accum):
    """Two epochs (the second reshuffled) with a ragged last batch: rank
    r's canvases, sizes, validity and names are the one-process batch's
    rows ``row_indices(8, world, r, accum)``; a rank whose rows all fall in
    the padding gets zero canvases with validity 0; every rank takes the
    same number of steps."""
    specs = pascal_voc_2012(voc_root, MODE_TRAIN)  # 11 samples: batches of 8 and 3
    one = _loader(specs)
    ranks = [_loader(specs, rank=r, world=world, accum=accum) for r in range(world)]
    assert all(len(r) == len(one) == 2 for r in ranks)
    for _epoch in range(2):
        ref = list(one)
        for r, loader in enumerate(ranks):
            rows = mesh.row_indices(8, world, r, accum)
            got = list(loader)
            assert len(got) == len(ref)
            for a, b in zip(got, ref):
                for k in ("image_canvas", "label_canvas", "sizes", "valid"):
                    np.testing.assert_array_equal(a[k], b[k][rows])
                real = [b["names"][i] for i in rows if i < len(b["names"])]
                assert a["names"] == real
    # the ranks' valid rows cover each sample once an epoch
    seen = [n for loader in ranks for b in loader for n in b["names"]]
    assert sorted(seen) == sorted(s.name for s in specs)


def _jax_draws(voc_root, world, max_bytes):
    specs = jvoc.pascal_voc_2012(voc_root, jvoc.MODE_TRAIN)
    loader = jpipe.HostLoader(specs, batch_size=8, canvas_size=64, workers=1, shuffle=True,
                              seed=3)
    ds = jpipe.DeviceDataset(loader, mesh=make_mesh(n_data=world), max_bytes=max_bytes)
    plans = []
    for epoch in range(2):
        ds.set_epoch(epoch)
        plans.append(ds._shard_draws())
    return ds, plans


@pytest.mark.parametrize("world,max_bytes", [(2, None), (4, None), (2, 4 * BPS)])
def test_sharded_cache_draws_as_jax(voc_root, world, max_bytes):
    """Shard sizes, K, the residual split and two epochs' draws of every
    shard equal the JAX package's; rank r's cached rows are shard r's
    samples, and its batches gather them (names and pixels) in the drawn
    order, padding as padding."""
    jds, jplans = _jax_draws(voc_root, world, max_bytes)
    specs = pascal_voc_2012(voc_root, MODE_TRAIN)
    ref = {}
    for b in device_batches(_loader(specs, shuffle=False), 64, 21, device="cpu"):
        for i, name in enumerate(b["names"]):
            ref[name] = (b["image"][i].numpy(), b["label"][i].numpy())
    for r in range(world):
        ds = DeviceDataset(_loader(specs, rank=r, world=world), max_bytes=max_bytes)
        assert (ds.n, ds.shard_cap, ds.steps()) == (jds.n, jds.shard_cap, jds.steps())
        assert (ds.residual_loader is None) == (jds.residual_loader is None)
        cap = ds.shard_cap
        assert ds.names == jds.names[r * cap:min((r + 1) * cap, jds.n)]
        for epoch, (jidx, jvalid) in enumerate(jplans):
            ds.set_epoch(epoch)
            idx, valid = ds._shard_draws()
            for d in range(world):
                np.testing.assert_array_equal(idx[d], jidx[d])
                np.testing.assert_array_equal(valid[d], jvalid[d])
            ds.set_epoch(epoch)
            per = 8 // world
            batches = list(device_batches(ds, 64, 21, device="cpu"))[:ds._cached_steps()]
            for s, b in enumerate(batches):
                rows, ok = jidx[r][s * per:(s + 1) * per], jvalid[r][s * per:(s + 1) * per]
                want = [jds.names[r * cap + i] if v else "" for i, v in zip(rows, ok)]
                assert b["names"] == want
                np.testing.assert_array_equal(b["valid"].numpy(), ok)
                for i, name in enumerate(want):
                    if name:
                        np.testing.assert_allclose(b["image"][i].numpy(), ref[name][0], atol=1e-6)
                        np.testing.assert_array_equal(b["label"][i].numpy(), ref[name][1])
                    else:
                        assert b["index"][i] == -1


def test_sharded_cache_numbers_every_sample_once(voc_root):
    """The ``index`` of the ranks' rows numbers the cached samples 0..K−1
    once each, in the order of the global batches (the shards' rows side
    by side), and the streamed residual after them."""
    specs = pascal_voc_2012(voc_root, MODE_TRAIN)
    numbers = []
    for r in range(2):
        ds = DeviceDataset(_loader(specs, rank=r, world=2), max_bytes=3 * BPS)
        assert ds.n == 6 and ds.residual_loader is not None
        numbers += [int(i) for b in device_batches(ds, 64, 21, device="cpu")
                    for i in b["index"] if i >= 0]
    assert sorted(numbers) == list(range(len(specs)))
