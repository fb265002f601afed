"""Host data loading: threaded decode and prefetch feeding the on-device
preprocessing (port of ``deeplabv3plus_keras_tpu/data/pipeline.py:27-520,
631-788``).

Host threads only decode images and paste raw uint8 pixels into
fixed-size canvases (the reference's ``OrderedEnqueuer`` workers, knobs
``workers``/``max_queue_size``); :func:`device_batches` copies the uint8
canvases to the card from pinned host memory and runs
``ops.preprocess.prepare_batch`` there (resize, pad, normalise, one-hot).

The ragged last batch is emitted at full batch size with a 0/1 ``valid``
mask, so every step sees one batch shape.  Every batch of
:func:`device_batches` also carries ``index``, each row's number in the
epoch's sample order (−1 for padding), which names evaluate()'s result
files.

Under a process group of N ranks (``parallel/mesh.py``) ``batch_size`` is
the global batch: every rank walks the same global order (the same
``seed + epoch`` shuffle) and decodes only its own rows of each global
batch (``mesh.row_indices``), so every rank takes the same number of steps
and N ranks see the batches one process sees.  The padding of a ragged
last batch falls on whichever rank owns those rows.  Under ``mesh_space``
the rows are those of the rank's data position (``rank``/``world`` are
then its data position and the count of them): the ranks of one space
group load the same whole images, and the facade's steps take each
rank's image rows of them on the device, after the gather of a cached
batch too (the JAX package's ``h_slice``).

:class:`DeviceDataset` (config key ``cache_device``) keeps the decoded
uint8 canvases in device memory, so epochs after the build gather their
batches there and decode nothing on the host.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, Sequence

import numpy as np
import torch

from ..parallel import mesh
from ..utils.profiling import span
from .voc import SampleSpec


def load_sample(spec: SampleSpec):
    """Decode one image (+ optional label) to raw uint8 arrays."""
    from PIL import Image

    img = np.asarray(Image.open(spec.image_path).convert("RGB"), np.uint8)
    lab = None
    if spec.label_path is not None:
        lab = np.asarray(Image.open(spec.label_path), np.uint8)
        if lab.ndim == 3:
            lab = lab[..., 0]
        if spec.label_remap_value is not None:
            # Open Images masks: value 1 → class index (reference :1358-1359).
            lab = np.where(lab == 1, np.uint8(spec.label_remap_value), lab)
    return img, lab


class HostLoader:
    """Iterates batches of raw canvases.

    Yields dicts: image_canvas (B,CH,CW,3) u8, sizes (B,2) i32,
    label_canvas (B,CH,CW) u8 | None, valid (B,) i32, names [str].

    Oversized images (long side > canvas) are symmetric-downscaled on host
    to the network target geometry (``oversize_target``, defaulting to the
    canvas size) with the reference's resize-anything semantics
    (semantic_segmentation.py:200-280) — no content is cropped; the device
    kernel's subsequent resize is then an exact identity.

    ``cache=True`` keeps each decoded (and, if oversized, downscaled) uint8
    sample in host RAM so epochs ≥ 2 skip JPEG/PNG decode entirely — the
    reference re-decodes every image every epoch (:1515-1603).  Numerics
    are unchanged (the cache stores the exact ``_load`` output).  Memory:
    ≤ canvas² × 4 bytes/sample ≈ 1 MiB at 512², ~11 GiB for the full
    10,582-image VOC-Aug train split.

    ``backend``: "auto" (default) decodes batches through the native C++
    fastloader when it is buildable (one GIL-free C call per batch with an
    internal thread pool; bit-identical to PIL — see native/fastloader.cpp),
    falling back to PIL per item for oversized/unusual inputs; "pil" forces
    the pure-Python path; "native" requires the C++ loader.

    ``rank``/``world``: this rank of a process group of ``world`` ranks; it
    yields only its ``mesh.row_indices(batch_size, world, rank, accum)``
    rows of each global batch (``accum``: the train step's ``grad_accum``,
    whose microbatches each rank slices).
    """

    def __init__(
        self,
        specs: Sequence[SampleSpec],
        batch_size: int,
        canvas_size: int = 512,
        workers: int = 2,
        max_queue_size: int = 8,
        shuffle: bool = False,
        seed: int = 1024,
        with_labels: bool = True,
        oversize_target: int | None = None,
        label_clamp: int | None = None,
        cache: bool = False,
        backend: str = "auto",
        rank: int = 0,
        world: int = 1,
        accum: int = 1,
    ):
        self.specs = list(specs)
        self.batch_size = batch_size
        self.rank, self.world, self.accum = int(rank), int(world), max(1, int(accum))
        # this rank's rows of a global batch (all of them for one rank)
        self.rows = mesh.row_indices(batch_size, self.world, self.rank, self.accum)
        self.canvas_size = canvas_size
        self.workers = max(1, workers)
        self.max_queue_size = max(2, max_queue_size)
        self.shuffle = shuffle
        self.seed = seed
        self.with_labels = with_labels
        self.oversize_target = oversize_target or canvas_size
        self.label_clamp = label_clamp
        self.cache = cache
        self._cache: dict[str, tuple] = {}
        if backend not in ("auto", "native", "pil"):
            raise ValueError(f"unknown loader backend {backend!r}")
        if backend == "native":
            from .. import native

            if not native.native_available():
                raise RuntimeError(
                    "loader backend 'native' requested but the fastloader "
                    "library cannot be built (needs g++ + libjpeg/libpng)"
                )
        self.backend = backend
        self.epoch = 0

    def _use_native(self) -> bool:
        if self.backend == "pil":
            return False
        from .. import native

        return native.native_available()

    def __len__(self):
        """Number of batches incl. the padded tail (reference ceil-steps
        :1487-1509)."""
        n = len(self.specs)
        return (n + self.batch_size - 1) // self.batch_size

    def steps(self) -> int:
        return len(self)

    def set_epoch(self, epoch: int) -> None:
        """Fast-forward the epoch counter so the NEXT iteration shuffles
        with ``default_rng(seed + epoch)`` — resuming a preempted run at
        epoch k reproduces exactly the data order epoch k originally had."""
        self.epoch = int(epoch)

    def _order(self):
        idx = np.arange(len(self.specs))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        return idx

    def _load(self, spec):
        """Decode one spec (downscaling oversized inputs); RAM-cached when
        ``cache`` is on.  Dict writes are atomic under the GIL, so the worst
        concurrent-worker case is a redundant decode, never a torn entry."""
        if self.cache:
            hit = self._cache.get(spec.image_path)
            if hit is not None:
                return hit
        img, lab = load_sample(spec)
        h, w = img.shape[:2]
        if h > self.canvas_size or w > self.canvas_size:
            from ..ops.preprocess import host_symmetric_downscale

            img, lab = host_symmetric_downscale(
                img, lab, self.oversize_target, self.label_clamp
            )
        if self.cache:
            self._cache[spec.image_path] = (img, lab)
        return img, lab

    def _decode_native(self, batch_specs):
        """Decode the batch's cache misses in one GIL-free C call.

        Returns {position: (img, lab)} for the items the native loader
        handled; anything else (cache hits, oversized, odd formats) is left
        to the per-item Python path.
        """
        from .. import native

        need = [
            (i, s)
            for i, s in enumerate(batch_specs)
            if not (self.cache and s.image_path in self._cache)
        ]
        if not need:
            return {}
        CH = self.canvas_size
        scratch_img = np.zeros((len(need), CH, CH, 3), np.uint8)
        scratch_lab = (
            np.zeros((len(need), CH, CH), np.uint8) if self.with_labels else None
        )
        sizes = np.zeros((len(need), 2), np.int32)
        # two pool layers multiply: `workers` concurrent _assemble calls
        # each spawn a C pool, so size the inner pool to ncpu/workers
        nthreads = max(1, (os.cpu_count() or 1) // self.workers)
        status = native.assemble_batch(
            [s for _, s in need], scratch_img, scratch_lab, sizes,
            nthreads=nthreads,
        )
        out = {}
        for j, (i, spec) in enumerate(need):
            if status[j] != native.FL_OK:
                continue  # oversized / fallback / error → Python path
            h, w = sizes[j]
            img = scratch_img[j, :h, :w]
            lab = (
                scratch_lab[j, :h, :w]
                if self.with_labels and spec.label_path is not None
                else None
            )
            if self.cache:
                img = img.copy()  # detach from the batch scratch buffer
                lab = None if lab is None else lab.copy()
                self._cache[spec.image_path] = (img, lab)
            out[i] = (img, lab)
        return out

    def _assemble(self, batch_specs):
        B, CH = len(self.rows), self.canvas_size
        img_canvas = np.zeros((B, CH, CH, 3), np.uint8)
        lab_canvas = np.zeros((B, CH, CH), np.uint8) if self.with_labels else None
        sizes = np.ones((B, 2), np.int32)
        valid = np.zeros((B,), np.int32)
        names = []
        decoded = self._decode_native(batch_specs) if self._use_native() else {}
        for i, spec in enumerate(batch_specs):
            img, lab = decoded[i] if i in decoded else self._load(spec)
            h, w = img.shape[:2]
            img_canvas[i, :h, :w] = img
            if lab_canvas is not None and lab is not None:
                lab_canvas[i, :h, :w] = lab
            sizes[i] = (h, w)
            # spec.valid=False → multi-host padding duplicate: decoded for
            # shape stability, excluded from loss/CM via the batch mask
            valid[i] = 1 if getattr(spec, "valid", True) else 0
            names.append(spec.name)
        return {
            "image_canvas": img_canvas,
            "sizes": sizes,
            "label_canvas": lab_canvas,
            "valid": valid,
            "names": names,
        }

    def __iter__(self) -> Iterator[dict]:
        order = self._order()
        # this rank's rows of each global batch: positions in the epoch's
        # order (increasing, so the real ones come first and a ragged last
        # batch pads at the end)
        batches = []
        for start in range(0, len(order), self.batch_size):
            batches.append([self.specs[order[p]] for p in start + self.rows if p < len(order)])
        self.epoch += 1

        if self.workers <= 1:
            for b in batches:
                yield self._assemble(b)
            return

        # Ordered multi-threaded prefetch: per-batch slots filled by a
        # worker pool, consumed in order (OrderedEnqueuer semantics).
        slots: list[queue.Queue] = [queue.Queue(maxsize=1) for _ in batches]
        todo = queue.Queue()
        for i, b in enumerate(batches):
            todo.put((i, b))
        inflight = threading.Semaphore(self.max_queue_size)
        stop = threading.Event()

        def worker():
            while not stop.is_set():
                # Acquire the inflight credit BEFORE dequeuing a task.
                # The reverse order deadlocks: threading.Semaphore is
                # unfair, so the worker holding the OLDEST batch (the one
                # the in-order consumer is blocked on) can lose every
                # credit race to workers holding later batches — whose
                # filled slots the consumer can never reach — wedging all
                # credits permanently (observed as a full-suite hang in
                # the 1805-batch epoch-bookkeeping test).  Credit-first,
                # a worker never holds a task it cannot assemble, so the
                # oldest task is always picked up by a credited worker.
                # The acquire is also stop-aware: a consumer that
                # abandons iteration (error, preemption, early break)
                # sets `stop` but cannot release credits, so a plain
                # acquire would park this thread forever.
                while not inflight.acquire(timeout=0.1):
                    if stop.is_set():
                        return
                try:
                    i, b = todo.get_nowait()
                except queue.Empty:
                    inflight.release()
                    return
                try:
                    slots[i].put(self._assemble(b))
                except BaseException as e:  # surface errors to consumer —
                    # a slot left unfilled hangs the in-order consumer
                    slots[i].put(e)

        threads = [
            threading.Thread(
                target=worker, daemon=True, name="hostloader-worker"
            )
            for _ in range(self.workers)
        ]
        for t in threads:
            t.start()
        try:
            for i in range(len(batches)):
                item = slots[i].get()
                inflight.release()
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()


def _auto_device_budget(device: torch.device) -> int | None:
    """Half the free memory of a CUDA ``device`` (the training step still
    needs room for activations; parameters and optimizer state are
    already allocated); no limit elsewhere (the JAX package's
    ``_auto_hbm_budget``)."""
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    return int(free) // 2


class DeviceDataset:
    """The decoded dataset resident in device memory (config key
    ``cache_device``; port of the JAX package's ``DeviceDataset``, one
    device).  Every decoded uint8 canvas, label canvas and (h, w) lives in
    a tensor on ``device``; an epoch gathers its batches there by index
    (``index_select``) and preprocesses them (``prepare_batch_from_cache``),
    so epochs after the build move only the (B,) indices and validity
    flags to the card.  Memory: canvas² × 4 bytes a sample (1 MiB at 512²;
    about 11 GiB for VOC-Aug's 10,582 training images).

    The cache holds at most ``max_bytes`` (config
    ``cache_device_max_bytes``; default half the card's free memory, no
    limit on the CPU): the first K samples that fit are cached, the rest
    stream through a residual :class:`HostLoader` each epoch, and one line
    states the split.  K = 0 is the plain host path (with the host RAM
    cache when ``residual_cache``).

    Built by draining ``loader`` once in spec order (a SIGTERM during the
    build unwinds as ``Preempted``); each epoch then shuffles with the
    loader's formula, ``default_rng(seed + epoch)`` over ``arange``, so a
    full cache gives the host path's batches in its order (a partial cache
    shuffles the cached and the streamed samples apart).

    Sharded, for a ``loader`` of rank r of N > 1 ranks (the JAX package's
    layout over a mesh's ``'data'`` axis): the K cached samples are padded
    to N shards of ``shard_cap`` = steps · B/N rows, and rank r caches and
    decodes only shard r, rows [r·shard_cap, (r+1)·shard_cap) of the spec
    order.  Each epoch every rank draws the plan of every shard from one
    ``default_rng(seed + epoch)`` stream (:meth:`_shard_draws`, as JAX's)
    and gathers its B/N rows a step from its own shard: no collective in
    the input path.  The global batch is then the shards' rows side by
    side, so its composition differs from the single-stream order (every
    sample still once an epoch).  ``max_bytes`` is per device (the least
    of the ranks' budgets when none is given), and a partial cache rounds K
    down to a multiple of N.  Under ``grad_accum`` a rank's microbatches
    come from its own shard, where the JAX step regroups the global batch's
    rows across devices (ROADMAP.md, known divergences)."""

    def __init__(self, loader: HostLoader, device=None, max_bytes: int | None = None,
                 residual_cache: bool = False):
        import copy

        from ..utils.preemption import PreemptionGuard

        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self.batch_size = loader.batch_size
        self.shuffle = loader.shuffle
        self.seed = loader.seed
        self.with_labels = loader.with_labels
        self.epoch = loader.epoch
        self.shards, self.rank = loader.world, loader.rank

        n_specs = len(loader.specs)
        CH = loader.canvas_size
        bps = CH * CH * (4 if loader.with_labels else 3) + 8  # image, label, sizes
        if max_bytes is None:
            max_bytes = _auto_device_budget(self.device)
            if max_bytes is not None and mesh.is_active():
                max_bytes = min(mesh.gather_ints(max_bytes, self.device))
        cap_n = n_specs if max_bytes is None else min(
            n_specs, self.shards * (max(0, int(max_bytes)) // bps))
        if self.shards > 1 and cap_n < n_specs:
            # every shard the same size
            cap_n = (cap_n // self.shards) * self.shards
        if cap_n < n_specs:
            print(f"cache_device: HBM budget fits {cap_n}/{n_specs} samples "
                  f"({cap_n * bps / 2**30:.2f} GiB cached"
                  + (f" per {self.shards}-way shard set" if self.shards > 1 else "")
                  + f"); streaming the remaining {n_specs - cap_n} through the host pipeline "
                  "each epoch")

        # the rows this device caches: all K, or its shard of them
        source = loader
        want = cap_n
        if self.shards > 1:
            self.n = cap_n
            self.shard_cap = self._cached_steps() * (self.batch_size // self.shards)
            lo = min(self.rank * self.shard_cap, cap_n)
            hi = min(lo + self.shard_cap, cap_n)
            source = copy.copy(loader)
            source.specs = list(loader.specs[lo:hi])
            source.rank, source.world, source.accum = 0, 1, 1
            source.rows = np.arange(self.batch_size)
            source._cache = loader._cache
            want = hi - lo

        # the device buffers, filled batch by batch as the host decodes
        u8 = dict(dtype=torch.uint8, device=self.device)
        img = torch.zeros((max(want, 1), CH, CH, 3), **u8)
        lab = torch.zeros((max(want, 1), CH, CH), **u8) if loader.with_labels else None
        sizes = torch.ones((max(want, 1), 2), dtype=torch.int32, device=self.device)
        names = []
        orig_shuffle, orig_epoch = source.shuffle, source.epoch
        source.shuffle = False
        try:
            for b in source if want else ():
                # minutes of decode at full size: a SIGTERM unwinds here so
                # the caller can save and exit
                PreemptionGuard.check_active()
                rows = np.flatnonzero(b["valid"].astype(bool))[: want - len(names)]
                if not len(rows):
                    break
                got = slice(len(names), len(names) + len(rows))
                img[got] = _to_device(b["image_canvas"][rows], self.device)
                if lab is not None and b["label_canvas"] is not None:
                    lab[got] = _to_device(b["label_canvas"][rows], self.device)
                sizes[got] = _to_device(b["sizes"][rows], self.device)
                names += [b["names"][r] for r in rows]
                if len(names) >= want:
                    break
        finally:
            source.shuffle, source.epoch = orig_shuffle, orig_epoch

        # the specs beyond the cached prefix stream through a host loader
        self.residual_loader = None
        if cap_n < n_specs:
            residual = copy.copy(loader)
            residual.specs = list(loader.specs[cap_n:])
            residual.cache = residual_cache
            residual._cache = {}
            residual.epoch = self.epoch
            self.residual_loader = residual

        self.names = names
        if self.shards == 1:
            self.n = len(names)
        # a shard keeps at least its one zero row, for its padding draws
        held = max(len(names), 1) if self.shards > 1 else len(names)
        self.data_img = img[:held] if held else None
        self.data_lab = lab[:held] if held and lab is not None else None
        self.data_sizes = sizes[:held] if held else None

    def _cached_steps(self) -> int:
        return (self.n + self.batch_size - 1) // self.batch_size

    def __len__(self):
        residual = self.residual_loader.steps() if self.residual_loader else 0
        return self._cached_steps() + residual

    def steps(self) -> int:
        return len(self)

    def set_epoch(self, epoch: int) -> None:
        """Fast-forward the epoch counter, the streamed residual's too (see
        :meth:`HostLoader.set_epoch`)."""
        self.epoch = int(epoch)
        if self.residual_loader is not None:
            self.residual_loader.set_epoch(epoch)

    def _order(self):
        order = np.arange(self.n)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        return order

    def _shard_draws(self):
        """The epoch's plan of every shard d (the JAX package's
        ``DeviceDataset._shard_draws``): (steps · B/N,) local row ids, a
        permutation of shard d's real rows (its first min(n − d·cap, cap)
        rows) padded with 0, and their 0/1 validity; all shards' plans from
        one ``default_rng(seed + epoch)`` stream, in shard order."""
        cap, D = self.shard_cap, self.shards
        rng = np.random.default_rng(self.seed + self.epoch)
        idx, valid = [], []
        for d in range(D):
            count = int(np.clip(self.n - d * cap, 0, cap))
            perm = rng.permutation(count) if self.shuffle else np.arange(count)
            draws = np.zeros((cap,), np.int32)
            draws[:count] = perm
            ok = np.zeros((cap,), np.int32)
            ok[:count] = 1
            idx.append(draws)
            valid.append(ok)
        return idx, valid


def _device_dataset_batches(ds: DeviceDataset, image_size: int, num_classes: int,
                            with_labels: bool, one_hot_labels: bool) -> Iterator[dict]:
    """One epoch of ``ds``: its cached samples gathered and preprocessed on
    its device, then the uncached suffix streamed (same seed + epoch
    formula).  Sharded, this rank's B/N rows a step from its own shard."""
    from ..ops.preprocess import prepare_batch_from_cache

    epoch_now = ds.epoch
    cached_labels = with_labels and ds.data_lab is not None
    if ds.shards > 1:
        draws, valids = ds._shard_draws()
        per = ds.batch_size // ds.shards
        steps = ds._cached_steps()
        # each row's number in the order of the global batches (every
        # shard's rows of a step side by side)
        v = np.stack(valids).reshape(ds.shards, steps, per).transpose(1, 0, 2)
        number = np.where(v > 0, np.cumsum(v).reshape(v.shape) - 1, -1)
        plan = []
        for s in range(steps):
            idx, valid = draws[ds.rank][s * per:(s + 1) * per], valids[ds.rank][s * per:(s + 1) * per]
            # a placeholder name where a row is padding (inside the batch)
            plan.append((idx, valid, number[s, ds.rank],
                         [ds.names[i] if ok else "" for i, ok in zip(idx, valid)]))
    else:
        order = ds._order()
        B = ds.batch_size
        plan = []
        for s in range(0, ds.n, B):
            sel = order[s:s + B]
            valid = np.zeros((B,), np.int32)
            valid[:len(sel)] = 1
            idx = np.zeros((B,), np.int64)
            idx[:len(sel)] = sel
            plan.append((idx, valid, np.where(valid > 0, s + np.arange(B), -1),
                         [ds.names[i] for i in sel]))
    ds.epoch += 1
    for idx, valid, number, names in plan:
        with span("dlv3.data.batch"):
            valid_t = _to_device(valid, ds.device)
            images, labels = prepare_batch_from_cache(
                ds.data_img, ds.data_lab if cached_labels else None, ds.data_sizes,
                _to_device(idx.astype(np.int64), ds.device), valid_t, size=image_size,
                num_classes=num_classes, with_labels=cached_labels, one_hot_labels=one_hot_labels)
        out = {"image": images, "valid": valid_t, "index": number, "names": names}
        if cached_labels:
            out["label"] = labels
        yield out

    if ds.residual_loader is not None:
        ds.residual_loader.epoch = epoch_now
        yield from device_batches(ds.residual_loader, image_size, num_classes, with_labels,
                                  one_hot_labels, device=ds.device, first_index=ds.n)


def _to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``: to a card through pinned memory and an
    asynchronous copy (the pinned block is reused only after the copy has
    finished: the caching host allocator records it), else as is."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def device_batches(loader: HostLoader | DeviceDataset, image_size: int, num_classes: int,
                   with_labels: bool = True, one_hot_labels: bool = True,
                   host_prepro: bool = False, device=None,
                   first_index: int = 0) -> Iterator[dict]:
    """Batches of ``loader`` ready for a step on ``device``: dicts of
    ``image`` (B, S, S, 3) float32, ``label`` (one-hot (B, S, S, C) float32
    or int32 (B, S, S)) when ``with_labels``, ``valid`` (B,) int32, all on
    ``device``, ``names`` and ``index`` (each row's number in the epoch's
    sample order from ``first_index``, −1 for padding; a host array).

    Only the uint8 canvases and their sizes cross to the device;
    ``prepare_batch`` runs there.  Double-buffered: batch N+1's copy and
    preprocessing are queued before batch N is yielded, so they overlap
    the consumer's step.  ``host_prepro=True`` is the reference's
    ``prepro_device == -1`` path (per-sample SciPy resize on the host,
    ``ops.preprocess.host_prepare_sample``).  ``device`` defaults to the
    first CUDA card, never to the CPU.  A :class:`DeviceDataset` yields its
    batches from its own device, ``device`` and ``host_prepro`` aside."""
    from ..ops.preprocess import host_prepare_sample, prepare_batch

    if isinstance(loader, DeviceDataset):
        yield from _device_dataset_batches(loader, image_size, num_classes, with_labels,
                                           one_hot_labels)
        return

    if device is None and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to preprocess "
                           "on the CPU")
    device = torch.device(device if device is not None else "cuda")

    def numbers(k, valid):
        return np.where(valid > 0, first_index + k * loader.batch_size + loader.rows, -1)

    if host_prepro:
        for k, host_batch in enumerate(loader):
            B = host_batch["sizes"].shape[0]
            images = np.zeros((B, image_size, image_size, 3), np.float32)
            labels = (np.zeros((B, image_size, image_size, num_classes), np.float32)
                      if with_labels else None)
            for i in range(B):
                if not host_batch["valid"][i]:
                    continue
                h, w = host_batch["sizes"][i]
                img = host_batch["image_canvas"][i, :h, :w]
                lab = (host_batch["label_canvas"][i, :h, :w]
                       if with_labels and host_batch["label_canvas"] is not None else None)
                im, oh = host_prepare_sample(img, lab, image_size, num_classes)
                images[i] = im
                if labels is not None and oh is not None:
                    labels[i] = oh
            out = {"image": _to_device(images, device),
                   "valid": _to_device(host_batch["valid"], device),
                   "names": host_batch["names"], "index": numbers(k, host_batch["valid"])}
            if with_labels:
                lab_t = _to_device(labels, device)
                out["label"] = lab_t if one_hot_labels else lab_t.argmax(-1).to(torch.int32)
            yield out
        return

    def to_device(k, host_batch):
        lab = host_batch["label_canvas"] if with_labels else None
        with span("dlv3.data.batch"):
            images, labels = prepare_batch(
                _to_device(host_batch["image_canvas"], device),
                _to_device(host_batch["sizes"], device),
                None if lab is None else _to_device(lab, device),
                size=image_size, num_classes=num_classes, with_labels=with_labels,
                one_hot_labels=one_hot_labels)
            valid = _to_device(host_batch["valid"], device)
        out = {"image": images, "valid": valid,
               "names": host_batch["names"], "index": numbers(k, host_batch["valid"])}
        if with_labels:
            out["label"] = labels
        return out

    prev = None
    for k, host_batch in enumerate(loader):
        cur = to_device(k, host_batch)
        if prev is not None:
            yield prev
        prev = cur
    if prev is not None:
        yield prev
