"""Per-process dataset shards (port of
``deeplabv3plus_keras_tpu/parallel/multihost.py:34-70``).

The JAX package's multi-host recipe gives each host its own strided shard
of the specs (:func:`shard_specs`) and then assembles the host-local
batches into global, batch-sharded ``jax.Array``s (``globalize_batch``).
That second function has no counterpart here: under ``torch.distributed``
a rank keeps its local rows (``parallel/mesh.py`` :func:`row_indices`),
the step is a local program, and only BN's statistics, the loss's
denominator and the gradients cross ranks.  The port's loaders walk the
global order on every rank and decode only the rank's rows
(``data/pipeline.py``); :func:`shard_specs` is the alternative for a
caller that splits the specs itself.
"""

from __future__ import annotations

import dataclasses

from . import mesh


def shard_specs(specs, process_index: int | None = None, process_count: int | None = None,
                mark_duplicates: bool = False):
    """This process's shard of ``specs``, padded so every process sees the
    same number of samples (and so the same step count: unequal steps would
    leave ranks waiting in each other's collectives).

    A strided split (``specs[pi::pc]``); a shard one short wraps around to
    its own first samples, and a process with no sample of its own takes
    ``specs[pi % len(specs)]``.  ``mark_duplicates=True`` stamps every such
    padding spec ``valid=False``, so the loader emits it with a 0 validity
    mask and an evaluation counts no sample twice.  Defaults: this rank of
    the process group."""
    pi = mesh.rank() if process_index is None else process_index
    pc = mesh.world_size() if process_count is None else process_count
    if pc <= 1:
        return list(specs)
    mine = list(specs[pi::pc])
    if not mine:  # more processes than samples: wrap the global list
        seed = specs[pi % len(specs)]
        if mark_duplicates:  # another process owns it
            seed = dataclasses.replace(seed, valid=False)
        mine = [seed]
    base = len(mine)
    n_steps = -(-len(specs) // pc)  # the longest shard's length
    while len(mine) < n_steps:
        dup = mine[len(mine) % base]
        if mark_duplicates:
            dup = dataclasses.replace(dup, valid=False)
        mine.append(dup)
    return mine
