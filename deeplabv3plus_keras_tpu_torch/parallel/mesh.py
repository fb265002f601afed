"""The process group as the device mesh (port of
``deeplabv3plus_keras_tpu/parallel/mesh.py``).

The JAX package turns ``multi_gpu``/``num_gpus`` into a ``('data',
'space')`` mesh of one program: parameters replicated, the batch sharded
over ``'data'`` (and the image height over ``'space'`` when the extra key
``mesh_space`` is above 1), and GSPMD inserts the collectives.  Here each
rank of a ``torch.distributed`` process group is one device of that mesh
and runs the step as a local program on its own device:

- ``hps.batch_size`` stays the **global** batch; rank r owns the rows
  :func:`row_indices` gives it;
- BatchNorm in training takes its statistics over every rank's rows
  (``models/blocks.py``), the loss divides by the global count of valid
  pixels and the gradients are summed over ranks (``parallel/step.py``), so
  N ranks compute what the N-device mesh computes.

Under ``mesh_space`` S > 1 the N = n_data × S ranks form the grid of
:func:`init_grid`: rank r is (d, s) = divmod(r, S), holds the batch rows
``row_indices(B, n_data, d)`` and the image rows :func:`rows_of` gives
position s of every activation, and fetches other ranks' rows where a
spatial op reaches them (``parallel/spatial.py``).

Collectives here are ``all_reduce`` (sum) and ``broadcast`` only: the gloo
backend carries no other collective on CUDA tensors, and two ranks that
share one card must use gloo (NCCL refuses two ranks on one device).  A
group of one rank, or none, is the one-device program: every helper is then
the identity.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

# torchrun's environment: a process started by it joins the group these
# variables describe
_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
# flat buffers of at most this many elements per gradient all-reduce
_BUCKET_ELEMS = 1 << 24


def is_active() -> bool:
    """A process group of more than one rank is initialised."""
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def world_size() -> int:
    """The number of ranks (1 without a group)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def local_rank() -> int:
    """The rank among the ranks of this host (torchrun's ``LOCAL_RANK``)."""
    return int(os.environ.get("LOCAL_RANK", rank()))


def launched_by_torchrun() -> bool:
    return all(k in os.environ for k in _LAUNCHER_ENV)


def rank_device(device=None) -> torch.device:
    """The device this rank computes on: ``device`` when given, else
    ``cuda:LOCAL_RANK``.  A CUDA device becomes the current one, so the
    kernels' launches and the collectives go to it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the ranks on the CPU")
        device = torch.device("cuda", local_rank())
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    return device


def backend_for(device: torch.device) -> str:
    """NCCL for one card a rank, gloo on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_from_env(device=None, timeout_s: float = 1800.0) -> torch.device:
    """Join the group torchrun's variables describe (NCCL on CUDA, gloo on
    the CPU) and return this rank's device.  A group the caller has
    already initialised is joined as it is."""
    dev = rank_device(device)
    if not (dist.is_available() and dist.is_initialized()):
        if not launched_by_torchrun():
            raise RuntimeError(
                f"no process group and no torchrun environment ({', '.join(_LAUNCHER_ENV)})")
        dist.init_process_group(backend_for(dev), init_method="env://",
                                timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def row_indices(batch: int, world: int | None = None, rank_: int | None = None,
                accum: int = 1) -> np.ndarray:
    """The rows of a global batch of ``batch`` that rank ``rank_`` of
    ``world`` owns (the JAX mesh's ``batch_sharding``): ``[r·B/N,
    (r+1)·B/N)``.  Under ``grad_accum`` A the step cuts the global batch into
    A microbatches of consecutive rows, each with its own BN statistics, so
    the rank owns the r-th slice of each microbatch, in microbatch order."""
    world = world_size() if world is None else world
    rank_ = rank() if rank_ is None else rank_
    accum = max(1, int(accum))
    if batch % (world * accum):
        raise ValueError(
            f"batch size {batch} must be divisible by the number of ranks {world}"
            + (f" times grad_accum {accum}" if accum > 1 else ""))
    mb, per = batch // accum, batch // (accum * world)
    return np.concatenate([np.arange(i * mb + rank_ * per, i * mb + (rank_ + 1) * per)
                           for i in range(accum)])


def rows_of(H: int, n_space: int, s: int) -> tuple[int, int]:
    """The rows [lo, hi) of a height-``H`` activation that space position
    ``s`` of ``n_space`` holds: ⌈H/S⌉ rows a position in order, the last
    positions shorter or empty.  A function of (H, S, s) alone, so every
    rank knows which rank owns which rows of every activation."""
    per = -(-H // n_space)
    lo = min(s * per, H)
    return lo, min(lo + per, H)


@dataclasses.dataclass(frozen=True)
class Grid:
    """The (data, space) grid of the ranks: this rank's position (d, s),
    the group of its row of the grid (the ranks of its data position d,
    which hold its samples: ``space_group``) and of its column (the ranks
    of its space position s: ``data_group``)."""

    n_data: int
    n_space: int
    d: int
    s: int
    space_group: object
    data_group: object

    def rows_of(self, H: int) -> tuple[int, int]:
        """This rank's rows of a height-``H`` activation."""
        return rows_of(H, self.n_space, self.s)


_grid: Grid | None = None


def init_grid(n_space: int) -> Grid | None:
    """Split the group of N ranks into the (N / n_space) × n_space grid of
    the JAX package's ``('data', 'space')`` mesh (``make_mesh``): rank r is
    (d, s) = divmod(r, n_space).  Every rank must call it, in the same
    order (``new_group`` is collective).  ``n_space`` 1 clears the grid (the
    data-parallel group of A13).  Raises ``ValueError`` where ``n_space``
    does not divide N, as the JAX facade does."""
    global _grid
    n_space = max(1, int(n_space))
    world = world_size()
    if world % n_space:
        raise ValueError(f"mesh_space {n_space} must divide num devices {world}")
    if n_space == 1:
        _grid = None
        return None
    if _grid is not None and _grid.n_space == n_space:
        return _grid
    n_data = world // n_space
    d, s = divmod(rank(), n_space)
    space_groups = [dist.new_group([i * n_space + j for j in range(n_space)])
                    for i in range(n_data)]
    data_groups = [dist.new_group([i * n_space + j for i in range(n_data)])
                   for j in range(n_space)]
    _grid = Grid(n_data, n_space, d, s, space_groups[d], data_groups[s])
    return _grid


def grid() -> Grid | None:
    """The grid of :func:`init_grid`, or None (no spatial split)."""
    return _grid if is_active() else None


def all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the ranks, in place (the identity without a group)."""
    if is_active():
        dist.all_reduce(t)
    return t


def any_rank(flag: bool, device) -> bool:
    """Whether ``flag`` is set on any rank: one all-reduce, waited for."""
    if not is_active():
        return bool(flag)
    return bool(all_reduce_(torch.tensor([float(flag)], device=device)).item() > 0)


def gather_ints(value: int, device) -> list[int]:
    """Every rank's ``value``, in rank order: a one-hot all-reduce."""
    if not is_active():
        return [int(value)]
    t = torch.zeros(world_size(), dtype=torch.float64, device=device)
    t[rank()] = float(value)
    return [int(v) for v in all_reduce_(t).tolist()]


def all_reduce_group_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over the ranks of ``group``, in place."""
    dist.all_reduce(t, group=group)
    return t


def barrier(device) -> None:
    """Every rank waits here for the others (an all-reduce of one value)."""
    if is_active():
        all_reduce_(torch.zeros(1, device=device)).item()


def _flat_groups(tensors: list[torch.Tensor]):
    """``tensors`` in runs of one dtype of at most ``_BUCKET_ELEMS``
    elements each, in order."""
    run, size = [], 0
    for t in tensors:
        if run and (t.dtype != run[0].dtype or size + t.numel() > _BUCKET_ELEMS):
            yield run
            run, size = [], 0
        run.append(t)
        size += t.numel()
    if run:
        yield run


def all_reduce_tensors_(tensors: list[torch.Tensor]) -> None:
    """Sum every tensor of ``tensors`` over the ranks, in place, through
    flat buffers (a few large all-reduces instead of one per tensor)."""
    if not is_active():
        return
    for run in _flat_groups(tensors):
        flat = torch.cat([t.reshape(-1) for t in run])
        dist.all_reduce(flat)
        torch._foreach_copy_(run, [v.view_as(t) for v, t in zip(flat.split([t.numel() for t in run]), run)])


def broadcast_tensors_(tensors: list[torch.Tensor], src: int = 0) -> None:
    """Rank ``src``'s values of ``tensors`` on every rank, in place."""
    if not is_active():
        return
    for run in _flat_groups(tensors):
        flat = torch.cat([t.reshape(-1) for t in run])
        dist.broadcast(flat, src)
        torch._foreach_copy_(run, [v.view_as(t) for v, t in zip(flat.split([t.numel() for t in run]), run)])


class RankDraws:
    """The random streams of one rank's rows of a global batch, under a
    process group (``parallel/step.py``): a draw for each sample
    (EfficientNet's stochastic depth) is made for all ``batch`` rows from
    ``shared``, the same stream on every rank, and the rank keeps its
    ``rows`` (a device index tensor), so N ranks draw what one process
    draws; an element-wise mask comes from ``local``, this rank's own
    stream.  ``get_state``/``set_state`` wind both, for the remat
    recompute."""

    def __init__(self, shared: torch.Generator, local: torch.Generator, rows: torch.Tensor,
                 batch: int):
        self.shared, self.local, self.rows, self.batch = shared, local, rows, batch

    def get_state(self):
        return self.shared.get_state(), self.local.get_state()

    def set_state(self, state) -> None:
        self.shared.set_state(state[0])
        self.local.set_state(state[1])


class StopAgreement:
    """A stop request (a SIGTERM on some rank) that every rank acts on at
    the same step of a loop.  :meth:`poll` hands this step's flag to an
    all-reduce and returns the previous step's agreed flag, so the loop
    waits on the device one step late, not every step (:func:`any_rank`
    agrees at once).  Without a group it returns the flag itself."""

    def __init__(self, device):
        self.device = device
        self._pending: torch.Tensor | None = None

    def poll(self, flag: bool) -> bool:
        if not is_active():
            return bool(flag)
        agreed, self._pending = self._pending, all_reduce_(
            torch.tensor([float(flag)], device=self.device))
        return agreed is not None and agreed.item() > 0
