"""Start the N ranks of a process group on this host, one process each.

The JAX CLI drives N devices from one process; under ``torch.distributed``
each device is a process.  :func:`spawn` starts them with the ``spawn``
start method (a fresh interpreter each: CUDA cannot be forked), joins
them into one group through a ``file://`` rendezvous in a temporary
directory (no port to pick), and watches them: a rank that fails or a
deadline that passes stops every rank and raises, so a broken collective
costs one error instead of a hang.  A SIGTERM to the launcher goes on to
every rank (``preemption_save``: each saves and returns).

    spawn(fn, 2, args, devices=["cuda:0", "cuda:1"])    # NCCL
    spawn(fn, 2, args, devices=["cpu", "cpu"])          # gloo
    spawn(fn, 2, args, devices=["cuda:0", "cuda:0"], backend="gloo")

``fn(*args)`` runs in each rank after the group is up and the rank's device
is current; it reads its rank from ``parallel.mesh``.  ``fn`` must be
importable by name (a module-level function).
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import signal
import tempfile
import time

import torch.distributed as dist

from . import mesh


def _run_rank(fn, rank: int, world: int, init_method: str, device: str, backend: str,
              group_timeout_s: float, args: tuple) -> None:
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=group_timeout_s))
    try:
        mesh.rank_device(device)
        fn(*args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, args: tuple = (), *, devices: list[str], backend: str | None = None,
          timeout_s: float | None = None, group_timeout_s: float = 1800.0) -> None:
    """Run ``fn(*args)`` on ``world`` ranks, rank r on ``devices[r]``, and
    return when every rank has returned.  ``backend`` defaults to NCCL on
    CUDA devices and gloo on the CPU.  Raises ``RuntimeError`` when a rank
    exits with an error or ``timeout_s`` passes; every rank is stopped
    first.  ``group_timeout_s`` bounds each collective's wait."""
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    backend = backend or mesh.backend_for(devices[0])
    ctx = mp.get_context("spawn")
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    with tempfile.TemporaryDirectory(prefix="dlv3_group_") as tmp:
        procs = [
            ctx.Process(target=_run_rank, daemon=True, name=f"rank{r}",
                        args=(fn, r, world, f"file://{tmp}/rendezvous", str(devices[r]), backend,
                              group_timeout_s, args))
            for r in range(world)
        ]
        for p in procs:
            p.start()
        # a SIGTERM (preemption) goes on to every rank, whose train() saves
        # its resume checkpoint and returns
        try:
            previous = signal.signal(signal.SIGTERM, lambda *_: [
                os.kill(p.pid, signal.SIGTERM) for p in procs if p.is_alive()])
        except ValueError:  # not the main thread: no handler
            previous = None

        def failed():
            return ", ".join(f"{p.name} exited with code {p.exitcode}" for p in procs
                             if p.exitcode not in (None, 0))

        failure = None
        try:
            while not failure and any(p.exitcode is None for p in procs):
                failure = failed()
                if not failure and deadline is not None and time.monotonic() > deadline:
                    failure = f"the ranks did not finish within {timeout_s:.0f} s"
                elif not failure:
                    time.sleep(0.1)
            failure = failure or failed()
        finally:
            if previous is not None:
                signal.signal(signal.SIGTERM, previous)
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
    if failure:
        raise RuntimeError(f"{world} ranks of {getattr(fn, '__name__', fn)}: {failure}")
