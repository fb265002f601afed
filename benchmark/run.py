"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number beside its limit; the same numbers are the
last lines of standard error.

A cell on N > 1 chips runs as N processes, one a card (this one is rank 0
and prints the result), joined in a ``torch.distributed`` process group;
its kind decides what the ranks do together.  The device's memory peak is
the fullest card's, busy seconds the ranks' mean, and every rank's
compared numbers count.

Exits 2 without a result where no CUDA card (or fewer than the cell asks
for) is present, 3 where ``jax``, ``jaxlib``, ``flax`` or the JAX package
is loaded once the window has closed (in any rank), and 4 where a rank
failed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # the process's start, for setup_s

import argparse  # noqa: E402
import json  # noqa: E402
import multiprocessing  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "deeplabv3plus_keras_tpu")


def forbidden_modules() -> list[str]:
    """The forbidden top-level names among the loaded modules, compared
    whole (the program's own package name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def configure(repo) -> None:
    """Build and kernel caches at fixed directories inside the checkout;
    float32 without TF32."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(repo / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(repo / "build" / "triton")
    os.environ["USE_FLAX"] = "0"


def set_precision(config: dict) -> None:
    import torch

    tf32 = bool(config["tf32"])
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout.strip().splitlines()
        return out[0] if out else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def execute(cell, seed: int, seconds: float, traced: bool, device: str = "cuda",
            t0: float | None = None, patch=None) -> dict:
    """One run of ``cell`` in this process: set-up, the window, the check.
    ``patch`` is called with the loop once the program is built, before
    the warm-up (a planted fault, or the reference in the program's
    place)."""
    import torch

    from . import counts, loops
    from .trace import Trace, events_of

    set_precision(cell.config)
    spans = loops.Spans(traced)
    loop = cell.loop_class()(cell, seed, device, spans, patch)
    try:
        loop.setup()
        counted = None
        if traced:
            train = loop.kind == "train"
            flops, sites = counts.model_flops(loop.arch, loop.batch, loop.size, train,
                                              float(loop.conf["hps"]["weight_decay"]))
            dtype_bytes, model_peak = counts.precision(cell.config)
            counted = (flops, counts.depthwise_least_s(sites, train, dtype_bytes), model_peak)
            loop.hooks = loops.site_hooks(loop.seg.model, loop.weights)
        setup_s = time.perf_counter() - (T0 if t0 is None else t0)
        if traced:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.device(device).type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            with profile(activities=activities) as prof:
                measured = loop.window(seconds)
        else:
            measured = loop.window(seconds)
        checked = loop.check()
    finally:
        loop.close()
    result = {"correct": None, "attempted": measured["attempted"], "failed": measured["failed"]}
    if traced:
        t_read = time.perf_counter()
        tr = Trace(events_of(prof))
        del prof
        ctx = types.SimpleNamespace(kind=loop.kind, trace=tr, units=measured["units"],
                                    flops_per_unit=counted[0], dw_least_s_per_unit=counted[1],
                                    model_peak_flop_per_s=counted[2], host=spans.seconds,
                                    peaks=counts.peaks(), batch=loop.batch,
                                    window_s=measured["window_s"])
        metrics = {}
        for m in cell.per_layer:
            value = cell.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
        site_s = tr.site_device_s()
        t_read = time.perf_counter() - t_read
    else:
        values = dict(measured["metrics"], setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    result["metrics"] = metrics
    dev = torch.device(device)
    result["device"] = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": torch.distributed.get_world_size() if torch.distributed.is_initialized() else 1,
        "memory_peak_bytes": measured["memory_peak_bytes"],
    }
    if traced:
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = breakdown
    checks = {name: {"value": v, "limit": cell.limits[name]}
              for name, v in checked["numbers"].items()}
    result["correct"] = all(c["value"] <= c["limit"] for c in checks.values())
    result["detail"] = dict(checked["detail"], setup_phases_s=loop.phases,
                            warmup_s=getattr(loop, "warmup_s", None),
                            host_ms={k: 1e3 * sum(v) / len(v) for k, v in spans.seconds.items()
                                     if k != "window"})
    if traced:
        result["detail"].update(dw_site_device_s=list(site_s), trace_read_s=t_read,
                                trace_events=len(tr.device) + len(tr.cpu))
    result["checks"] = checks
    return result


def result_line(result: dict) -> str:
    """The result as the one JSON line a run prints last."""
    return json.dumps(result)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _rank(rank: int, world: int, init: str, workload: str, repo: str, bench_dir: str,
          seed: int, seconds: float, traced: bool, device_type: str, backend: str):
    """One rank of a cell on several chips: its run, then every rank's
    part gathered; rank 0 returns the merged result, the others None."""
    import torch
    import torch.distributed as dist

    from pathlib import Path

    from . import cells

    configure(Path(repo))
    cell = cells.load(workload, Path(repo), Path(bench_dir))
    device = "cpu"
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        device = f"cuda:{rank}"
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank)
    try:
        result = execute(cell, seed, seconds, traced, device)
        dev = result["device"]
        part = {"memory_peak_bytes": dev["memory_peak_bytes"], "busy_s": dev.get("busy_s"),
                "checks": result["checks"], "forbidden": forbidden_modules()}
        parts = [None] * world
        dist.all_gather_object(parts, part)
    finally:
        dist.destroy_process_group()
    if rank:
        return None
    dev["memory_peak_bytes"] = max(p["memory_peak_bytes"] for p in parts)
    if traced:
        dev["busy_s"] = sum(p["busy_s"] for p in parts) / world
    for name, c in result["checks"].items():
        c["value"] = max(p["checks"][name]["value"] for p in parts)
    result["correct"] = all(c["value"] <= c["limit"] for c in result["checks"].values())
    result["forbidden"] = sorted({m for p in parts for m in p["forbidden"]})
    return result


def ranks(cell, seed: int, seconds: float, traced: bool, device_type: str = "cuda",
          backend: str = "nccl") -> dict | None:
    """``cell`` on ``cell.chips`` ranks: ranks 1 … N − 1 in processes of their
    own, rank 0 in this one.  The merged result, or None where a rank
    failed."""
    world = cell.chips
    ctx = multiprocessing.get_context("spawn")
    args = (world, f"tcp://localhost:{_free_port()}", cell.name, str(cell.bench_dir.parent),
            str(cell.bench_dir), seed, seconds, traced, device_type, backend)
    procs = [ctx.Process(target=_rank, args=(r, *args)) for r in range(1, world)]
    for p in procs:
        p.start()
    result = None
    try:
        result = _rank(0, *args)
    finally:
        for p in procs:
            p.join(timeout=None if result is not None else 60)
            if p.is_alive():
                p.terminate()
                p.join()
    if any(p.exitcode != 0 for p in procs):
        return None
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from . import cells

    cell = cells.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    configure(cells.REPO)
    from .loops import port

    port()  # the program, or no run: a checkout without it stops here
    if cell.chips == 1:
        result = execute(cell, args.seed, args.seconds, bool(args.trace))
        bad = forbidden_modules()
    else:
        result = ranks(cell, args.seed, args.seconds, bool(args.trace))
        if result is None:
            print("a rank failed", file=sys.stderr)
            return 4
        bad = result.pop("forbidden")
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    result["device"]["power_limit"] = power_limit()
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(result_line(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
