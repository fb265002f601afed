"""Build the package's CUDA sources with ``nvcc`` and bind them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, ``build/kernels/<name>-<hash>.so`` at the repository root, keyed
by a hash of the source and the build command, so an edited source builds
anew and an unchanged one is reused.  Nothing is built when a module is
imported: :func:`load` builds on the first call that needs a kernel, and
:func:`build_all` starts one ``nvcc`` per source, all at once, for callers
that want every kernel ready up front.

No ``torch.utils.cpp_extension``: a source that includes PyTorch's headers
takes minutes to compile, a plain C interface seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH); the CUDA "
            "kernels build only on a machine with the CUDA toolkit"
        )
    return found


def build_command(src: Path, out: Path, nvcc: str = "nvcc") -> list[str]:
    """The nvcc invocation for one source (Hopper only: ``sm_90a``)."""
    return [
        nvcc,
        "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-o", str(out), str(src),
    ]


def ptxas_report(name: str) -> list[dict]:
    """What ``nvcc -Xptxas -v`` says of each kernel of ``csrc/<name>.cu``
    (one extra ``-cubin`` compile with the build's flags): registers,
    spill stores and spill loads in bytes, per kernel, names demangled
    where ``c++filt`` exists."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = build_command(CSRC / f"{name}.cu", BUILD_DIR / f"{name}.cubin", nvcc_path())
    cmd = [a for a in cmd if a not in ("-shared", "-Xcompiler", "-fPIC")] + ["-cubin", "-Xptxas", "-v"]
    done = subprocess.run(cmd, capture_output=True, text=True, check=True)
    log = done.stderr + done.stdout
    rows, cur = [], None
    for line in log.splitlines():
        if m := re.search(r"Function properties for (\S+)", line):
            cur = {"kernel": m.group(1)}
            rows.append(cur)
        elif cur and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        elif (m := re.search(r"Used (\d+) registers", line)) and rows:
            rows[-1]["registers"] = int(m.group(1))
    if shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(r["kernel"] for r in rows),
                               capture_output=True, text=True, check=True).stdout.splitlines()
        for r, n in zip(rows, names):
            r["kernel"] = n
    return rows


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(build_command(Path("s"), Path("o"))).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    out = _target(name)
    if out.is_file():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = build_command(CSRC / f"{name}.cu", tmp, nvcc_path())
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish(name: str, started) -> str | None:
    """Wait for one build; the nvcc log if it failed, else None."""
    if started is None:
        return None
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return f"nvcc failed for csrc/{name}.cu:\n{log}"
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return None


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all() -> None:
    """Build every ``csrc/*.cu`` that is not built yet, in parallel."""
    names = sources()
    with _lock:
        started = {n: _start(n) for n in names if n not in _libs}
        errors = [e for n, s in started.items() if (e := _finish(n, s))]
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            error = _finish(name, _start(name))
            if error:
                raise RuntimeError(error)
            lib = _libs[name] = ctypes.CDLL(str(_target(name)))
        return lib


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """``symbol`` of ``csrc/<name>.cu`` with its argument types set, an
    ``int`` (a ``cudaError_t``) returned; built and bound once."""
    fn = _fns.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[(name, symbol)] = fn
    return fn
