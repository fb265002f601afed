"""ctypes binding of the native batch loader (``fastloader.cpp``; port of
``deeplabv3plus_keras_tpu/native/__init__.py:26-178`` and ``build.py``).

The shared library is built with ``g++`` on first use into
``build/native/fastloader-<hash>.so`` at the repository root, keyed by a
hash of the source and the command, so an edited source builds anew.
Where ``g++`` or the libjpeg/libpng headers are missing, or the library
does not reproduce PIL's bytes (:func:`_self_check`), :func:`get_lib`
returns None and the loader's ``auto`` backend decodes with PIL instead:
the native loader changes the decode's speed, never its output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

FL_OK = 0
FL_OVERSIZED = 1
FL_FALLBACK = 2

SRC = Path(__file__).resolve().parent / "fastloader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"

_lock = threading.Lock()
_lib = None
_lib_tried = False


def build_command(src: Path, out: Path) -> list[str]:
    return ["g++", "-O2", "-fPIC", "-shared", "-std=c++17", str(src), "-o", str(out),
            "-ljpeg", "-lpng", "-lpthread"]


def build_fastloader() -> Path | None:
    """The built library's path, building it if needed; None where it
    cannot be built here."""
    tag = hashlib.sha256(SRC.read_bytes() + " ".join(build_command(SRC, Path())).encode())
    out = BUILD_DIR / f"fastloader-{tag.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    try:
        subprocess.run(build_command(SRC, tmp), check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, out)  # atomic against a concurrent build
    return out


def _load_library():
    path = build_fastloader()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:  # built where libjpeg/libpng exist, loaded where they do not
        return None
    lib.fl_assemble_batch.restype = ctypes.c_int
    lib.fl_assemble_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),  # img_paths
        ctypes.POINTER(ctypes.c_char_p),  # lab_paths
        ctypes.POINTER(ctypes.c_int32),   # lab_remap
        ctypes.c_int,                     # n
        ctypes.c_int,                     # canvas_h
        ctypes.c_int,                     # canvas_w
        ctypes.c_void_p,                  # img_canvas
        ctypes.c_void_p,                  # lab_canvas
        ctypes.POINTER(ctypes.c_int32),   # sizes
        ctypes.POINTER(ctypes.c_int32),   # status
        ctypes.c_int,                     # nthreads
    ]
    lib.fl_abi_version.restype = ctypes.c_int
    lib.fl_abi_version.argtypes = []
    if lib.fl_abi_version() != 1:
        return None
    return lib


def get_lib():
    """The loaded fastloader library, or None if it cannot be built here or
    does not reproduce PIL's bytes."""
    global _lib, _lib_tried
    with _lock:
        if not _lib_tried:
            _lib_tried = True
            lib = _load_library()
            _lib = lib if lib is not None and _self_check(lib) else None
        return _lib


def native_available() -> bool:
    return get_lib() is not None


def _self_check(lib) -> bool:
    """Decode a generated JPEG and PNG through the library and through PIL
    and compare the bytes.  Bit-identity with PIL needs the system libjpeg
    to match PIL's bundled libjpeg-turbo (IJG libjpeg 9 differs in
    upsampling and colour conversion), so where it does not, the loader
    decodes with PIL rather than diverge."""
    import collections
    import tempfile

    try:
        from PIL import Image
    except ImportError:
        return True  # no PIL: nothing to diverge from

    Spec = collections.namedtuple("Spec", "image_path label_path label_remap_value")
    rng = np.random.default_rng(1024)
    # gradient + noise exercises chroma subsampling and upsampling
    y, x = np.mgrid[0:48, 0:64]
    img = np.stack([(x * 4) % 256, (y * 5) % 256, rng.integers(0, 256, (48, 64))],
                   axis=-1).astype(np.uint8)
    lab = rng.integers(0, 32, (48, 64)).astype(np.uint8)
    with tempfile.TemporaryDirectory() as td:
        jpg, png = os.path.join(td, "c.jpg"), os.path.join(td, "c.png")
        Image.fromarray(img).save(jpg, quality=85)
        Image.fromarray(lab).save(png)
        golden_img = np.asarray(Image.open(jpg).convert("RGB"), np.uint8)
        golden_lab = np.asarray(Image.open(png), np.uint8)
        img_canvas = np.zeros((1, 64, 64, 3), np.uint8)
        lab_canvas = np.zeros((1, 64, 64), np.uint8)
        sizes = np.zeros((1, 2), np.int32)
        status = _assemble_raw(lib, [Spec(jpg, png, None)], img_canvas, lab_canvas, sizes,
                               nthreads=1)
    if status[0] != FL_OK or tuple(sizes[0]) != golden_img.shape[:2]:
        return False
    h, w = golden_img.shape[:2]
    return bool(np.array_equal(img_canvas[0, :h, :w], golden_img)
                and np.array_equal(lab_canvas[0, :h, :w], golden_lab))


def assemble_batch(specs, img_canvas: np.ndarray, lab_canvas: np.ndarray | None,
                   sizes: np.ndarray, nthreads: int = 0) -> np.ndarray:
    """Decode ``specs`` into zeroed canvases in one C call that holds no
    GIL.  img_canvas (n, CH, CW, 3) uint8 C-contiguous; lab_canvas (n, CH,
    CW) uint8 or None; sizes (n, 2) int32, written.  Returns each item's
    status; an item that is not ``FL_OK`` was not decoded (the caller falls
    back to PIL)."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("the native fastloader is not available here")
    return _assemble_raw(lib, specs, img_canvas, lab_canvas, sizes, nthreads)


def _assemble_raw(lib, specs, img_canvas, lab_canvas, sizes, nthreads=0):
    n = len(specs)
    if not (img_canvas.flags.c_contiguous and img_canvas.dtype == np.uint8
            and img_canvas.ndim == 4 and img_canvas.shape[0] == n and img_canvas.shape[3] == 3):
        raise ValueError(f"img_canvas must be C-contiguous uint8 ({n}, CH, CW, 3)")
    if lab_canvas is not None and not (lab_canvas.flags.c_contiguous and lab_canvas.dtype == np.uint8
                                       and lab_canvas.shape == img_canvas.shape[:3]):
        raise ValueError(f"lab_canvas must be C-contiguous uint8 {img_canvas.shape[:3]}")
    if not (sizes.flags.c_contiguous and sizes.dtype == np.int32 and sizes.shape == (n, 2)):
        raise ValueError(f"sizes must be C-contiguous int32 ({n}, 2)")
    with_labels = lab_canvas is not None
    img_paths = (ctypes.c_char_p * n)(*[os.fsencode(s.image_path) for s in specs])
    lab_paths = (ctypes.c_char_p * n)(*[
        os.fsencode(s.label_path) if with_labels and s.label_path else None for s in specs])
    remap = (ctypes.c_int32 * n)(*[
        s.label_remap_value if s.label_remap_value is not None else -1 for s in specs])
    status = np.zeros((n,), np.int32)
    if nthreads <= 0:
        nthreads = min(n, os.cpu_count() or 1)
    lib.fl_assemble_batch(
        img_paths, lab_paths, remap, n, img_canvas.shape[1], img_canvas.shape[2],
        img_canvas.ctypes.data_as(ctypes.c_void_p),
        lab_canvas.ctypes.data_as(ctypes.c_void_p) if with_labels else None,
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        nthreads,
    )
    return status
