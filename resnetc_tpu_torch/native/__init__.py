"""ctypes bindings for the native host helpers (C++, no Python headers).

The port's own copies of ``ingest.cpp`` (libjpeg decode, PIL-exact
antialiased bilinear resize, center crop and normalize, over a thread
pool; ``rn_preprocess_batch``) and ``binio.cpp`` (raw-f32 file IO; the
weight directory slurped by a thread pool, ``rn_read_f32_many``), each
built with ``g++`` at its first use into
``resnetc_tpu_torch/_build/<hash>/lib{ingest,binio}.so`` (no ``make``).
The library is written under a temporary name and renamed into place, so
a concurrent build sees the old file or the new one.  Counterpart of
``resnetc_tpu/native/__init__.py`` with the same entry points, signatures
and errors; the two sources are two libraries here, so that the reader,
which needs no libjpeg, builds where the libjpeg headers are missing.

``available(name)`` says whether a library built and loaded; where one did
not (no ``g++``; for the ingest, no libjpeg headers),
``why_unavailable(name)`` says why, and the callers take their numpy / PIL
paths: ``data.preprocess`` decodes with PIL, ``checkpoint`` reads with
``np.fromfile``.

- JPEG decode + preprocess (batch, threaded)     <- data/preprocess, loaders
- raw-f32 weight file IO (parallel slurp)        <- checkpoint

Also the serving binary, ``aoti_serve.cpp`` (``build_runner``): it runs a
package of ``python -m resnetc_tpu_torch.export`` with no Python in the
process, built with ``g++`` against the torch wheel's own headers and
libraries into ``_build/<hash>/resnetc_torch_serve``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
BUILD_ROOT = _DIR.parent / "_build"
#: The two libraries: source and link flags.  The reader needs no libjpeg,
#: so it builds (and checkpoints load through it) where the ingest cannot.
LIBS = {"ingest": ("ingest.cpp", ("-ljpeg", "-lpthread")),
        "binio": ("binio.cpp", ("-lpthread",))}
# -ffast-math only at COMPILE time: linking with it pulls in crtfastmath.o,
# whose constructor sets flush-to-zero/denormals-are-zero on the WHOLE host
# process when the .so loads — silently changing numerics for torch/numpy
# on the CPU.  The PIL-parity test (tests/test_torch_native.py) gates any
# resample drift.
CXXFLAGS = ("-O3", "-std=c++20", "-fPIC", "-Wall", "-Wextra", "-march=native", "-ffast-math",
            "-funroll-loops")

_libs: dict[str, ctypes.CDLL] = {}
_errors: dict[str, str] = {}  # why a library is unavailable, once tried


def _cxx() -> str | None:
    return os.environ.get("CXX") or shutil.which("g++")


def _run(cmd: list[str], **kw) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, capture_output=True, text=True, timeout=300, **kw)


def jpeg_headers(cxx: str | None = None) -> bool:
    """Whether the C++ compiler finds ``jpeglib.h`` (the libjpeg headers)."""
    cxx = cxx or _cxx()
    if cxx is None:
        return False
    probe = "#include <cstddef>\n#include <cstdio>\n#include <jpeglib.h>\n"
    return _run([cxx, "-x", "c++", "-E", "-o", os.devnull, "-"], input=probe).returncode == 0


def build(name: str) -> Path:
    """Compile and link library ``name`` ("ingest" or "binio") into
    ``_build/<hash>/lib<name>.so`` if it is not built yet; return its path.
    The hash covers the source, the flags and what ``-march=native`` means
    on this host (a library built on another host, in a copied tree, is
    not loaded here).  Raises ``RuntimeError`` with the compiler's output on
    failure."""
    cxx = _cxx()
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ not on PATH, CXX unset)")
    source, ldflags = LIBS[name]
    h = hashlib.sha256(" ".join((cxx,) + CXXFLAGS + ldflags).encode())
    h.update(_run([cxx, "-march=native", "-Q", "--help=target"]).stdout.encode())
    h.update((_DIR / source).read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib = out_dir / f"lib{name}.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        obj, so = Path(tmp) / f"{name}.o", Path(tmp) / lib.name
        for cmd in ([cxx, *CXXFLAGS, "-c", str(_DIR / source), "-o", str(obj)],
                    [cxx, str(obj), "-o", str(so), "-shared", *ldflags]):
            r = _run(cmd)
            if r.returncode != 0:
                raise RuntimeError(f"{' '.join(cmd[:1] + cmd[-3:])} failed ({r.returncode}):\n"
                                   f"{r.stdout}{r.stderr}")
        os.replace(so, lib)  # atomic: a concurrent build sees old or new
    return lib


def build_runner() -> Path:
    """Compile and link ``aoti_serve.cpp`` against the torch wheel (its
    headers, ``libtorch``, and ``libtorch_cuda`` where the wheel has it) into
    ``_build/<hash>/resnetc_torch_serve`` if it is not built yet; return its
    path.  Raises ``RuntimeError`` with the compiler's output on failure."""
    import torch
    from torch.utils import cpp_extension

    from resnetc_tpu_torch.ops.cuda._build import torch_cxx_flags

    cxx = _cxx()
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ not on PATH, CXX unset)")
    libs = ["-ltorch", "-ltorch_cpu", "-lc10"]
    if any((Path(p) / "libtorch_cuda.so").exists() for p in cpp_extension.library_paths()):
        libs = ["-Wl,--no-as-needed", "-ltorch_cuda", "-lc10_cuda", "-Wl,--as-needed", *libs]
    cmd = [cxx, *torch_cxx_flags(), str(_DIR / "aoti_serve.cpp"), *libs, "-ldl"]
    h = hashlib.sha256(" ".join(cmd).encode() + torch.__version__.encode())
    h.update((_DIR / "aoti_serve.cpp").read_bytes())
    exe = BUILD_ROOT / h.hexdigest()[:16] / "resnetc_torch_serve"
    if exe.exists():
        return exe
    exe.parent.mkdir(parents=True, exist_ok=True)
    tmp = exe.with_name(f"{exe.name}.{os.getpid()}.tmp")
    r = subprocess.run([*cmd, "-o", str(tmp)], capture_output=True, text=True, timeout=900)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ aoti_serve.cpp failed ({r.returncode}):\n{r.stdout}{r.stderr}")
    os.replace(tmp, exe)  # atomic: a concurrent build sees old or new
    return exe


def _declare(name: str, lib: ctypes.CDLL) -> None:
    if name == "ingest":
        lib.rn_preprocess_file.restype = ctypes.c_int
        lib.rn_preprocess_file.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.rn_preprocess_batch.restype = ctypes.c_int
        lib.rn_preprocess_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ]
        return
    lib.rn_file_size.restype = ctypes.c_int64
    lib.rn_file_size.argtypes = [ctypes.c_char_p]
    lib.rn_read_f32.restype = ctypes.c_int64
    lib.rn_read_f32.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64
    ]
    lib.rn_write_f32.restype = ctypes.c_int
    lib.rn_write_f32.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64
    ]
    lib.rn_read_f32_many.restype = ctypes.c_int
    lib.rn_read_f32_many.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
    ]


def _load(name: str) -> ctypes.CDLL | None:
    if name in _libs or name in _errors:
        return _libs.get(name)
    try:
        lib = ctypes.CDLL(str(build(name)))
    except (RuntimeError, OSError, subprocess.SubprocessError) as e:
        _errors[name] = str(e)
        return None
    _declare(name, lib)
    _libs[name] = lib
    return lib


def available(name: str | None = None) -> bool:
    """Whether library ``name`` ("ingest": ``preprocess_files``; "binio":
    the raw-f32 file IO), or with None both (the JAX package's meaning), is
    built and loaded, building it at the first call."""
    return all(_load(n) is not None for n in ((name,) if name else LIBS))


def why_unavailable(name: str | None = None) -> str | None:
    """The build or load errors that left ``name`` (or either library)
    unavailable, else None."""
    available(name)
    errs = [f"{n}: {_errors[n]}" for n in ((name,) if name else LIBS) if n in _errors]
    return "\n".join(errs) or None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _require(name: str) -> ctypes.CDLL:
    lib = _load(name)
    if lib is None:
        raise RuntimeError(f"native library {name} not available: {_errors[name]}")
    return lib


def preprocess_files(
    paths: list[str],
    *,
    resize: int,
    crop: int,
    mean: np.ndarray,
    std: np.ndarray,
    num_threads: int = 4,
) -> np.ndarray:
    """Decode+preprocess a batch of JPEGs -> (N, crop, crop, 3) float32 NHWC."""
    lib = _require("ingest")
    n = len(paths)
    out = np.empty((n, crop, crop, 3), np.float32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    rc = lib.rn_preprocess_batch(
        c_paths, n, resize, crop, _fptr(mean), _fptr(std), _fptr(out), num_threads
    )
    if rc != 0:
        raise ValueError(f"native preprocess failed (code {rc}) on batch {paths[:3]}...")
    return out


def read_f32(path: str, num_elems: int) -> np.ndarray:
    lib = _require("binio")
    out = np.empty((num_elems,), np.float32)
    got = lib.rn_read_f32(path.encode(), _fptr(out), num_elems)
    if got < 0:
        raise ValueError(f"native read_f32 failed (code {got}): {path}")
    if got != num_elems:
        raise ValueError(f"{path}: {got} elems, expected {num_elems}")
    return out


def write_f32(path: str, data: np.ndarray) -> None:
    lib = _require("binio")
    data = np.ascontiguousarray(data, np.float32).ravel()
    rc = lib.rn_write_f32(path.encode(), _fptr(data), data.size)
    if rc != 0:
        raise ValueError(f"native write_f32 failed (code {rc}): {path}")


def read_f32_many(
    paths: list[str], num_elems: list[int], *, num_threads: int = 8
) -> list[np.ndarray]:
    """Parallel-load many raw-f32 files; returns one array per file (views
    of one arena).  A missing file or one of another size raises
    ``ValueError``."""
    lib = _require("binio")
    n = len(paths)
    counts = np.asarray(num_elems, np.int64)
    offsets = np.zeros(n, np.int64)
    if n > 1:
        offsets[1:] = np.cumsum(counts[:-1])
    arena = np.empty((int(counts.sum()),), np.float32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    rc = lib.rn_read_f32_many(
        c_paths,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n,
        _fptr(arena),
        num_threads,
    )
    if rc != 0:
        raise ValueError(f"native read_f32_many failed (code {rc})")
    return [arena[offsets[i] : offsets[i] + counts[i]] for i in range(n)]
