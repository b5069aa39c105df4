"""Build the port's CUDA sources and bind them with ctypes.

Each ``resnetc_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` into its
own shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), for ``sm_90a``.  All sources build in parallel, once, at the
first launch, into ``resnetc_tpu_torch/_build/<hash>/``; the hash covers the
sources and the flags, so an edited source rebuilds and an unchanged one is
reused.  Nothing outside the repository is needed but the CUDA toolkit.

Also home of the launch counters: every wrapper adds one to
``LAUNCHES[name]`` where it launches its kernel, and nowhere else
(``launched``), and of the two debugging switches every wrapper reads:
``runs_plain`` (a CPU tensor, or inside ``utils.debug.plain_kernels()``,
takes the plain version) and ``launched`` (inside
``utils.debug.nan_debug()`` each kernel's output is checked for NaN after
its launch, since the launches pass through ctypes, where torch's
dispatcher does not see them).  Both switches are per thread
(``SWITCHES``): a context opened by one thread changes nothing for the
others.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = ("chain_block", "basic_block", "pp_block", "gemm", "int8_gemm", "conv", "pool",
           "fp_block", "elementwise")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

#: Launches per wrapper name since the last reset.
LAUNCHES: collections.Counter = collections.Counter()

#: The compiler's output per source compiled by this process (ptxas's
#: report with ``build_all(verbose=True)``).
BUILD_LOG: dict[str, str] = {}


class _Switches(threading.local):
    #: Depth of this thread's ``utils.debug.plain_kernels()`` contexts:
    #: above 0, its wrappers run their plain versions, on the card too.
    plain_depth = 0
    #: Set by ``utils.debug.nan_debug()``: each launch's output is checked.
    nan_check = False


#: The debugging switches, one set per thread.
SWITCHES = _Switches()

_LIBS: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    LAUNCHES.clear()


def runs_plain(t: torch.Tensor) -> bool:
    """Whether a wrapper given ``t`` runs its plain version: ``t`` is off the
    card, or this thread has a ``plain_kernels()`` context open."""
    return not t.is_cuda or SWITCHES.plain_depth > 0


def launched(name: str, out: torch.Tensor) -> torch.Tensor:
    """Count one launch of ``name``'s kernel, whose output is ``out``; under
    ``nan_debug()`` wait for it and raise if ``out`` holds a NaN."""
    LAUNCHES[name] += 1
    if SWITCHES.nan_check and out.is_floating_point() and bool(torch.isnan(out).any()):
        raise FloatingPointError(f"{name}: the kernel's output holds a NaN")
    return out


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all(verbose: bool = False) -> Path:
    """Compile every source that is not built yet, all in parallel; return
    the build directory.  Raises with the compiler's output on failure."""
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in SOURCES:
        lib = out_dir / f"lib{name}.so"
        if lib.exists():
            continue
        tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        procs.append((name, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    errors = []
    for name, lib, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{out}")
            continue
        BUILD_LOG[name] = out
        if verbose and out:
            print(f"[nvcc {name}.cu]\n{out}", flush=True)
        os.replace(tmp, lib)  # atomic: a concurrent build sees old or new
    if errors:
        raise RuntimeError("\n".join(errors))
    return out_dir


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu`` (built on first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all() / f"lib{name}.so"))
        _LIBS[name] = lib
    return lib


def ptr(t: torch.Tensor | None) -> int | None:
    """Device pointer of a tensor, or None (NULL) for an absent operand."""
    return None if t is None else t.data_ptr()


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {rc}")


def require(t: torch.Tensor, name: str, dtype: torch.dtype, device: torch.device, shape=None):
    """Validate what a kernel takes before its pointer is passed on."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
