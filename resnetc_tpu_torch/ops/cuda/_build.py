"""Build the port's CUDA sources and the ``resnetc`` custom ops that launch
them.

Each ``resnetc_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` into its
own shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), for ``sm_90a``; ``csrc/torch_ops.cpp``, the ops' CUDA
implementations, is compiled by ``g++`` against the torch wheel's headers
into ``libresnetc_ops.so``, which opens the kernel libraries at its first
launch.  All of them build in parallel, once, at the first launch, into
``resnetc_tpu_torch/_build/<hash>/``; the hashes cover the sources and the
flags, so an edited source rebuilds and an unchanged one is reused.
Nothing outside the repository is needed but the CUDA toolkit and g++.

Every ``extern "C"`` launcher is one op of the ``resnetc`` namespace
(``kernel_op``).  This module defines its schema, its CPU implementation
(the kernel's plain version) and a fake implementation (its output's shape
and type); ``libresnetc_ops.so``, loaded into the process before the first
launch (``call``), adds its CUDA implementation.  So torch's dispatcher
picks kernel or plain by the tensors' device, a launch passes through no
Python once the wrapper has called its op, and ``torch.export`` /
AOTInductor see each launch as one node, which the serving binary (no
Python) runs through the same library.  No op writes to an input: the
scratch a kernel needs is allocated inside its op.

Also home of the launch counters: every wrapper adds one to
``LAUNCHES[name]`` where its op launches the kernel, on a tensor on the
card, and nowhere else (``call``, ``launched``), and of the two debugging switches:
``runs_plain`` (inside ``utils.debug.plain_kernels()`` a wrapper calls its
plain version, on the card too, and no op) and ``launched`` (inside
``utils.debug.nan_debug()`` each kernel's output is checked for NaN after
its launch).  Both switches are per thread (``SWITCHES``): a context opened
by one thread changes nothing for the others.
"""

from __future__ import annotations

import collections
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch
from torch._subclasses.fake_tensor import is_fake

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

#: The ``resnetc`` namespace: each op's schema, CPU and fake implementations.
_LIB = torch.library.Library("resnetc", "DEF")
_LOAD_LOCK = threading.Lock()
_OPS_LOADED = False


class _Switches(threading.local):
    #: Depth of this thread's ``utils.debug.plain_kernels()`` contexts:
    #: above 0, its wrappers run their plain versions, on the card too.
    plain_depth = 0
    #: Set by ``utils.debug.nan_debug()``: each launch's output is checked.
    nan_check = False


#: The debugging switches, one set per thread.
SWITCHES = _Switches()


def reset_launches() -> None:
    LAUNCHES.clear()


def runs_plain() -> bool:
    """Whether a wrapper calls its plain version itself, on the card too:
    this thread has a ``plain_kernels()`` context open.  Otherwise it calls
    its op, whose CPU implementation is that plain version."""
    return SWITCHES.plain_depth > 0


def kernel_op(name: str, schema: str, *, plain, fake):
    """Define ``resnetc::<name>`` with ``schema`` ("(args) -> Tensor"):
    ``plain`` on the CPU, ``fake`` for tracing; its CUDA implementation is
    ``csrc/torch_ops.cpp``'s, loaded by ``call``.  Tagged
    ``needs_exact_strides``: a compiled graph (AOTInductor) hands the op its
    inputs with the strides they had when traced, the contiguous ones the
    wrappers make, and not the padded rows Inductor may otherwise lay out on
    the card.  Returns the op."""
    _LIB.define(name + schema, tags=(torch.Tag.needs_exact_strides,))
    _LIB.impl(name, plain, "CPU")
    torch.library.register_fake(f"resnetc::{name}", fake, lib=_LIB)
    return getattr(torch.ops.resnetc, name).default


def call(name: str, op, *args) -> torch.Tensor:
    """``op(*args)``, a ``resnetc`` op, whose first tensor argument picks its
    implementation.  On the card (a real tensor, not one being traced) the
    ops' CUDA implementations are loaded first (built on first use) and the
    launch is counted under ``name`` (``launched``); on the CPU the plain
    version runs and nothing is counted."""
    x = next(a for a in args if isinstance(a, torch.Tensor))
    on_card = x.is_cuda and (type(x) is torch.Tensor or not is_fake(x))
    if on_card and not _OPS_LOADED:
        load_ops()
    out = op(*args)
    return launched(name, out) if on_card else out


def load_ops() -> None:
    """Load ``libresnetc_ops.so`` into this process, once: it adds the CUDA
    implementation of every ``resnetc`` op defined here."""
    global _OPS_LOADED
    with _LOAD_LOCK:
        if not _OPS_LOADED:
            torch.ops.load_library(str(build_ops_library()))
            _OPS_LOADED = True


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


def torch_cxx_flags() -> list[str]:
    """g++ flags to compile and link against the torch wheel's headers and
    libraries (``torch.utils.cpp_extension``'s paths, torch's C++ ABI)."""
    from torch.utils import cpp_extension

    flags = ["-std=c++17", "-O2", "-fPIC", "-w",
             f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}"]
    flags += [f"-I{p}" for p in cpp_extension.include_paths()]
    for p in cpp_extension.library_paths():
        flags += [f"-L{p}", f"-Wl,-rpath,{p}"]
    return flags


def _ops_build(kernels: Path) -> tuple[list[str], Path]:
    """The g++ command (less its output) for ``csrc/torch_ops.cpp`` against
    the kernel libraries of ``kernels``, and the library's path: its own
    hash over the command, torch's version and the source."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found (set CXX); the ops library cannot be built")
    source = CSRC / "torch_ops.cpp"
    cmd = [cxx, "-shared", *torch_cxx_flags(), f"-I{Path(_nvcc()).parents[1] / 'include'}",
           f'-DRESNETC_KERNEL_DIR="{kernels}"', str(source), "-lc10_cuda", "-ltorch_cpu",
           "-lc10", "-ldl"]
    h = hashlib.sha256(" ".join(cmd).encode() + torch.__version__.encode())
    h.update(source.read_bytes())
    return cmd, BUILD_ROOT / h.hexdigest()[:16] / "libresnetc_ops.so"


def build_all(verbose: bool = False) -> Path:
    """Compile every kernel source and the ops library that is not built
    yet, all in parallel; return the kernels' build directory.  Raises with
    the compilers' output on failure."""
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = [(name, out_dir / f"lib{name}.so",
             [_nvcc(), *(["-Xptxas=-v"] if verbose else []), *NVCC_FLAGS,
              str(CSRC / f"{name}.cu")]) for name in SOURCES]
    ops_cmd, ops_lib = _ops_build(out_dir)
    ops_lib.parent.mkdir(parents=True, exist_ok=True)
    jobs.append(("torch_ops", ops_lib, ops_cmd))
    procs = []
    for name, lib, cmd in jobs:
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp.so")
        procs.append((name, lib, tmp, subprocess.Popen(
            [*cmd, "-o", str(tmp)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    errors = []
    for name, lib, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"{Path(proc.args[0]).name} {name} failed ({proc.returncode}):\n{out}")
            continue
        if name != "torch_ops":
            BUILD_LOG[name] = out
        if verbose and out:
            print(f"[{Path(proc.args[0]).name} {name}]\n{out}", flush=True)
        os.replace(tmp, lib)  # atomic: a concurrent build sees old or new
    if errors:
        raise RuntimeError("\n".join(errors))
    return out_dir


def build_ops_library() -> Path:
    """The path of ``libresnetc_ops.so`` (``csrc/torch_ops.cpp``: the
    ``resnetc`` ops' CUDA implementations, and their schemas where the
    process that loads it has not defined them, as the serving binary has
    not), after ``build_all()``."""
    return _ops_build(build_all())[1]


def require(t: torch.Tensor, name: str, dtype: torch.dtype, device: torch.device, shape=None):
    """Validate what a kernel takes before its op is called."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
