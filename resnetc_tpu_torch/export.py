"""Export the serving forward as an AOTInductor package for the C++ runner
(``native/aoti_serve.cpp``): the port's counterpart of
``tools/export_stablehlo.py``, with the same flags.

    python -m resnetc_tpu_torch.export [--model resnet50] [--batch 1] \\
        [--image-size 224] [--weights PATH.pth|weights_dir] \\
        [--backend fp|int8_chain] [--calib BATCH.npy] [--out export/] [--device cpu]

Writes ``<out>/model.pt2`` (``torch._inductor.aoti_compile_and_package`` of
the ``torch.export`` program) and ``<out>/meta.json`` (the JAX exporter's
keys).  The program takes one f32 NHWC image tensor and returns f32 logits:
the engine's forward, ``fp`` the BN-folded forward on stock ops (JAX's
``xla``), ``int8_chain`` the int8 block kernels, each launch one
``resnetc::`` op node (``ops.cuda._build.kernel_op``) that the runner
calls through the ops library ``csrc/torch_ops.cpp``.  The weights, and for
``int8_chain`` the quantized tree with its K-major copies and the chain
scales, are buffers of an ``nn.Module`` (``ServingModule``), so that the
program holds them as constants and the runner feeds images only.  The
``int8_chain`` route follows ``ops.cuda.fused``'s flags at export time.

The package is made for the card unless ``--device cpu`` asks for the CPU
(packaging for the card needs the card: there is no fall-back).  Tracing
alone (``export_program``) works on either, as the tests do on the CPU.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

BACKENDS = ("fp", "int8_chain")


class ServingModule(torch.nn.Module):
    """An ``InferenceEngine``'s forward as a module: its tree (and chain
    scales) as buffers, one f32 NHWC input, f32 logits."""

    def __init__(self, engine):
        super().__init__()
        from resnetc_tpu_torch.tensor import flatten_tree

        if engine.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {engine.backend!r}")
        self.cfg, self.policy, self.backend = engine.model_cfg, engine.policy, engine.backend
        self._keys: dict[str, dict[str, str]] = {}
        trees = {"folded": engine.folded}
        if engine.chain_scales is not None:
            trees["scales"] = engine.chain_scales
        for part, tree in trees.items():
            self._keys[part] = {}
            for i, (key, leaf) in enumerate(flatten_tree(tree).items()):
                name = f"{part}_{i}"
                self.register_buffer(name, leaf)
                self._keys[part][key] = name

    def _tree(self, part: str) -> dict:
        from resnetc_tpu_torch.tensor import unflatten_tree

        return unflatten_tree({k: getattr(self, n) for k, n in self._keys[part].items()})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.backend == "fp":
            from resnetc_tpu_torch.models import resnet

            logits = resnet.forward_folded(self.cfg, self._tree("folded"), x, policy=self.policy)
        else:
            from resnetc_tpu_torch.ops.cuda import fused

            logits = fused.fused_forward_int8_chain(self.cfg, self._tree("folded"),
                                                    self._tree("scales"), x, policy=self.policy)
        return logits.float()


def load_variables(cfg, weights: str | None):
    """The model's variables on the CPU: a ``.pth`` / ``.pt`` state dict, a
    reference weight directory, or with None the seeded init (seed 0)."""
    from resnetc_tpu_torch import checkpoint
    from resnetc_tpu_torch.models import resnet

    if weights is None:
        return resnet.init(cfg, torch.Generator().manual_seed(0))
    if weights.endswith((".pth", ".pt")):
        return checkpoint.variables_from_torch_file(weights)
    return checkpoint.load_reference_format(cfg, weights)


def build_engine(model: str, backend: str, *, weights: str | None = None,
                 calib: str | None = None, device=None):
    """The engine the exporter serves: BF16, ``backend``, calibrated for
    ``int8_chain`` on the ``.npy`` batch ``calib`` (NHWC f32), or on the
    engine's unit-normal noise with its warning."""
    from resnetc_tpu_torch.models import resnet
    from resnetc_tpu_torch.serve import InferenceEngine
    from resnetc_tpu_torch.tensor import BF16

    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    cfg = resnet.get_config(model)
    calib_batch = None
    if calib is not None:
        calib_batch = np.load(calib).astype(np.float32)
    return InferenceEngine(cfg, load_variables(cfg, weights), policy=BF16, backend=backend,
                           calib_batch=calib_batch, device=device)


def export_program(engine, batch: int, image_size: int):
    """``torch.export`` of the engine's forward at (batch, image_size,
    image_size, 3) f32 on the engine's device."""
    module = ServingModule(engine)
    x = torch.zeros((batch, image_size, image_size, 3), dtype=torch.float32,
                    device=engine.device)
    with torch.no_grad():
        return torch.export.export(module, (x,))


def kernel_nodes(program) -> collections.Counter:
    """The ``resnetc::`` op nodes of an exported program's graph, by op."""
    return collections.Counter(
        node.target.name().split("::")[1].split(".")[0] for node in program.graph.nodes
        if node.op == "call_function" and str(node.target).startswith("resnetc.")
    )


def _links_openmp(cxx: str) -> bool:
    """Whether ``cxx`` links a program with ``-fopenmp`` (a toolchain may
    ship g++ without libgomp)."""
    with tempfile.TemporaryDirectory() as d:
        src = Path(d) / "main.cpp"
        src.write_text("int main() { return 0; }\n")
        return subprocess.run([cxx, "-fopenmp", str(src), "-o", str(Path(d) / "main")],
                              capture_output=True).returncode == 0


@contextlib.contextmanager
def _inductor_openmp():
    """Inductor compiles and links the package's C++ with ``-fopenmp``
    always (``cpp_builder._get_openmp_args``).  Where its compiler (``CXX``
    may name one) cannot link that, take the ``g++`` on the path if that
    one can; else build without OpenMP: the parallel loops it would spread
    are the CPU kernels', and a package for the card holds none."""
    from torch._inductor import config, cpp_builder

    cxx = cpp_builder.get_cpp_compiler()
    if _links_openmp(cxx):
        yield
        return
    path_cxx = shutil.which("g++")
    if path_cxx and _links_openmp(path_cxx):
        with config.patch({"cpp.cxx": (path_cxx,)}):
            yield
        return
    warnings.warn(f"{cxx} does not link -fopenmp: the package's C++ is built without OpenMP",
                  stacklevel=3)
    saved = cpp_builder._get_openmp_args
    cpp_builder._get_openmp_args = lambda cpp_compiler: ([], [], [], [], [], [])
    try:
        yield
    finally:
        cpp_builder._get_openmp_args = saved


def package(program, out: Path) -> Path:
    """AOTInductor-compile ``program`` into ``out/model.pt2``, with three of
    Inductor's options.  ``always_keep_tensor_constants``: the program's
    0-d constants (the chain scales) stay tensors; Inductor otherwise
    inlines each as a scalar, which its lowering of the ``torch.stack`` of
    a block's scale row cannot take (``LoweringException`` in
    ``unsqueeze``, torch 2.11 and 2.13).  ``emulate_precision_casts``: a
    fused kernel rounds to bf16 where the program casts to bf16, as the
    engine does; by default Inductor carries fp32 across those casts, and
    the int8 quantizations downstream then round other values (the
    ``int8_chain`` ResNet-50 at 32 px, b1, on the CPU: 0.147 of max
    |logit| from the engine, against 0 with the option).
    ``eager_numerics.division_rounding``: an fp32 division rounds its
    quotient, as eager CUDA does; by default Inductor's Triton code on the
    card divides approximately (``div.full.f32``), and a last bit of a
    folded requant scale moves int8 roundings downstream (the
    ``int8_chain`` ResNet-18 at 224 px, b8, on an H100: 0.096 of max
    |logit| from the engine and other classes).  The fusions stay."""
    out.mkdir(parents=True, exist_ok=True)
    path = out / "model.pt2"
    with warnings.catch_warnings(), _inductor_openmp():
        warnings.simplefilter("ignore", FutureWarning)  # inductor's own deprecations
        torch._inductor.aoti_compile_and_package(
            program, package_path=str(path),
            inductor_configs={"always_keep_tensor_constants": True,
                              "emulate_precision_casts": True,
                              "eager_numerics.division_rounding": True})
    return path


def export_artifact(*, model: str, backend: str, batch: int, image_size: int, out: Path,
                    weights: str | None = None, calib: str | None = None, device=None) -> dict:
    """Build the engine, export and package its forward into ``out``
    (``model.pt2``, ``meta.json``); returns the meta, the package's path,
    its ``resnetc::`` nodes by op, and the seconds of each step."""
    t0 = time.perf_counter()
    engine = build_engine(model, backend, weights=weights, calib=calib, device=device)
    t1 = time.perf_counter()
    program = export_program(engine, batch, image_size)
    t2 = time.perf_counter()
    path = package(program, out)
    t3 = time.perf_counter()
    meta = {
        "model": model,
        "backend": backend,
        "input": [batch, image_size, image_size, 3],
        "input_dtype": "f32",
        "output": [batch, engine.model_cfg.num_classes],
        "weights": weights or "random-init",
        "calibration": (calib or "unit-normal-noise") if backend == "int8_chain" else None,
    }
    (out / "meta.json").write_text(json.dumps(meta, indent=1))
    return {"meta": meta, "path": str(path), "device": str(engine.device),
            "kernel_nodes": dict(kernel_nodes(program)), "engine_s": t1 - t0,
            "export_s": t2 - t1, "compile_s": t3 - t2}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m resnetc_tpu_torch.export",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="resnet50")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--weights", default=None,
                    help=".pth state dict or reference weights dir; seeded init when absent")
    ap.add_argument("--backend", default="fp", choices=list(BACKENDS),
                    help="fp: BN-folded bf16 forward on stock ops; int8_chain: the int8 "
                    "block kernels, as resnetc:: ops")
    ap.add_argument("--calib", default=None,
                    help="int8_chain calibration batch: .npy of NHWC f32 images "
                    "(unit-normal noise with a warning if absent)")
    ap.add_argument("--out", default="export")
    ap.add_argument("--device", default=None,
                    help="cpu packages for the CPU; the default is the card")
    args = ap.parse_args(argv)

    res = export_artifact(model=args.model, backend=args.backend, batch=args.batch,
                          image_size=args.image_size, out=Path(args.out), weights=args.weights,
                          calib=args.calib, device=args.device)
    path = Path(res["path"])
    print(f"exported {args.model} [{args.backend}] batch={args.batch} on {res['device']} -> "
          f"{path} ({path.stat().st_size // 1024} KiB, "
          f"{sum(res['kernel_nodes'].values())} resnetc:: op nodes; export "
          f"{res['export_s']:.1f} s, compile {res['compile_s']:.1f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
