"""The fp32 forms of ``matmul``, the fused convolutions and the bottleneck
block, and the FP32 forwards that run them, timed on the card for one
checkout.

    python3 resnetc_tpu_torch/utils/fp32_ab.py [--root DIR] [--batch 32] [--samples 20]

Builds ``--root``'s kernels (its ``resnetc_tpu_torch``), then times, at
ResNet-152's shapes and batch 32: every fp32 ``matmul`` of the FP32
``pallas`` route (its 20 1x1 shapes and the fc), the fp32
``conv3x3_s1_fused`` at its four stride-1 3x3 shapes and ``conv_s2_fused``
at its three stride-2 ones, and two fp32 convolutions off every route (a
28x28x128 3x3 with a residual, a 56x56x128 3x3/2), and the fp32
``bottleneck_block_chained`` of the FP32 ``pallas_block`` route at its four
stage shapes (2, 7, 35 and 2 launches a forward).  Each kernel's time is
device time (ten launches queued behind a spin kernel, the median of five
runs), with its largest error against its plain version (``matmul_plain``
and the convolutions' and the block's plain versions, float64 sums), beside
the same function as one PyTorch call (``torch.matmul`` / ``F.conv2d``
channels-last; none for the block) with TF32 off (IEEE fp32) and on, and
beside the bound at the split product's 165 TFLOP/s and 3.35 TB/s.  A tree
whose wrappers take ``w_nk`` (the block's ``w1_nk`` / ``w2_nk`` /
``w3_nk``) is given what its FP32 engine keeps (``gemm.pack_nk``).  Then
``serve.bench_latency``'s p50 / p99 of ResNet-152's ``pallas``, ``int8``
and ``pallas_block`` engines under FP32 and of the served ``int8_chain``
under BF16 (seeded weights, batch 32).  Prints the card's name and power limit, then one JSON line.  Run two
checkouts in one call, in turns (parent, change, change, parent), to
compare them: ``--root`` imports the package from another checkout.
"""

from __future__ import annotations

import argparse
import inspect
import json
import statistics
import subprocess
import sys
from pathlib import Path

PEAK_TF32X3_FLOPS = 495e12 / 3
PEAK_BYTES = 3.35e12
# ResNet-152 at 224 px: (h, c, c4) per stage after the stem and pool.
STAGES = [(56, 64, 256), (28, 128, 512), (14, 256, 1024), (7, 512, 2048)]
BLOCKS = (3, 8, 36, 3)


def _device_ms(fn, iters: int = 10, repeats: int = 5) -> float:
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    cycles = 1 << 24
    while len(times) < repeats:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        ahead = not start.query()
        torch.cuda.synchronize()
        if ahead:
            times.append(start.elapsed_time(end) / iters)
        else:
            cycles *= 2
    return statistics.median(times)


def _precision(mode: str):
    """cuDNN convolutions and cuBLAS matmuls in ``mode`` ("ieee" or "tf32")
    for the duration."""
    import contextlib

    import torch

    @contextlib.contextmanager
    def ctx():
        conv, mm = torch.backends.cudnn.conv, torch.backends.cuda.matmul
        saved = conv.fp32_precision, mm.fp32_precision
        conv.fp32_precision = mm.fp32_precision = mode
        try:
            yield
        finally:
            conv.fp32_precision, mm.fp32_precision = saved

    return ctx()


def _cases(batch: int):
    """(label, kernel, launches per forward, fn, plain, library, ops, bytes)."""
    import torch
    import torch.nn.functional as F

    from resnetc_tpu_torch.ops.cuda import block, conv, gemm

    gen = torch.Generator().manual_seed(5678)
    takes_nk = "w_nk" in inspect.signature(gemm.matmul).parameters
    block_takes_nk = "w1_nk" in inspect.signature(block.bottleneck_block_chained).parameters

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).cuda()

    def nk(w):
        return {"w_nk": gemm.pack_nk(w)} if takes_nk else {}

    out = []
    for s, (h, c, c4) in enumerate(STAGES):
        cin = 64 if s == 0 else STAGES[s - 1][2]
        shapes = [(f"s{s}/b0/conv1", h if s == 0 else 2 * h, cin, c, False, True, 1),
                  (f"s{s}/b0/downsample", h, cin, c4, False, False, 1),
                  (f"s{s}/b0/conv3", h, c, c4, True, True, 1),
                  (f"s{s}/id/conv1", h, c4, c, False, True, BLOCKS[s] - 1),
                  (f"s{s}/id/conv3", h, c, c4, True, True, BLOCKS[s] - 1)]
        for label, hh, k, n, res, relu, count in shapes:
            m = batch * hh * hh
            x, w, b = randn(m, k), randn(k, n, scale=k**-0.5), randn(n, scale=0.1)
            r = randn(m, n) if res else None
            kw = dict(relu=relu, **nk(w))
            out.append((f"matmul/{label}", "matmul", count,
                        lambda x=x, w=w, b=b, r=r, kw=kw: gemm.matmul(x, w, b, r, **kw),
                        lambda x=x, w=w, b=b, r=r, relu=relu: gemm.matmul_plain(
                            x, w, b, r, relu=relu),
                        lambda x=x, w=w: torch.matmul(x, w), 2 * m * k * n,
                        4 * (m * k + k * n + n + m * n * (2 if res else 1))))
    x, w, b = randn(batch, 2048), randn(2048, 1000, scale=2048**-0.5), randn(1000, scale=0.1)
    kw_fc = nk(w)
    out.append(("matmul/fc", "matmul", 1,
                lambda: gemm.matmul(x, w, b, **kw_fc), lambda: gemm.matmul_plain(x, w, b),
                lambda: torch.matmul(x, w),
                2 * batch * 2048 * 1000, 4 * (batch * 2048 + 2048 * 1000 + 1000 + batch * 1000)))

    def conv_case(label, h, cin, cout, stride, count, res=False):
        oh = (h + 2 - 3) // stride + 1
        x = randn(batch, h, h, cin)
        w = randn(3, 3, cin, cout, scale=(9 * cin) ** -0.5)
        b = randn(cout, scale=0.1)
        r = randn(batch, oh, oh, cout) if res else None
        kw = dict(relu=True, **nk(w))
        if stride == 1:
            fn = lambda: conv.conv3x3_s1_fused(x, w, b, r, **kw)  # noqa: E731
            plain = lambda: conv.conv3x3_s1_fused_plain(x, w, b, r, relu=True)  # noqa: E731
        else:
            fn = lambda: conv.conv_s2_fused(x, w, b, **kw)  # noqa: E731
            plain = lambda: conv.conv_s2_fused_plain(x, w, b, relu=True)  # noqa: E731
        xc = x.permute(0, 3, 1, 2)
        wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        lib = lambda: F.conv2d(xc, wc, b, stride=stride, padding=1)  # noqa: E731
        name = "conv3x3_s1_fused" if stride == 1 else "conv_s2_fused"
        nbytes = 4 * (batch * h * h * cin + 9 * cin * cout + cout
                      + batch * oh * oh * cout * (2 if res else 1))
        out.append((label, name, count, fn, plain, lib, 2 * batch * oh * oh * 9 * cin * cout,
                    nbytes))

    for s, (h, c, _) in enumerate(STAGES):
        conv_case(f"conv3x3/r152/s{s}", h, c, c, 1, BLOCKS[s] - (s > 0))
    for s in (1, 2, 3):
        h, c, _ = STAGES[s]
        conv_case(f"conv_s2/r152/s{s}", 2 * h, c, c, 2, 1)
    conv_case("conv3x3/fp32/s1", 28, 128, 128, 1, 0, res=True)
    conv_case("conv_s2/fp32/s1", 56, 128, 128, 2, 0)

    for s, (h, c, c4) in enumerate(STAGES):
        hp, wp = block.chain_meta(batch, h, h)
        xr = block.pad_for_chain(randn(batch, h, h, c4))
        ws = (randn(c4, c, scale=c4**-0.5), randn(c, scale=0.1),
              randn(3, 3, c, c, scale=(9 * c) ** -0.5), randn(c, scale=0.1),
              randn(c, c4, scale=c**-0.5), randn(c4, scale=0.1))
        kw = dict(h=h, w_sp=h)
        if block_takes_nk:
            kw.update(w1_nk=gemm.pack_nk(ws[0]), w2_nk=gemm.pack_nk(ws[2]),
                      w3_nk=gemm.pack_nk(ws[4]))
        out.append((f"fp_block/s{s}", "bottleneck_block_chained", BLOCKS[s] - 1,
                    lambda xr=xr, ws=ws, kw=kw: block.bottleneck_block_chained(xr, *ws, **kw),
                    lambda xr=xr, ws=ws, h=h: block.bottleneck_block_chained_plain(
                        xr, *ws, h=h, w_sp=h),
                    None, 2 * batch * h * h * 17 * c * c,
                    4 * (2 * batch * hp * wp * c4 + 17 * c * c + 2 * c + c4)))
    return out


def _engines(batch: int, samples: int) -> dict:
    import warnings

    import torch

    from resnetc_tpu_torch.models import resnet
    from resnetc_tpu_torch.serve import InferenceEngine, bench_latency
    from resnetc_tpu_torch.tensor import BF16, FP32

    cfg = resnet.get_config("resnet152")
    variables = resnet.init(cfg, torch.Generator().manual_seed(0))
    x = torch.randn((batch, 224, 224, 3), generator=torch.Generator().manual_seed(2)).cuda()
    out = {}
    for backend, pol, label in (("pallas", FP32, "pallas/fp32"), ("int8", FP32, "int8/fp32"),
                                ("pallas_block", FP32, "pallas_block/fp32"),
                                ("int8_chain", BF16, "int8_chain")):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            eng = InferenceEngine(cfg, variables, backend=backend, policy=pol, device="cuda",
                                  calib_batch=x[:8] if backend == "int8_chain" else None)
        lat = bench_latency(eng, x, samples=samples, warmup=3)
        out[label] = {"p50_ms": lat.p50_ms, "p99_ms": lat.p99_ms, "mean_ms": lat.mean_ms}
        print(f"[fp32_ab] {label}: {json.dumps(out[label])}", flush=True)
        del eng
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose resnetc_tpu_torch is timed")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--samples", type=int, default=20)
    args = ap.parse_args()
    sys.path[0] = str(Path(args.root).resolve())  # not this file's directory

    import torch

    if not torch.cuda.is_available():
        print("fp32_ab: CUDA is not available", file=sys.stderr)
        return 1
    from resnetc_tpu_torch.ops.cuda import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"[fp32_ab] {card}; root {args.root}", flush=True)
    _build.build_all()
    rows, sums = [], {}
    for label, kernel, count, fn, plain, lib, ops, nbytes in _cases(args.batch):
        got, want = fn(), plain()
        err = float((got - want).abs().max())
        ms = _device_ms(fn)
        lib_ms = lib_tf32_ms = None
        if lib is not None:
            with _precision("ieee"):
                lib_ms = _device_ms(lib, iters=20)
            with _precision("tf32"):
                lib_tf32_ms = _device_ms(lib, iters=20)
        bound = max(ops / PEAK_TF32X3_FLOPS, nbytes / PEAK_BYTES) * 1e3
        row = {"case": label, "kernel": kernel, "per_forward": count, "ms": ms,
               "library_ieee_ms": lib_ms, "library_tf32_ms": lib_tf32_ms, "bound_ms": bound,
               "tflops": ops / ms * 1e-9, "max_abs_err": err,
               "max_err_over_max_plain": err / float(want.abs().max())}
        rows.append(row)
        print(f"[fp32_ab] {json.dumps(row)}", flush=True)
        s = sums.setdefault(kernel, {"launches": 0, "ms": 0.0, "library_ieee_ms": 0.0,
                                     "library_tf32_ms": 0.0, "bound_ms": 0.0})
        s["launches"] += count
        for key in ("ms", "library_ieee_ms", "library_tf32_ms", "bound_ms"):
            s[key] = None if s[key] is None or row[key] is None else s[key] + count * row[key]
    for kernel, s in sums.items():
        print(f"[fp32_ab] per forward: {kernel} {json.dumps(s)}", flush=True)
    engines = _engines(args.batch, args.samples)
    print(json.dumps({"card": card, "root": args.root, "cases": rows, "per_forward": sums,
                      "engines": engines}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
