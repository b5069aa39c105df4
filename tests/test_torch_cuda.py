"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one (the kernels have
no CPU mode).  The file imports neither JAX nor the JAX package, so it also
runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Without the suite's conftest ``RESNETC_NO_TUNED`` is unset there, so the
TUNED.json overlay is live: the engine tests set ``L1_PIXEL_PAIR``
explicitly.

Inputs come from a seeded numpy generator.  Tolerances: int8 and bf16
outputs EQUAL (exact integer dots, fp32 epilogues in the same order of
operations and roundings), ``int8_matmul`` and ``max_pool2d`` included; the
fp32 per-image means and the fp32-accumulating GEMM sum in another order:
rtol 1e-5 and 1e-5 / 1e-4.  The fused convolutions sum up to 9*Cin fp32
products in another order than their plain versions: fp32 outputs within
rtol 1e-4 (atol 1e-4), bf16 outputs within 1 bf16 ulp of the larger
magnitude (or 1e-5 of the largest output, where relu cuts a sum that is
zero to fp32 rounding).
The port's fp32 ``conv2d`` / ``linear`` (``ops.torch_ops``) are IEEE
fp32 with TF32 turned on in the process: within 1e-5 of float64.
The bf16 ``matmul`` splits K over a workspace at the fc and sums the slices
in a fixed order: two calls give the same bits.  ``int8_matmul`` (the int8
wgmma tile) splits K over an int32 workspace, exactly: it equals its plain
version at every shape, the fc included, and two calls, or the engine's
(N, K) weight copy and a per-call transpose, give the same bits.
The pixel-paired kernels are also driven through their pair-space entries
with dense random pair-space weights, so a kernel that skipped the zero
blocks or ran the unpaired GEMM would disagree with its plain version.
The int8 bottleneck block and run (the int8 wgmma tile) equal their plain
versions at ResNet-152's stage shapes and off the tile, every exit, and
give the same bits on a second call and from the engine's K-major weight
copies as from a per-call transpose; so do the stride-2 transition (at
odd and even sizes, wp = w + 1 and round_up(w + 2, 8)), the basic
transition (whose output ignores x's ring: random bytes, or -128, give the
bits of a zero ring) and the pixel-paired bottleneck block and run (from the
engine's pair copies as from per-call packing).
The bf16 / fp32 bottleneck blocks (``bottleneck_block_chained``,
``bottleneck_block_fused``) round z1 and z2 to the compute type inside the
block, so a summation-order difference can move a value by one bf16 step:
max error / max |plain| within 1e-2 in bf16, 1e-4 in fp32.  The average
pool and ``relu`` / ``add`` / ``add_relu`` are EQUAL to their plain versions
(NaN where they have NaN; the elementwise ops bit for bit at ragged sizes,
views off the 16-byte grid and operands holding NaN, +-Inf and -0).  With a NaN pixel and a -Inf pixel in the
input, the fused convolutions, the GEMM, the int8 GEMM (NaN in its
residual) and the float max pool give NaN and +-Inf exactly where their
plain versions do, the other values within the tolerances above.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from resnetc_tpu_torch.ops import torch_ops
from resnetc_tpu_torch.ops.cuda import _build
from resnetc_tpu_torch.ops.cuda import block, gemm
from resnetc_tpu_torch.ops.cuda.quant import quantize_per_channel

SCALES = np.asarray([4.0 / 127, 3.0 / 127, 5.0 / 127, 6.0 / 127], np.float32)
KEYS = ("w1q", "sw1", "b1", "w2pq", "sw2p", "b2", "w3q", "sw3", "b3")
DS_KEYS = ("w1q", "sw1", "b1", "w2q", "sw2", "b2", "w3q", "sw3", "b3", "wdq", "swd", "bd")


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture()
def gen() -> np.random.Generator:
    return np.random.default_rng(4321)


@pytest.mark.cuda
def test_fp32_conv2d_and_linear_are_ieee_under_tf32(cuda, gen):
    """The port's fp32 conv2d and linear compute in IEEE fp32 with TF32
    turned on in the process (ResNet-50's 3x3 at 56x56x64 and the fc, batch
    8): within 1e-5 of max |float64|; the settings are given back."""
    conv, mm = torch.backends.cudnn.conv, torch.backends.cuda.matmul
    saved = conv.fp32_precision, mm.fp32_precision
    conv.fp32_precision = mm.fp32_precision = "tf32"
    try:
        x = gen.standard_normal((8, 56, 56, 64)).astype(np.float32)
        w = (gen.standard_normal((3, 3, 64, 64)) / 24).astype(np.float32)
        a = gen.standard_normal((8, 2048)).astype(np.float32)
        wl = (gen.standard_normal((1000, 2048)) / 45).astype(np.float32)
        bl = gen.standard_normal(1000).astype(np.float32)
        want_conv = torch.nn.functional.conv2d(
            torch.from_numpy(x).double().permute(0, 3, 1, 2),
            torch.from_numpy(w).double().permute(3, 2, 0, 1), padding=1,
        ).permute(0, 2, 3, 1)
        want_lin = torch.from_numpy(a).double() @ torch.from_numpy(wl).double().t() + \
            torch.from_numpy(bl).double()
        got_conv = torch_ops.conv2d(torch.from_numpy(x).to(cuda), torch.from_numpy(w).to(cuda),
                                    padding=1)
        got_lin = torch_ops.linear(*(torch.from_numpy(t).to(cuda) for t in (a, wl, bl)))
        assert (conv.fp32_precision, mm.fp32_precision) == ("tf32", "tf32")
        for got, want in ((got_conv, want_conv), (got_lin, want_lin)):
            assert got.dtype == torch.float32
            rel = float((got.double().cpu() - want).abs().max() / want.abs().max())
            assert rel <= 1e-5, rel
    finally:
        conv.fp32_precision, mm.fp32_precision = saved


def _quantized(gen, cin, c, c4, dev, *, proj=False, ds=False):
    def entry(shape):
        return {
            "weight": torch.from_numpy((gen.standard_normal(shape) * 0.1).astype(np.float32)),
            "bias": torch.from_numpy((gen.standard_normal(shape[-1]) * 0.1).astype(np.float32)),
        }

    blk = {"conv1": entry((1, 1, cin, c)), "conv2": entry((3, 3, c, c)),
           "conv3": entry((1, 1, c, c4))}
    if proj or ds:
        blk["downsample"] = entry((1, 1, cin, c4))
    if ds:
        q = block.quantize_ds_block(blk)
    else:
        q = block.quantize_chain_block(blk)
        if proj:
            q["wdq"], q["swd"] = quantize_per_channel(blk["downsample"]["weight"][0, 0])
            q["bd"] = blk["downsample"]["bias"]
    return {k: v.to(dev) for k, v in q.items()}


def _chain(gen, b, h, cin, dev):
    hp, wp = block.chain_meta(b, h, h)
    x = gen.integers(-127, 128, size=(b * hp * wp, cin), dtype=np.int8)
    return torch.from_numpy(x).to(dev)


# (id, h, cin, c, c4, proj, emit_i8, emit_mean)
BLOCK_CASES = [
    ("identity-h8", 8, 64, 16, 64, False, True, False),
    ("identity-h7", 7, 64, 16, 64, False, True, False),
    ("proj-h8", 8, 16, 16, 64, True, True, False),
    ("proj-h7", 7, 16, 16, 64, True, True, False),
    ("bf16-exit-h7", 7, 64, 16, 64, False, False, False),
    ("emit-mean-h8", 8, 64, 16, 64, False, False, True),
    ("emit-mean-h7", 7, 64, 16, 64, False, False, True),
    ("identity-c64-h14", 14, 256, 64, 256, False, True, False),
    # ResNet-152's stage-2 (14x14, c 256) and stage-3 (7x7, c 512) shapes
    ("identity-c256-h14", 14, 1024, 256, 1024, False, True, False),
    ("proj-c256-h14", 14, 256, 256, 1024, True, True, False),
    ("identity-c512-h7", 7, 2048, 512, 2048, False, True, False),
    ("proj-c512-h7", 7, 512, 512, 2048, True, True, False),
    ("bf16-exit-c512-h7", 7, 2048, 512, 2048, False, False, False),
    ("emit-mean-c512-h7", 7, 2048, 512, 2048, False, False, True),
    # c off the 64-wide tile; off the 16-byte chunk (the byte-by-byte path)
    ("identity-c48-h8", 8, 192, 48, 192, False, True, False),
    ("proj-c20-h7", 7, 20, 20, 80, True, False, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "h,cin,c,c4,proj,emit_i8,emit_mean",
    [case[1:] for case in BLOCK_CASES],
    ids=[case[0] for case in BLOCK_CASES],
)
def test_block_kernel_equals_plain(cuda, gen, h, cin, c, c4, proj, emit_i8, emit_mean):
    b = 2
    q = _quantized(gen, cin, c, c4, cuda, proj=proj)
    kw = dict(h=h, w_sp=h, emit_i8=emit_i8, emit_mean=emit_mean)
    if proj:
        kw.update(wdq=q["wdq"], swd=q["swd"], bd=q["bd"])
    args = (_chain(gen, b, h, cin, cuda), *(q[k] for k in KEYS),
            torch.from_numpy(SCALES).to(cuda))
    _build.reset_launches()
    got = block.bottleneck_block_chained_int8(*args, **kw)
    assert _build.LAUNCHES["bottleneck_block_chained_int8"] == 1
    want = block.bottleneck_block_chained_int8_plain(*args, **kw)
    torch.cuda.synchronize()
    if emit_mean:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert got.dtype == want.dtype and torch.equal(got, want)
    # The engine's K-major weight copies give the same bits as the per-call
    # transpose, and so does a second call.
    nk = {k + "_nk": q[k].t().contiguous() for k in ("w1q", "w2pq", "w3q", "wdq") if k in q}
    for _ in range(2):
        again = block.bottleneck_block_chained_int8(*args, **kw, **nk)
        torch.cuda.synchronize()
        assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("n_blocks,proj", [(2, False), (3, False), (3, True)])
def test_run_kernel_equals_plain(cuda, gen, n_blocks, proj):
    b, h, c, c4 = 2, 8, 16, 64
    qs = [_quantized(gen, c4, c, c4, cuda) for _ in range(n_blocks)]
    kw = dict(h=h, w_sp=h)
    w1q_s = torch.stack([q["w1q"] for q in qs])
    x = _chain(gen, b, h, c4, cuda)
    if proj:  # block 0 is a projection block over a c-channel chain
        p = _quantized(gen, c, c, c4, cuda, proj=True)
        kw.update(w1q0=p["w1q"], wdq=p["wdq"], swd=p["swd"], bd=p["bd"])
        w1q_s = w1q_s[1:]
        x = _chain(gen, b, h, c, cuda)
    scales = torch.from_numpy(np.stack([SCALES] * n_blocks)).to(cuda)
    args = (x, w1q_s, *(torch.stack([q[k] for q in qs]) for k in KEYS[1:]), scales)
    nk = {"w1q_nk_s": args[1].transpose(1, 2).contiguous(),
          "w2pq_nk_s": args[4].transpose(1, 2).contiguous(),
          "w3q_nk_s": args[7].transpose(1, 2).contiguous()}
    if proj:
        nk.update(w1q0_nk=kw["w1q0"].t().contiguous(), wdq_nk=kw["wdq"].t().contiguous())
    for emit_i8 in (True, False):
        got = block.bottleneck_run_chained_int8(*args, emit_i8=emit_i8, **kw)
        want = block.bottleneck_run_chained_int8_plain(*args, emit_i8=emit_i8, **kw)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and torch.equal(got, want)
        packed = block.bottleneck_run_chained_int8(*args, emit_i8=emit_i8, **kw, **nk)
        torch.cuda.synchronize()
        assert torch.equal(got, packed)


@pytest.mark.cuda
@pytest.mark.parametrize("h", [8, 16, 7, 14])
def test_ds_kernel_equals_plain(cuda, gen, h):
    b, cin, c, c4 = 2, 64, 16, 64
    q = _quantized(gen, cin, c, c4, cuda, ds=True)
    args = (_chain(gen, b, h, cin, cuda), *(q[k] for k in DS_KEYS),
            torch.from_numpy(SCALES).to(cuda))
    for emit_i8 in (True, False):
        got = block.downsample_block_s2_int8(*args, h=h, w_sp=h, emit_i8=emit_i8)
        want = block.downsample_block_s2_int8_plain(*args, h=h, w_sp=h, emit_i8=emit_i8)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and torch.equal(got, want)


# (id, h, cin, c, c4): ResNet-152's 14x14 transition widths cut to 14x14
# (cin 256 -> c 128 -> 4c 512), and narrow ones at odd and even sizes: wp =
# w + 1 at h = 7 and 15, round_up(w + 2, 8) at 8 and 16; c = 20 is off the
# 16-byte chunk (the byte-by-byte loader).
DS_TILE_CASES = [
    ("c128-h14", 14, 256, 128, 512),
    ("c16-h7", 7, 64, 16, 64),
    ("c16-h8", 8, 64, 16, 64),
    ("c32-h15", 15, 64, 32, 128),
    ("c32-h16", 16, 64, 32, 128),
    ("c20-h9", 9, 40, 20, 80),
]


@pytest.mark.cuda
@pytest.mark.parametrize("h,cin,c,c4", [case[1:] for case in DS_TILE_CASES],
                         ids=[case[0] for case in DS_TILE_CASES])
def test_ds_tile_kernel_equals_plain(cuda, gen, h, cin, c, c4):
    """Row 3 on the int8 tile: one launch a call, int8 and bf16 exits equal
    to the plain version with random bytes in x's ring rows, and the
    engine's K-major copies give the bits of a per-call transpose."""
    from resnetc_tpu_torch.ops.cuda.fused import kmajor_copies

    b = 2
    q = _quantized(gen, cin, c, c4, cuda, ds=True)
    args = (_chain(gen, b, h, cin, cuda), *(q[k] for k in DS_KEYS),
            torch.from_numpy(SCALES).to(cuda))
    nk = kmajor_copies(q)
    assert tuple(nk["w2q_nk"].shape) == (c, 9 * c)
    for emit_i8 in (True, False):
        _build.reset_launches()
        got = block.downsample_block_s2_int8(*args, h=h, w_sp=h, emit_i8=emit_i8)
        assert dict(_build.LAUNCHES) == {"downsample_block_s2_int8": 1}
        _assert_equal(got, block.downsample_block_s2_int8_plain(*args, h=h, w_sp=h,
                                                                emit_i8=emit_i8))
        packed = block.downsample_block_s2_int8(*args, h=h, w_sp=h, emit_i8=emit_i8, **nk)
        _assert_equal(packed, got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_matmul_kernel_close_to_plain(cuda, gen, dtype):
    x = torch.from_numpy(gen.standard_normal((8, 300)).astype(np.float32)).to(cuda, dtype)
    w = torch.from_numpy(gen.standard_normal((300, 100)).astype(np.float32)).to(cuda, dtype)
    bias = torch.from_numpy(gen.standard_normal(100).astype(np.float32)).to(cuda)
    res = torch.from_numpy(gen.standard_normal((8, 100)).astype(np.float32)).to(cuda)
    for kw in ({"out_dtype": torch.float32}, {"relu": True, "out_dtype": torch.float32}):
        got = gemm.matmul(x, w, bias, res, **kw)
        want = gemm.matmul_plain(x, w, bias, res, **kw)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


# (id, m, k, n, bias, residual dtype, relu, out dtype): the fc at batch 32
# (K split over a workspace), a ResNet-152 layer1 1x1 with a bf16 residual
# and bf16 out, an M off the tile.
MATMUL_TILE_CASES = [
    ("fc-splitk", 32, 2048, 1000, True, None, False, torch.float32),
    ("1x1-res-bf16", 2 * 56 * 56, 64, 256, True, torch.bfloat16, True, torch.bfloat16),
    ("m-off-tile", 100, 256, 192, True, torch.float32, True, torch.float32),
]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "m,k,n,bias,res,relu,out", [c[1:] for c in MATMUL_TILE_CASES],
    ids=[c[0] for c in MATMUL_TILE_CASES],
)
def test_matmul_tile_shapes_close_to_plain(cuda, gen, m, k, n, bias, res, relu, out):
    def t(shape, scale=1.0, dtype=torch.bfloat16):
        return torch.from_numpy((gen.standard_normal(shape) * scale).astype(np.float32)).to(
            cuda, dtype)

    args = (t((m, k)), t((k, n), k**-0.5), t((n,), 0.1, torch.float32) if bias else None,
            t((m, n), 1.0, res) if res else None)
    _build.reset_launches()
    got = gemm.matmul(*args, relu=relu, out_dtype=out)
    assert _build.LAUNCHES["matmul"] == 1
    again = gemm.matmul(*args, relu=relu, out_dtype=out)
    want = gemm.matmul_plain(*args, relu=relu, out_dtype=out)
    torch.cuda.synchronize()
    assert torch.equal(got, again)  # split-K sums its slices in a fixed order
    assert got.dtype == want.dtype and got.shape == want.shape
    if out == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    else:
        assert _bf16_within_one_ulp(got, want)


BASIC_SCALES = np.asarray([4.0 / 127, 3.0 / 127, 5.0 / 127], np.float32)
BASIC_KEYS = ("w1pq", "sw1p", "b1", "w2pq", "sw2p", "b2")
BASIC_DS_KEYS = ("w1pq", "sw1", "b1", "w2pq", "sw2p", "b2", "wdq", "swd", "bd")


def _basic_quantized(gen, cin, c, dev, *, ds=False):
    def entry(shape):
        return {
            "weight": torch.from_numpy((gen.standard_normal(shape) * 0.1).astype(np.float32)),
            "bias": torch.from_numpy((gen.standard_normal(shape[-1]) * 0.1).astype(np.float32)),
        }

    blk = {"conv1": entry((3, 3, cin, c)), "conv2": entry((3, 3, c, c))}
    if ds:
        blk["downsample"] = entry((1, 1, cin, c))
        q = block.quantize_basic_ds_block(blk)
        q = {k: v for k, v in q.items() if k in BASIC_DS_KEYS}
    else:
        q = block.quantize_basic_block(blk)
    return {k: v.to(dev) for k, v in q.items()}


# (h, c): the first three small; ResNet-34's stage-1..3 shapes (28x28 c 128,
# 14x14 c 256, 7x7 c 512, where wp = w + 1); c off the 16-byte chunk (the
# byte-by-byte path of the tile).
BASIC_BLOCK_SHAPES = [(8, 16), (7, 32), (14, 64), (28, 128), (14, 256), (7, 512), (8, 20)]


@pytest.mark.cuda
@pytest.mark.parametrize("h,c", BASIC_BLOCK_SHAPES)
def test_basic_block_kernel_equals_plain(cuda, gen, h, c):
    """Row 7 on the int8 tile, x's ring random bytes, both exits; the
    engine's K-major copies give the same bits as a per-call transpose, and
    so does a second call."""
    b = 2
    q = _basic_quantized(gen, c, c, cuda)
    args = (_chain(gen, b, h, c, cuda), *(q[k] for k in BASIC_KEYS),
            torch.from_numpy(BASIC_SCALES).to(cuda))
    nk = {"w1pq_nk": q["w1pq"].t().contiguous(), "w2pq_nk": q["w2pq"].t().contiguous()}
    for emit_i8 in (True, False):
        _build.reset_launches()
        got = block.basic_block_chained_int8(*args, h=h, w_sp=h, emit_i8=emit_i8)
        assert _build.LAUNCHES["basic_block_chained_int8"] == 1
        want = block.basic_block_chained_int8_plain(*args, h=h, w_sp=h, emit_i8=emit_i8)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and torch.equal(got, want)
        for _ in range(2):
            again = block.basic_block_chained_int8(*args, h=h, w_sp=h, emit_i8=emit_i8, **nk)
            torch.cuda.synchronize()
            assert torch.equal(got, again)


def _basic_run_args(gen, dev, n_blocks, b, h, c):
    qs = [_basic_quantized(gen, c, c, dev) for _ in range(n_blocks)]
    scales = np.stack([BASIC_SCALES * np.float32(1.0 + 0.1 * i) for i in range(n_blocks)])
    scales[1:, 0] = scales[:-1, 2]  # block i's s_y is block i+1's s_x
    return (_chain(gen, b, h, c, dev), *(torch.stack([q[k] for q in qs]) for k in BASIC_KEYS),
            torch.from_numpy(scales.astype(np.float32)).to(dev))


# (n_blocks, h, c): small; ResNet-34's stage widths (stage 0 at 14x14 to
# stay small); c off the 16-byte chunk.
BASIC_RUN_SHAPES = [(2, 8, 16), (3, 8, 16), (3, 14, 64), (2, 14, 256), (2, 7, 512), (3, 7, 20)]


@pytest.mark.cuda
@pytest.mark.parametrize("n_blocks,h,c", BASIC_RUN_SHAPES)
def test_basic_run_kernel_equals_plain(cuda, gen, n_blocks, h, c):
    """Row 8 on the int8 tile, both exits; the stacked K-major copies give
    the same bits as a per-call transpose."""
    args = _basic_run_args(gen, cuda, n_blocks, 2, h, c)
    nk = {"w1pq_nk_s": args[1].transpose(1, 2).contiguous(),
          "w2pq_nk_s": args[4].transpose(1, 2).contiguous()}
    for emit_i8 in (True, False):
        _build.reset_launches()
        got = block.basic_run_chained_int8(*args, h=h, w_sp=h, emit_i8=emit_i8)
        assert dict(_build.LAUNCHES) == {"basic_run_chained_int8": 1}
        _assert_equal(got, block.basic_run_chained_int8_plain(*args, h=h, w_sp=h,
                                                              emit_i8=emit_i8))
        packed = block.basic_run_chained_int8(*args, h=h, w_sp=h, emit_i8=emit_i8, **nk)
        torch.cuda.synchronize()
        assert torch.equal(got, packed)


# (id, h, w, cin, c): small at even, odd (the last output row and column
# read ring taps of x) and non-square sizes; ResNet-34's three transition
# widths at cut sizes (64 -> 128 at 15x15, where wp = w + 1; 128 -> 256 at
# 14x14; 256 -> 512 at 7x7); cin off the 16-byte chunk (the byte-by-byte
# loader and mask).
BASIC_DS_CASES = [
    ("c32-10x10", 10, 10, 16, 32),
    ("c32-7x7", 7, 7, 16, 32),
    ("c32-10x14", 10, 14, 16, 32),
    ("c32-14x14", 14, 14, 16, 32),
    ("c32-9x13", 9, 13, 32, 32),
    ("c128-15x15", 15, 15, 64, 128),
    ("c256-14x14", 14, 14, 128, 256),
    ("c512-7x7", 7, 7, 256, 512),
    ("cin20-c24-9x9", 9, 9, 20, 24),
]


def _basic_ds_args(gen, dev, h, w, cin, c, b=2):
    q = _basic_quantized(gen, cin, c, dev, ds=True)
    hp, wp = block.chain_meta(b, h, w)
    x = torch.from_numpy(gen.integers(-127, 128, size=(b * hp * wp, cin), dtype=np.int8)).to(dev)
    return q, (x, *(q[k] for k in BASIC_DS_KEYS), torch.from_numpy(BASIC_SCALES).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,cin,c", [case[1:] for case in BASIC_DS_CASES],
                         ids=[case[0] for case in BASIC_DS_CASES])
def test_basic_ds_kernel_equals_plain(cuda, gen, h, w, cin, c):
    """Row 11 on the int8 tile: one launch a call, both exits equal to the
    plain version with random bytes in x's ring rows, and the engine's
    K-major copies give the bits of a per-call transpose."""
    from resnetc_tpu_torch.ops.cuda.fused import basic_ds_kmajor_copies

    q, args = _basic_ds_args(gen, cuda, h, w, cin, c)
    nk = basic_ds_kmajor_copies(q)
    for emit_i8 in (True, False):
        _build.reset_launches()
        got = block.basic_ds_block_s2_int8(*args, h=h, w_sp=w, emit_i8=emit_i8)
        assert dict(_build.LAUNCHES) == {"basic_ds_block_s2_int8": 1}
        _assert_equal(got, block.basic_ds_block_s2_int8_plain(*args, h=h, w_sp=w,
                                                              emit_i8=emit_i8))
        packed = block.basic_ds_block_s2_int8(*args, h=h, w_sp=w, emit_i8=emit_i8, **nk)
        _assert_equal(packed, got)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,cin,c", [(7, 7, 16, 32), (10, 14, 64, 128), (9, 9, 20, 24)],
                         ids=["c32-7x7", "c128-10x14", "cin20-c24-9x9"])
def test_basic_ds_ring_garbage_never_reaches_the_interior(cuda, gen, h, w, cin, c):
    """x's ring rows may hold anything: with -128 there (the one int8 value
    no requantized activation takes; an int8 chain cannot hold a NaN) the
    output equals, bit for bit and ring rows included, the output with a
    zero ring, for both exits."""
    _, args = _basic_ds_args(gen, cuda, h, w, cin, c)
    x = args[0]
    ring = ~block.pad_for_chain(torch.ones((2, h, w, 1), device=cuda)).bool()[:, 0]
    clean, dirty = x.clone(), x.clone()
    clean[ring], dirty[ring] = 0, -128
    for emit_i8 in (True, False):
        got = block.basic_ds_block_s2_int8(dirty, *args[1:], h=h, w_sp=w, emit_i8=emit_i8)
        want = block.basic_ds_block_s2_int8(clean, *args[1:], h=h, w_sp=w, emit_i8=emit_i8)
        _assert_equal(got, want)


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda, gen):
    q = _quantized(gen, 64, 16, 64, cuda)
    x = _chain(gen, 2, 8, 64, cuda)
    args = (x, *(q[k] for k in KEYS), torch.from_numpy(SCALES).to(cuda))
    with pytest.raises(ValueError):
        block.bottleneck_block_chained_int8(*args, h=8, w_sp=8, emit_mean=True)
    with pytest.raises(ValueError):  # float weights where the kernel takes int8
        block.bottleneck_block_chained_int8(x, args[1].float(), *args[2:], h=8, w_sp=8)
    with pytest.raises(ValueError):  # mixed operand dtypes
        gemm.matmul(torch.ones(2, 4, device=cuda),
                    torch.ones(4, 3, device=cuda, dtype=torch.bfloat16))


@pytest.mark.cuda
def test_tiny_engine_on_the_card_matches_plain(cuda, monkeypatch):
    from resnetc_tpu_torch.models import resnet
    from resnetc_tpu_torch.ops.cuda import fused
    from resnetc_tpu_torch.ops.cuda.fused import PLAIN, fused_forward_int8_chain
    from resnetc_tpu_torch.serve import InferenceEngine

    monkeypatch.setattr(fused, "L1_PIXEL_PAIR", False)
    cfg = resnet.ResNetConfig("tiny", "bottleneck", (3, 2, 2, 2), num_classes=11, stem_width=16)
    variables = resnet.init(cfg, torch.Generator().manual_seed(0))
    x = torch.randn((2, 64, 64, 3), generator=torch.Generator().manual_seed(1))
    eng = InferenceEngine(cfg, variables, backend="int8_chain", calib_batch=x)
    assert eng.device.type == "cuda"
    _build.reset_launches()
    got = eng.logits(x)
    counts = dict(_build.LAUNCHES)
    assert counts == {"bottleneck_block_chained_int8": 4, "bottleneck_run_chained_int8": 1,
                      "downsample_block_s2_int8": 3, "matmul": 1}, counts
    want = fused_forward_int8_chain(cfg, eng.folded, eng.chain_scales, x.to(cuda), kernels=PLAIN)
    torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2)
    assert torch.equal(got.argmax(-1), want.argmax(-1))


def _unpacked(tree: dict) -> dict:
    """An int8_chain engine's tree without what ``pack_chain_kmajor`` added
    (the K-major copies, the stacked runs)."""
    return {k: ({b: {n: t for n, t in blk.items() if not n.endswith("_nk")}
                 for b, blk in v.items()} if k.startswith("layer") else v)
            for k, v in tree.items() if k != "runs"}


@pytest.mark.cuda
def test_tiny_basic_engine_on_the_card_matches_plain(cuda, monkeypatch):
    from resnetc_tpu_torch.models import resnet
    from resnetc_tpu_torch.ops.cuda import fused
    from resnetc_tpu_torch.ops.cuda.fused import PLAIN, fused_forward_int8_chain
    from resnetc_tpu_torch.serve import InferenceEngine

    monkeypatch.setattr(fused, "L1_PIXEL_PAIR", False)
    monkeypatch.setattr(fused, "BASIC_DS_INT8", True)
    cfg = resnet.ResNetConfig("tiny_basic", "basic", (3, 2, 2, 2), num_classes=11, stem_width=16)
    variables = resnet.init(cfg, torch.Generator().manual_seed(0))
    x = torch.randn((2, 64, 64, 3), generator=torch.Generator().manual_seed(1))
    eng = InferenceEngine(cfg, variables, backend="int8_chain", calib_batch=x)
    _build.reset_launches()
    got = eng.logits(x)
    counts = dict(_build.LAUNCHES)
    assert counts == {"basic_run_chained_int8": 1, "basic_ds_block_s2_int8": 3,
                      "basic_block_chained_int8": 3, "matmul": 1}, counts
    want = fused_forward_int8_chain(cfg, eng.folded, eng.chain_scales, x.to(cuda), kernels=PLAIN)
    torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2)
    assert torch.equal(got.argmax(-1), want.argmax(-1))
    # The engine's packed tree (K-major copies, stacked run) and the tree
    # without them give the same bits.
    again = fused_forward_int8_chain(cfg, _unpacked(eng.folded), eng.chain_scales, x.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got, again)


# ---------------------------------------------------------------------------
# The pixel-paired stage-0 kernels (c = 64)
# ---------------------------------------------------------------------------


def _assert_equal(got, want):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert len(torch.unique(got.float())) > 20  # not a degenerate case


@pytest.mark.cuda
@pytest.mark.parametrize("h", [8, 7, 14])
@pytest.mark.parametrize("proj", [False, True], ids=["identity", "proj"])
def test_pp_block_kernel_equals_plain(cuda, gen, h, proj):
    b, c = 2, 64
    cin = 64 if proj else 256
    q = _quantized(gen, cin, c, 256, cuda, proj=proj)
    kw = dict(h=h, w_sp=h)
    if proj:
        kw.update(wdq=q["wdq"], swd=q["swd"], bd=q["bd"])
    args = (_chain(gen, b, h, cin, cuda), *(q[k] for k in KEYS), torch.from_numpy(SCALES).to(cuda))
    for emit_i8 in (True, False):
        _build.reset_launches()
        got = block.bottleneck_block_chained_int8_pp(*args, emit_i8=emit_i8, **kw)
        assert dict(_build.LAUNCHES) == {"bottleneck_block_chained_int8_pp": 1}
        _assert_equal(got, block.bottleneck_block_chained_int8_pp_plain(*args, emit_i8=emit_i8, **kw))
        # ... and the standard kernel's output, bit for bit.
        _assert_equal(got, block.bottleneck_block_chained_int8(*args, emit_i8=emit_i8, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("n_blocks,proj", [(2, False), (3, False), (3, True)])
def test_pp_run_kernel_equals_plain(cuda, gen, n_blocks, proj):
    b, h, c, c4 = 2, 8, 64, 256
    qs = [_quantized(gen, c4, c, c4, cuda) for _ in range(n_blocks)]
    kw = dict(h=h, w_sp=h)
    w1q_s = torch.stack([q["w1q"] for q in qs])
    x = _chain(gen, b, h, c4, cuda)
    if proj:
        p = _quantized(gen, c, c, c4, cuda, proj=True)
        kw.update(w1q0=p["w1q"], wdq=p["wdq"], swd=p["swd"], bd=p["bd"])
        w1q_s = w1q_s[1:]
        x = _chain(gen, b, h, c, cuda)
    scales = torch.from_numpy(np.stack([SCALES] * n_blocks)).to(cuda)
    args = (x, w1q_s, *(torch.stack([q[k] for q in qs]) for k in KEYS[1:]), scales)
    for emit_i8 in (True, False):
        _build.reset_launches()
        got = block.bottleneck_run_chained_int8_pp(*args, emit_i8=emit_i8, **kw)
        assert dict(_build.LAUNCHES) == {"bottleneck_run_chained_int8_pp": 1}
        _assert_equal(got, block.bottleneck_run_chained_int8_pp_plain(*args, emit_i8=emit_i8, **kw))
        _assert_equal(got, block.bottleneck_run_chained_int8(*args, emit_i8=emit_i8, **kw))


def _pp_engine_tree(qs):
    """The engine's tree (``pack_chain_kmajor``) with ``qs`` as stage 0's
    blocks (every stage the same): the pair copies of rows 5 and 6."""
    from resnetc_tpu_torch.models import resnet
    from resnetc_tpu_torch.ops.cuda import fused

    layer = {str(i): q for i, q in enumerate(qs)}
    return fused.pack_chain_kmajor(resnet.get_config("resnet50"),
                                   {f"layer{s + 1}": layer for s in range(4)})


@pytest.mark.cuda
@pytest.mark.parametrize("h", [8, 7, 14])
def test_pp_bottleneck_kernels_on_the_engines_pair_weights(cuda, gen, h):
    """Rows 5 and 6 through the engine's pre-packed pair operands (the
    K-major block-diagonal 1x1s and pair-packed 3x3s, the stacked run and
    each block's views of it) give the bits of packing per call, one launch
    a call."""
    from resnetc_tpu_torch.ops.cuda import fused

    b, c, c4, n_blocks = 2, 64, 256, 3
    qs = [_quantized(gen, c, c, c4, cuda, proj=True)]
    qs += [_quantized(gen, c4, c, c4, cuda) for _ in range(n_blocks - 1)]
    tree = _pp_engine_tree(qs)
    layer = [tree["layer1"][str(i)] for i in range(n_blocks)]
    run = tree["runs"]["layer1"]
    scales = torch.from_numpy(np.stack([SCALES] * n_blocks)).to(cuda)
    x0, x1 = _chain(gen, b, h, c, cuda), _chain(gen, b, h, c4, cuda)
    for emit_i8 in (True, False):
        kw = dict(h=h, w_sp=h, emit_i8=emit_i8)
        for i, x in ((0, x0), (1, x1)):  # the projection block and an identity one
            blk = layer[i]
            bkw = dict(kw, **{k: blk.get(k) for k in ("wdq", "swd", "bd")})
            args = (x, *(blk[k] for k in KEYS), scales[i])
            _build.reset_launches()
            got = block.bottleneck_block_chained_int8_pp(*args, **bkw,
                                                         **fused.kmajor_kwargs(blk, pp=True))
            assert dict(_build.LAUNCHES) == {"bottleneck_block_chained_int8_pp": 1}
            _assert_equal(got, block.bottleneck_block_chained_int8_pp(*args, **bkw))
        for first, x in ((0, x0), (1, x1)):  # all of layer1, and its blocks 1..
            stacked, nk = fused.pp_run_operands(layer, run, first)
            unpacked, _ = fused.pp_run_operands(layer, None, first)
            rkw = dict(kw)
            if first == 0:
                rkw.update(w1q0=layer[0]["w1q"], **{k: layer[0][k] for k in ("wdq", "swd", "bd")})
            _build.reset_launches()
            got = block.bottleneck_run_chained_int8_pp(x, *stacked, scales[first:], **rkw, **nk)
            assert dict(_build.LAUNCHES) == {"bottleneck_run_chained_int8_pp": 1}
            _assert_equal(got, block.bottleneck_run_chained_int8_pp(x, *unpacked, scales[first:],
                                                                    **rkw))


@pytest.mark.cuda
@pytest.mark.parametrize("h", [8, 14])
def test_pp_basic_kernels_on_the_engines_pair_weights(cuda, gen, h):
    """Rows 9 and 10 through the engine's pre-packed pair operands
    (``pack_chain_kmajor``'s K-major copies of the pair-packed 3x3s, and the
    per-block views of them) give the same bits as packing per call."""
    from resnetc_tpu_torch.models import resnet
    from resnetc_tpu_torch.ops.cuda import fused

    b, c, n_blocks = 2, 64, 3
    qs = [_basic_quantized(gen, c, c, cuda) for _ in range(n_blocks)]
    tree = {f"layer{s + 1}": {str(i): q for i, q in enumerate(qs)} for s in range(4)}
    cfg = resnet.get_config("resnet34")
    run = fused.pack_chain_kmajor(cfg, tree)["runs"]["layer1"]
    x = _chain(gen, b, h, c, cuda)
    stacked = (*(torch.stack([q[k] for q in qs]) for k in BASIC_KEYS),
               torch.from_numpy(np.stack([BASIC_SCALES] * n_blocks)).to(cuda))
    for emit_i8 in (True, False):
        kw = dict(h=h, w_sp=h, emit_i8=emit_i8)
        want = block.basic_run_chained_int8_pp(x, *stacked, **kw)
        got = block.basic_run_chained_int8_pp(
            x, *stacked, **kw, w1pp_nk_s=run["w1pp_nk_s"], w2pp_nk_s=run["w2pp_nk_s"])
        _assert_equal(got, want)
        args = (x, *(qs[1][k] for k in BASIC_KEYS), stacked[-1][1])
        one = block.basic_block_chained_int8_pp(
            *args, **kw, w1pp_nk=run["w1pp_nk_s"][1], w2pp_nk=run["w2pp_nk_s"][1])
        _assert_equal(one, block.basic_block_chained_int8_pp(*args, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("h", [8, 7, 14])
def test_pp_basic_kernels_equal_plain(cuda, gen, h):
    b, c, n_blocks = 2, 64, 3
    qs = [_basic_quantized(gen, c, c, cuda) for _ in range(n_blocks)]
    x = _chain(gen, b, h, c, cuda)
    s1 = torch.from_numpy(BASIC_SCALES).to(cuda)
    stacked = (*(torch.stack([q[k] for q in qs]) for k in BASIC_KEYS),
               torch.from_numpy(np.stack([BASIC_SCALES] * n_blocks)).to(cuda))
    for emit_i8 in (True, False):
        kw = dict(h=h, w_sp=h, emit_i8=emit_i8)
        args = (x, *(qs[0][k] for k in BASIC_KEYS), s1)
        _build.reset_launches()
        got = block.basic_block_chained_int8_pp(*args, **kw)
        run = block.basic_run_chained_int8_pp(x, *stacked, **kw)
        assert dict(_build.LAUNCHES) == {"basic_block_chained_int8_pp": 1,
                                         "basic_run_chained_int8_pp": 1}
        _assert_equal(got, block.basic_block_chained_int8_pp_plain(*args, **kw))
        _assert_equal(got, block.basic_block_chained_int8(*args, **kw))
        _assert_equal(run, block.basic_run_chained_int8_pp_plain(x, *stacked, **kw))
        _assert_equal(run, block.basic_run_chained_int8(x, *stacked, **kw))


def _dense_pair_cases(gen, dev, b, h):
    """Each pair-space entry with dense random operands: int8 weights in
    [-20, 20] over every block, multipliers sized to each dot's depth k (an
    output spread of about ten int8 steps), biases, and a residual scale 0.5.
    Returns {name: (entry, plain, args, kwargs)}."""
    hp, wp = block.chain_meta(b, h, h)
    rows2 = b * hp * wp // 2
    c2, c4p, n = 128, 512, 2

    def x(width):
        return torch.from_numpy(gen.integers(-127, 128, size=(rows2, width), dtype=np.int8)).to(dev)

    def wq(*shape):
        return torch.from_numpy(gen.integers(-20, 21, size=shape, dtype=np.int8)).to(dev)

    def mul(*shape, k):
        v = gen.uniform(0.5, 1.5, size=shape) * 10.0 / (np.sqrt(k) * 40.0 * 12.0)
        return torch.from_numpy(v.astype(np.float32)).to(dev)

    def bias(*shape):
        return torch.from_numpy((gen.standard_normal(shape) * 0.5).astype(np.float32)).to(dev)

    def s_res(k):
        return torch.full((k,), 0.5, dtype=torch.float32, device=dev)

    def conv2(n_blocks):
        """A pair-packed 3x3 stack and its (3N, c2) multipliers."""
        return wq(n_blocks, 3 * c2, 3 * c2), mul(3 * n_blocks, c2, k=3 * c2)

    kw = dict(h=h, w_sp=h)
    w2, a2 = conv2(1)
    w2s, a2s = conv2(n)
    bw1, ba1 = conv2(1)
    rw1, ra1 = conv2(n)
    return {
        "block": (block.bottleneck_block_pp_pairs, block.bottleneck_block_pp_pairs_plain,
                  (x(c4p), wq(c4p, c2), mul(c2, k=c4p), bias(c2), w2[0], a2, bias(c2),
                   wq(c2, c4p), mul(c4p, k=c2), bias(c4p), s_res(1)), kw),
        "block-proj": (block.bottleneck_block_pp_pairs, block.bottleneck_block_pp_pairs_plain,
                       (x(c2), wq(c2, c2), mul(c2, k=c2), bias(c2), w2[0], a2, bias(c2),
                        wq(c2, c4p), mul(c4p, k=c2), bias(c4p), s_res(1)),
                       dict(kw, wdbd=wq(c2, c4p), ad=mul(c4p, k=c2), cd=bias(c4p))),
        "run-proj": (block.bottleneck_run_pp_pairs, block.bottleneck_run_pp_pairs_plain,
                     (x(c2), wq(n - 1, c4p, c2), mul(n, c2, k=c4p), bias(n, c2), w2s, a2s,
                      bias(n, c2), wq(n, c2, c4p), mul(n, c4p, k=c2), bias(n, c4p), s_res(n)),
                     dict(kw, w10bd=wq(c2, c2), wdbd=wq(c2, c4p), ad=mul(c4p, k=c2),
                          cd=bias(c4p))),
        "basic": (block.basic_block_pp_pairs, block.basic_block_pp_pairs_plain,
                  (x(c2), bw1[0], ba1, bias(c2), w2[0], a2, bias(c2), s_res(1)), kw),
        "basic-run": (block.basic_run_pp_pairs, block.basic_run_pp_pairs_plain,
                      (x(c2), rw1, ra1, bias(n, c2), w2s, a2s, bias(n, c2), s_res(n)), kw),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["block", "block-proj", "run-proj", "basic", "basic-run"])
def test_pp_kernels_equal_plain_on_dense_pair_weights(cuda, gen, case):
    """The pair-space entries with dense random weights (no zero blocks):
    the kernels are dense pair-space GEMMs, so they must still equal their
    plain versions."""
    fn, plain, args, kw = _dense_pair_cases(gen, cuda, 2, 7)[case]
    for emit_i8 in (True, False):
        got = fn(*args, emit_i8=emit_i8, **kw)
        _assert_equal(got, plain(*args, emit_i8=emit_i8, **kw))


def _pp_route(cfg_name, stage_blocks, cuda, monkeypatch):
    from resnetc_tpu_torch.models import resnet
    from resnetc_tpu_torch.ops.cuda import fused
    from resnetc_tpu_torch.serve import InferenceEngine

    cfg = resnet.get_config(cfg_name, num_classes=11)
    cfg = cfg.__class__(**{**cfg.__dict__, "stage_blocks": stage_blocks})
    variables = resnet.init(cfg, torch.Generator().manual_seed(0))
    x = torch.randn((2, 64, 64, 3), generator=torch.Generator().manual_seed(1))
    eng = InferenceEngine(cfg, variables, backend="int8_chain", calib_batch=x)
    monkeypatch.setattr(fused, "BASIC_DS_INT8", True)
    out = {}
    for pp in (False, True):
        monkeypatch.setattr(fused, "L1_PIXEL_PAIR", pp)
        _build.reset_launches()
        out[pp] = (eng.logits(x), dict(_build.LAUNCHES))
    torch.cuda.synchronize()
    return out


@pytest.mark.cuda
def test_pp_route_logits_equal_standard_route(cuda, monkeypatch):
    out = _pp_route("resnet50", (3, 2, 2, 2), cuda, monkeypatch)
    assert out[False][1] == {"bottleneck_block_chained_int8": 4, "bottleneck_run_chained_int8": 1,
                             "downsample_block_s2_int8": 3, "matmul": 1}, out[False][1]
    assert out[True][1] == {"bottleneck_block_chained_int8_pp": 1,
                            "bottleneck_run_chained_int8_pp": 1,
                            "bottleneck_block_chained_int8": 3,
                            "downsample_block_s2_int8": 3, "matmul": 1}, out[True][1]
    assert torch.equal(out[True][0], out[False][0])


@pytest.mark.cuda
@pytest.mark.parametrize("stage_fuse_proj", [False, True], ids=["run", "stage-fuse-proj"])
def test_pp_packed_tree_equals_unpacked_on_the_card(cuda, monkeypatch, stage_fuse_proj):
    """A cut ResNet-50's int8_chain forward on the engine's tree (the
    transitions' K-major copies, stage 0's pair copies and stacked run)
    equals the forward on the tree without them, bit for bit, paired and
    standard."""
    from resnetc_tpu_torch.models import resnet
    from resnetc_tpu_torch.ops.cuda import fused
    from resnetc_tpu_torch.serve import InferenceEngine

    cfg = resnet.get_config("resnet50", num_classes=11)
    cfg = cfg.__class__(**{**cfg.__dict__, "stage_blocks": (3, 2, 2, 2)})
    variables = resnet.init(cfg, torch.Generator().manual_seed(0))
    x = torch.randn((2, 64, 64, 3), generator=torch.Generator().manual_seed(1))
    eng = InferenceEngine(cfg, variables, backend="int8_chain", calib_batch=x)
    assert "runs" in eng.folded and "w2q_nk" in eng.folded["layer2"]["0"]
    monkeypatch.setattr(fused, "STAGE_FUSE_PROJ", stage_fuse_proj)
    for pp in (True, False):
        monkeypatch.setattr(fused, "L1_PIXEL_PAIR", pp)
        got = eng.logits(x)
        again = fused.fused_forward_int8_chain(cfg, _unpacked(eng.folded), eng.chain_scales,
                                               x.to(cuda))
        torch.cuda.synchronize()
        assert torch.equal(got, again)


@pytest.mark.cuda
def test_pp_basic_route_logits_equal_standard_route(cuda, monkeypatch):
    out = _pp_route("resnet34", (3, 2, 2, 2), cuda, monkeypatch)
    assert out[False][1] == {"basic_run_chained_int8": 1, "basic_ds_block_s2_int8": 3,
                             "basic_block_chained_int8": 3, "matmul": 1}, out[False][1]
    assert out[True][1] == {"basic_run_chained_int8_pp": 1, "basic_ds_block_s2_int8": 3,
                            "basic_block_chained_int8": 3, "matmul": 1}, out[True][1]
    assert torch.equal(out[True][0], out[False][0])


# ---------------------------------------------------------------------------
# The int8 and pallas backends: int8_matmul, the fused convs, max pool
# ---------------------------------------------------------------------------


def _bf16_within_one_ulp(got, want):
    g, w = got.float(), want.float()
    err = (g - w).abs()
    _, e = torch.frexp(torch.maximum(g.abs(), w.abs()))
    ulp = torch.ldexp(torch.ones_like(g), e - 8)
    return bool(((err <= ulp) | (err <= 1e-5 * w.abs().max())).all())


def _assert_conv_close(got, want):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        assert _bf16_within_one_ulp(got, want)


# (id, m, k, n, bias, residual dtype, relu, out dtype): ResNet-152 1x1
# shapes at batch 2, the fc, K off the 16-byte chunk (the byte-by-byte
# path), M and N off the tile (N off 8: the ragged epilogue), and the fc at
# batch 32 (K split over the int32 workspace).
INT8_GEMM_CASES = [
    ("l1-conv1", 2 * 56 * 56, 256, 64, True, None, True, torch.bfloat16),
    ("l1-conv3-res", 2 * 56 * 56, 64, 256, True, torch.bfloat16, True, torch.bfloat16),
    ("l4-conv3-res-f32", 2 * 49, 512, 2048, True, torch.float32, True, torch.float32),
    ("fc", 2, 2048, 1000, True, None, False, torch.float32),
    ("no-bias-res", 300, 132, 72, False, torch.float32, False, torch.float32),
    ("odd-k", 100, 130, 40, True, None, False, torch.float32),
    ("mn-off-tile", 200, 256, 130, True, torch.bfloat16, True, torch.bfloat16),
    ("l3-conv1", 2 * 196, 1024, 256, True, None, True, torch.bfloat16),
    ("fc-b32-splitk", 32, 2048, 1000, True, None, False, torch.float32),
]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "m,k,n,bias,res,relu,out", [c[1:] for c in INT8_GEMM_CASES],
    ids=[c[0] for c in INT8_GEMM_CASES],
)
def test_int8_matmul_kernel_equals_plain(cuda, gen, m, k, n, bias, res, relu, out):
    from resnetc_tpu_torch.ops.cuda import quant

    def t(a, dtype=None):
        return torch.from_numpy(a).to(cuda, dtype)

    x = t(gen.integers(-127, 128, size=(m, k), dtype=np.int8))
    w = t(gen.integers(-127, 128, size=(k, n), dtype=np.int8))
    sx = torch.tensor(0.0371, device=cuda)
    sw = t((gen.random(n) * 2e-3 + 1e-4).astype(np.float32))
    b = t((gen.standard_normal(n) * 4).astype(np.float32)) if bias else None
    r = t((gen.standard_normal((m, n)) * 4).astype(np.float32), res) if res else None
    _build.reset_launches()
    got = quant.int8_matmul(x, w, sx, sw, b, r, relu=relu, out_dtype=out)
    assert _build.LAUNCHES["int8_matmul"] == 1
    want = quant.int8_matmul_plain(x, w, sx, sw, b, r, relu=relu, out_dtype=out)
    _assert_equal(got, want)
    # The (N, K) copy that the int8 engine packs gives the same bits as the
    # per-call transpose, and so does a second call (split-K sums exactly).
    w_nk = quant.pack_kmajor({"w_q": w})["w_nk"]
    for _ in range(2):
        again = quant.int8_matmul(x, w, sx, sw, b, r, relu=relu, out_dtype=out, w_nk=w_nk)
        torch.cuda.synchronize()
        assert torch.equal(got, again)


# (id, b, h, w, cin, cout, residual, dtype): ResNet-152 / ResNet-34 3x3
# stride-1 shapes at batch 2, and odd sizes off the 64-wide tile (Cin 24:
# K stages that straddle taps; Cin 12: 16-byte chunks that do).
CONV_S1_CASES = [
    ("r152-l1", 2, 56, 56, 64, 64, False, torch.bfloat16),
    ("r34-l4-res", 2, 7, 7, 512, 512, True, torch.bfloat16),
    ("r152-l3-f32", 2, 14, 14, 256, 256, False, torch.float32),
    ("odd-res-f32", 3, 9, 7, 24, 40, True, torch.float32),
    ("odd-res-bf16", 3, 9, 7, 24, 40, True, torch.bfloat16),
    ("r152-l4", 2, 7, 7, 512, 512, False, torch.bfloat16),
    ("cin-off-8-bf16", 2, 6, 5, 12, 24, True, torch.bfloat16),
]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,h,w,cin,cout,res,dtype", [c[1:] for c in CONV_S1_CASES],
    ids=[c[0] for c in CONV_S1_CASES],
)
def test_conv3x3_s1_kernel_close_to_plain(cuda, gen, b, h, w, cin, cout, res, dtype):
    from resnetc_tpu_torch.ops.cuda import conv

    def t(shape, scale=1.0, dt=dtype):
        return torch.from_numpy((gen.standard_normal(shape) * scale).astype(np.float32)).to(
            cuda, dt)

    args = (t((b, h, w, cin)), t((3, 3, cin, cout), (9 * cin) ** -0.5),
            t((cout,), 0.1, torch.float32), t((b, h, w, cout)) if res else None)
    _build.reset_launches()
    got = conv.conv3x3_s1_fused(*args, relu=True)
    assert _build.LAUNCHES["conv3x3_s1_fused"] == 1
    _assert_conv_close(got, conv.conv3x3_s1_fused_plain(*args, relu=True))
    # no bias, no relu
    _assert_conv_close(conv.conv3x3_s1_fused(*args[:2]), conv.conv3x3_s1_fused_plain(*args[:2]))


# (id, b, h, cin, cout, k, dtype): the stride-2 3x3s of ResNet-152 (conv2
# of layers 2-4) and ResNet-34 (layer2 conv1) at batch 2, odd sizes, k =
# 5, 7 and 9 (beyond the 49 taps a per-row mask of 64 bits would hold), a
# stem-like 7x7 on Cin = 3 (the value-by-value path), a Cout off the
# 64-wide tile and one off the 8-channel grid.
CONV_S2_CASES = [
    ("r152-l2", 2, 56, 128, 128, 3, torch.bfloat16),
    ("r34-l2", 2, 56, 64, 128, 3, torch.bfloat16),
    ("r34-l4-f32", 2, 14, 256, 512, 3, torch.float32),
    ("odd-f32", 2, 9, 16, 72, 3, torch.float32),
    ("k5", 2, 13, 8, 16, 5, torch.float32),
    ("k7", 2, 13, 8, 16, 7, torch.bfloat16),
    ("r152-l3", 2, 28, 256, 256, 3, torch.bfloat16),
    ("r152-l4", 2, 14, 512, 512, 3, torch.bfloat16),
    ("k9", 2, 19, 8, 16, 9, torch.bfloat16),
    ("k9-wide", 2, 21, 64, 64, 9, torch.bfloat16),
    ("stem-k7-cin3", 2, 64, 3, 64, 7, torch.bfloat16),
    ("cout-off-tile-bf16", 2, 9, 16, 72, 3, torch.bfloat16),
    ("cout-off-8-bf16", 2, 11, 16, 20, 5, torch.bfloat16),
]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,h,cin,cout,k,dtype", [c[1:] for c in CONV_S2_CASES], ids=[c[0] for c in CONV_S2_CASES]
)
def test_conv_s2_kernel_close_to_plain(cuda, gen, b, h, cin, cout, k, dtype):
    from resnetc_tpu_torch.ops.cuda import conv

    def t(shape, scale=1.0, dt=dtype):
        return torch.from_numpy((gen.standard_normal(shape) * scale).astype(np.float32)).to(
            cuda, dt)

    args = (t((b, h, h, cin)), t((k, k, cin, cout), (k * k * cin) ** -0.5),
            t((cout,), 0.1, torch.float32))
    _build.reset_launches()
    got = conv.conv_s2_fused(*args, relu=True)
    assert _build.LAUNCHES["conv_s2_fused"] == 1
    _assert_conv_close(got, conv.conv_s2_fused_plain(*args, relu=True))


# (k, s, p, h, c, dtype): the stem pool of both models at batch 2, the JAX
# tests' windows, and a channel count off the 16-byte groups.
POOL_CASES = [
    (3, 2, 1, 112, 64, torch.bfloat16), (3, 2, 1, 112, 64, torch.int8),
    (2, 2, 0, 8, 24, torch.float32), (3, 1, 1, 7, 24, torch.bfloat16),
    (3, 3, 1, 9, 3, torch.int8), (3, 2, 1, 11, 5, torch.float32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("k,s,p,h,c,dtype", POOL_CASES)
def test_max_pool2d_kernel_equals_plain(cuda, gen, k, s, p, h, c, dtype):
    from resnetc_tpu_torch.ops.cuda import pool

    if dtype == torch.int8:
        x = torch.from_numpy(gen.integers(-128, 128, size=(2, h, h, c), dtype=np.int8)).to(cuda)
    else:
        x = torch.from_numpy(gen.standard_normal((2, h, h, c)).astype(np.float32)).to(cuda, dtype)
    _build.reset_launches()
    got = pool.max_pool2d(x, kernel_size=k, stride=s, padding=p)
    assert _build.LAUNCHES["max_pool2d"] == 1
    want = pool.max_pool2d_plain(x, kernel_size=k, stride=s, padding=p)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and torch.equal(got, want)


# A NaN in every channel of one input pixel (row) and -Inf in another: the
# kernels' relu and the float max pool keep NaN where the plain versions do
# (as jnp.maximum does); the other values keep their tolerances.
NAN_CASES = [("conv3x3_s1", torch.bfloat16), ("conv3x3_s1", torch.float32),
             ("conv_s2", torch.bfloat16), ("conv_s2", torch.float32),
             ("matmul", torch.bfloat16), ("matmul", torch.float32),
             ("max_pool2d", torch.bfloat16), ("max_pool2d", torch.float32),
             ("int8_matmul", torch.bfloat16), ("int8_matmul", torch.float32)]


def _poisoned(a: np.ndarray) -> np.ndarray:
    a = a.astype(np.float32)
    a.reshape(-1, a.shape[-1])[1] = np.nan
    a.reshape(-1, a.shape[-1])[-3] = -np.inf
    return a


@pytest.mark.cuda
@pytest.mark.parametrize("op,dtype", NAN_CASES, ids=[f"{o}-{str(d)[6:]}" for o, d in NAN_CASES])
def test_kernels_keep_nan_as_plain(cuda, gen, op, dtype):
    from resnetc_tpu_torch.ops.cuda import conv, pool, quant

    def t(shape, scale=1.0, dt=dtype):
        return torch.from_numpy((gen.standard_normal(shape) * scale).astype(np.float32)).to(
            cuda, dt)

    close = _assert_conv_close
    if op in ("conv3x3_s1", "conv_s2"):
        x = torch.from_numpy(_poisoned(gen.standard_normal((2, 14, 14, 64)))).to(cuda, dtype)
        args, kw = (x, t((3, 3, 64, 64), 24**-1), t((64,), 0.1, torch.float32)), {"relu": True}
        fn = getattr(conv, op + "_fused")
        plain = getattr(conv, op + "_fused_plain")
    elif op == "matmul":
        x = torch.from_numpy(_poisoned(gen.standard_normal((200, 256)))).to(cuda, dtype)
        args = (x, t((256, 128), 1 / 16), t((128,), 0.1, torch.float32))
        kw = {"relu": True, "out_dtype": dtype}
        fn, plain = gemm.matmul, gemm.matmul_plain
    elif op == "max_pool2d":
        x = torch.from_numpy(_poisoned(gen.standard_normal((2, 15, 15, 64)))).to(cuda, dtype)
        args, kw = (x,), {"kernel_size": 3, "stride": 2, "padding": 1}
        fn, plain = pool.max_pool2d, pool.max_pool2d_plain
        close = _assert_equal
    else:  # int8_matmul, a NaN in the residual
        x = torch.from_numpy(gen.integers(-127, 128, size=(200, 256), dtype=np.int8)).to(cuda)
        w = torch.from_numpy(gen.integers(-127, 128, size=(256, 128), dtype=np.int8)).to(cuda)
        r = torch.from_numpy(_poisoned(gen.standard_normal((200, 128)) * 4)).to(cuda, dtype)
        args = (x, w, torch.tensor(0.0371, device=cuda),
                t((128,), 1e-3, torch.float32).abs(), t((128,), 4.0, torch.float32), r)
        kw = {"relu": True, "out_dtype": dtype}
        fn, plain = quant.int8_matmul, quant.int8_matmul_plain
        close = _assert_equal
    _build.reset_launches()
    got = fn(*args, **kw)
    assert _build.LAUNCHES[op + ("_fused" if op.startswith("conv") else "")] == 1
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    nan, inf = torch.isnan(want), torch.isinf(want)
    assert bool(nan.any()) and torch.equal(torch.isnan(got), nan)
    assert torch.equal(torch.isinf(got), inf) and torch.equal(got[inf], want[inf])
    close(got[~(nan | inf)], want[~(nan | inf)])


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["int8", "pallas"])
@pytest.mark.parametrize("block_kind", ["bottleneck", "basic"])
def test_tiny_int8_and_pallas_engines_on_the_card_match_plain(cuda, backend, block_kind):
    import warnings

    from resnetc_tpu_torch.models import resnet
    from resnetc_tpu_torch.ops.cuda import fused
    from resnetc_tpu_torch.serve import InferenceEngine

    cfg = resnet.ResNetConfig("tiny", block_kind, (3, 2, 2, 2), num_classes=11, stem_width=16)
    variables = resnet.init(cfg, torch.Generator().manual_seed(0))
    x = torch.randn((2, 64, 64, 3), generator=torch.Generator().manual_seed(1))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the pallas backend's deprecation notice
        eng = InferenceEngine(cfg, variables, backend=backend)
    _build.reset_launches()
    got = eng.logits(x)
    counts = dict(_build.LAUNCHES)
    n3 = 9 * (2 if block_kind == "basic" else 1)
    n1 = 3 + (9 * 2 + 1 if block_kind == "bottleneck" else 0) + 1
    gemm_name = "int8_matmul" if backend == "int8" else "matmul"
    assert counts == {"max_pool2d": 1, "conv_s2_fused": 3, "conv3x3_s1_fused": n3 - 3,
                      gemm_name: n1}, counts
    forward = fused.fused_forward_int8 if backend == "int8" else fused.fused_forward
    want = forward(cfg, eng.folded, x.to(cuda), kernels=fused.PLAIN)
    torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2)
    assert torch.equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.cuda
def test_basic_ds_int8_off_route_on_the_card_matches_plain(cuda, monkeypatch):
    from resnetc_tpu_torch.models import resnet
    from resnetc_tpu_torch.ops.cuda import fused
    from resnetc_tpu_torch.serve import InferenceEngine

    monkeypatch.setattr(fused, "L1_PIXEL_PAIR", False)
    monkeypatch.setattr(fused, "BASIC_DS_INT8", False)
    cfg = resnet.ResNetConfig("tiny_basic", "basic", (3, 2, 2, 2), num_classes=11, stem_width=16)
    variables = resnet.init(cfg, torch.Generator().manual_seed(0))
    x = torch.randn((2, 64, 64, 3), generator=torch.Generator().manual_seed(1))
    eng = InferenceEngine(cfg, variables, backend="int8_chain", calib_batch=x)
    _build.reset_launches()
    got = eng.logits(x)
    counts = dict(_build.LAUNCHES)
    assert counts == {"basic_run_chained_int8": 1, "conv_s2_fused": 3, "conv3x3_s1_fused": 3,
                      "matmul": 4, "basic_block_chained_int8": 3}, counts
    want = fused.fused_forward_int8_chain(cfg, eng.folded, eng.chain_scales, x.to(cuda),
                                          kernels=fused.PLAIN)
    torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2)
    assert torch.equal(got.argmax(-1), want.argmax(-1))


# ---------------------------------------------------------------------------
# The pallas_block backend and the op library: the bf16 / fp32 bottleneck
# blocks, the average pool, relu / add / add_relu
# ---------------------------------------------------------------------------

FP_BLOCK_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}


def _rel_max(got, want):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def _fp_block_args(gen, dev, b, h, c, dtype):
    def t(shape, scale, dt=dtype):
        return torch.from_numpy((gen.standard_normal(shape) * scale).astype(np.float32)).to(
            dev, dt)

    c4 = 4 * c
    f32 = torch.float32
    return t((b, h, h, c4), 1.0), (
        t((c4, c), c4**-0.5), t((c,), 0.1, f32), t((3, 3, c, c), (9 * c) ** -0.5),
        t((c,), 0.1, f32), t((c, c4), c**-0.5), t((c4,), 0.1, f32),
    )


# (h, c, dtype): wp = w + 1 at h = 7, odd sizes, widths off the 64-wide tile.
FP_BLOCK_CASES = [(8, 16, torch.bfloat16), (7, 32, torch.bfloat16), (9, 16, torch.float32),
                  (14, 64, torch.bfloat16), (7, 64, torch.float32),
                  (14, 256, torch.bfloat16), (7, 512, torch.bfloat16), (28, 128, torch.bfloat16)]


@pytest.mark.cuda
@pytest.mark.parametrize("h,c,dtype", FP_BLOCK_CASES)
def test_bottleneck_block_chained_kernel_close_to_plain(cuda, gen, h, c, dtype):
    """Three chained blocks whose input ring holds NaN: the interiors stay
    finite and close to the plain versions', the output rings are zero."""
    x, ws = _fp_block_args(gen, cuda, 2, h, c, dtype)
    xr = block.pad_for_chain(x)
    ring = ~block.pad_for_chain(torch.ones_like(x[..., :1])).bool()[:, 0]
    xr[ring] = float("nan")
    _build.reset_launches()
    got, want = xr, xr
    for _ in range(3):
        got = block.bottleneck_block_chained(got, *ws, h=h, w_sp=h)
        want = block.bottleneck_block_chained_plain(want, *ws, h=h, w_sp=h)
    assert _build.LAUNCHES["bottleneck_block_chained"] == 3
    assert bool(torch.isfinite(got).all()) and not got[ring].any()
    assert _rel_max(got, want) <= FP_BLOCK_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("h,c,dtype", FP_BLOCK_CASES)
def test_bottleneck_block_fused_kernel_close_to_plain(cuda, gen, h, c, dtype):
    x, ws = _fp_block_args(gen, cuda, 2, h, c, dtype)
    _build.reset_launches()
    got = block.bottleneck_block_fused(x, *ws)
    assert _build.LAUNCHES["bottleneck_block_fused"] == 1
    assert _rel_max(got, block.bottleneck_block_fused_plain(x, *ws)) <= FP_BLOCK_TOL[dtype]
    # The same sums in the same order as the chained form between a pad and
    # an unpad.
    chained = block.bottleneck_block_chained(block.pad_for_chain(x), *ws, h=h, w_sp=h)
    assert torch.equal(block.unpad_from_chain(chained, 2, h, h), got)


# (b, k, s, p, h, c, dtype): ResNet-152's head pool at batch 2 and at the
# serving batch 32 (16-byte channel groups in fp32, 8-byte ones in bf16),
# the JAX tests' windows, padded windows of the row-split path (k >= 4), and
# channel counts off the 16-byte groups.
AVG_POOL_CASES = [(2, 7, 1, 0, 7, 2048, torch.float32), (2, 7, 1, 0, 7, 2048, torch.bfloat16),
                  (32, 7, 1, 0, 7, 2048, torch.float32), (32, 7, 1, 0, 7, 2048, torch.bfloat16),
                  (2, 3, 2, 1, 16, 24, torch.bfloat16), (2, 2, 2, 0, 8, 24, torch.float32),
                  (2, 3, 2, 1, 11, 5, torch.float32), (2, 5, 1, 2, 9, 24, torch.bfloat16),
                  (2, 4, 2, 1, 11, 5, torch.float32), (3, 7, 1, 0, 7, 13, torch.bfloat16)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,k,s,p,h,c,dtype", AVG_POOL_CASES)
def test_avg_pool2d_kernel_equals_plain(cuda, gen, b, k, s, p, h, c, dtype):
    from resnetc_tpu_torch.ops.cuda import pool

    x = torch.from_numpy(gen.standard_normal((b, h, h, c)).astype(np.float32)).to(cuda, dtype)
    _build.reset_launches()
    got = pool.avg_pool2d(x, kernel_size=k, stride=s, padding=p)
    assert _build.LAUNCHES["avg_pool2d"] == 1
    want = pool.avg_pool2d_plain(x, kernel_size=k, stride=s, padding=p)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 17, 50), (2, 56, 56, 256)], ids=["odd", "r152-l1"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("op", ["relu", "add", "add_relu"])
def test_elementwise_kernels_equal_plain(cuda, gen, op, dtype, shape):
    from resnetc_tpu_torch.ops.cuda import elementwise

    a, b = (torch.from_numpy(gen.standard_normal(shape).astype(np.float32)) for _ in range(2))
    a.view(-1)[:3] = float("nan")
    b.view(-1)[7] = float("nan")
    a.view(-1)[11], b.view(-1)[11] = float("inf"), float("-inf")
    a, b = a.to(cuda, dtype), b.to(cuda, dtype)
    args = (a,) if op == "relu" else (a, b)
    _build.reset_launches()
    got = getattr(elementwise, op)(*args)
    assert _build.LAUNCHES[op] == 1
    want = getattr(elementwise, op + "_plain")(*args)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and bool(torch.isnan(want).any())
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


def _ew_operand(gen, shape, off, dev, dtype):
    """A view ``off`` elements into its buffer, holding one value in 32 each
    of NaN, +Inf, -Inf, -0 and +0."""
    n = int(np.prod(shape))
    x = gen.standard_normal(n + off).astype(np.float32)
    where = gen.integers(0, 32, n + off)
    for code, v in enumerate((np.nan, np.inf, -np.inf, -0.0, 0.0)):
        x[where == code] = v
    return torch.from_numpy(x).to(dev, dtype)[off:].view(shape)


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


# (shape, offset of a in elements, offset of b): ragged sizes off the
# 16-byte grid (the vector body between a scalar head and tail), views one
# and three elements into their buffers, fewer values than one vector, a
# pair at different offsets (the scalar kernel), ResNet-152's layer1 join at
# the serving batch.
EW_CASES = {"ragged": ((7, 37, 41, 67), 0, 0), "ragged-1": ((1001,), 0, 0),
            "offset-1": ((5, 33, 129), 1, 1), "offset-3": ((3, 1, 4097), 3, 3),
            "tiny": ((5,), 1, 1), "mixed-offsets": ((2, 999), 1, 2),
            "r152-l1-b32": ((32, 56, 56, 256), 0, 0)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", list(EW_CASES))
def test_elementwise_kernels_bit_equal_plain(cuda, gen, case, dtype):
    """relu / add / add_relu equal their plain versions bit for bit (NaN and
    the sign of a zero included) at any size and offset, one launch each;
    add_relu is relu(add)."""
    from resnetc_tpu_torch.ops.cuda import elementwise

    shape, off_a, off_b = EW_CASES[case]
    a = _ew_operand(gen, shape, off_a, cuda, dtype)
    b = _ew_operand(gen, shape, off_b, cuda, dtype)
    for op, args in (("relu", (a,)), ("add", (a, b)), ("add_relu", (a, b))):
        _build.reset_launches()
        got = getattr(elementwise, op)(*args)
        assert dict(_build.LAUNCHES) == {op: 1}, op
        want = getattr(elementwise, op + "_plain")(*args)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and got.shape == want.shape == a.shape, op
        assert torch.equal(_bits(got), _bits(want)), op
    joined = elementwise.add_relu(a, b)
    assert torch.equal(_bits(joined), _bits(elementwise.relu(elementwise.add(a, b))))
    assert bool(torch.isnan(joined).any()) or a.numel() < 64
    relu = elementwise.relu(a)
    assert not bool(torch.signbit(relu[relu == 0]).any())  # +0 for a zero of either sign


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["bf16", "fp32"])
def test_tiny_pallas_block_engine_on_the_card_matches_plain(cuda, policy):
    import warnings

    from resnetc_tpu_torch.models import resnet
    from resnetc_tpu_torch.ops.cuda import fused
    from resnetc_tpu_torch.serve import InferenceEngine
    from resnetc_tpu_torch.tensor import BF16, FP32

    pol = {"bf16": BF16, "fp32": FP32}[policy]
    cfg = resnet.ResNetConfig("tiny", "bottleneck", (3, 2, 2, 2), num_classes=11, stem_width=16)
    variables = resnet.init(cfg, torch.Generator().manual_seed(0))
    x = torch.randn((2, 64, 64, 3), generator=torch.Generator().manual_seed(1))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the deprecation notice
        eng = InferenceEngine(cfg, variables, backend="pallas_block", policy=pol)
    _build.reset_launches()
    got = eng.logits(x)
    counts = dict(_build.LAUNCHES)
    assert counts == {"max_pool2d": 1, "conv3x3_s1_fused": 1, "conv_s2_fused": 3, "matmul": 13,
                      "bottleneck_block_chained": 5}, counts
    want = fused.fused_forward(cfg, eng.folded, x.to(cuda), policy=pol, block_fusion=True,
                               kernels=fused.PLAIN)
    torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2)
    assert torch.equal(got.argmax(-1), want.argmax(-1))
