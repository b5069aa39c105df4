"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one (the kernels have
no CPU mode).  The file imports neither JAX nor the JAX package, so it also
runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Inputs come from a seeded numpy generator.  Tolerances: int8 and bf16
outputs EQUAL (exact integer dots, fp32 epilogues in the same order of
operations and roundings); the fp32 per-image means and the
fp32-accumulating GEMM sum in another order: rtol 1e-5 and 1e-5 / 1e-4.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

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
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture()
def gen() -> np.random.Generator:
    return np.random.default_rng(4321)


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
    for emit_i8 in (True, False):
        got = block.bottleneck_run_chained_int8(*args, emit_i8=emit_i8, **kw)
        want = block.bottleneck_run_chained_int8_plain(*args, emit_i8=emit_i8, **kw)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and torch.equal(got, want)


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


@pytest.mark.cuda
@pytest.mark.parametrize("h,c", [(8, 16), (7, 32), (14, 64)])
def test_basic_block_kernel_equals_plain(cuda, gen, h, c):
    b = 2
    q = _basic_quantized(gen, c, c, cuda)
    args = (_chain(gen, b, h, c, cuda), *(q[k] for k in BASIC_KEYS),
            torch.from_numpy(BASIC_SCALES).to(cuda))
    for emit_i8 in (True, False):
        _build.reset_launches()
        got = block.basic_block_chained_int8(*args, h=h, w_sp=h, emit_i8=emit_i8)
        assert _build.LAUNCHES["basic_block_chained_int8"] == 1
        want = block.basic_block_chained_int8_plain(*args, h=h, w_sp=h, emit_i8=emit_i8)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n_blocks", [2, 3])
def test_basic_run_kernel_equals_plain(cuda, gen, n_blocks):
    b, h, c = 2, 8, 16
    qs = [_basic_quantized(gen, c, c, cuda) for _ in range(n_blocks)]
    scales = torch.from_numpy(np.stack([BASIC_SCALES] * n_blocks)).to(cuda)
    args = (_chain(gen, b, h, c, cuda), *(torch.stack([q[k] for q in qs]) for k in BASIC_KEYS),
            scales)
    for emit_i8 in (True, False):
        got = block.basic_run_chained_int8(*args, h=h, w_sp=h, emit_i8=emit_i8)
        want = block.basic_run_chained_int8_plain(*args, h=h, w_sp=h, emit_i8=emit_i8)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(10, 10), (7, 7), (10, 14), (14, 14)])
def test_basic_ds_kernel_equals_plain(cuda, gen, h, w):
    b, cin, c = 2, 16, 32
    q = _basic_quantized(gen, cin, c, cuda, ds=True)
    hp, wp = block.chain_meta(b, h, w)
    x = torch.from_numpy(
        gen.integers(-127, 128, size=(b * hp * wp, cin), dtype=np.int8)
    ).to(cuda)
    args = (x, *(q[k] for k in BASIC_DS_KEYS), torch.from_numpy(BASIC_SCALES).to(cuda))
    for emit_i8 in (True, False):
        got = block.basic_ds_block_s2_int8(*args, h=h, w_sp=w, emit_i8=emit_i8)
        want = block.basic_ds_block_s2_int8_plain(*args, h=h, w_sp=w, emit_i8=emit_i8)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and torch.equal(got, want)


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
def test_tiny_engine_on_the_card_matches_plain(cuda):
    from resnetc_tpu_torch.models import resnet
    from resnetc_tpu_torch.ops.cuda.fused import PLAIN, fused_forward_int8_chain
    from resnetc_tpu_torch.serve import InferenceEngine

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


@pytest.mark.cuda
def test_tiny_basic_engine_on_the_card_matches_plain(cuda):
    from resnetc_tpu_torch.models import resnet
    from resnetc_tpu_torch.ops.cuda.fused import PLAIN, fused_forward_int8_chain
    from resnetc_tpu_torch.serve import InferenceEngine

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
