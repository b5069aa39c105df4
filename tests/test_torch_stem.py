"""The ``int8_chain`` stem's tail, ``pool.stem_pool_int8``, on the CPU.

Its plain version must be the composition the stem ran before the kernel
(``fused._xla_conv``'s bias and relu, ``quantize_with_scale``,
``torch_ops.max_pool2d``, ``block.pad_for_chain``) bit for bit; and the
kernel's own order of operations (the window's max of the raw inputs first,
then bias, rounding, relu and the quantizer once, which is exact because
every step is monotone), written out here in plain PyTorch, must give the
same bits, on values built to find a fault: negatives, exact .5 ties of
v / s, values beyond +-127 s, whole windows below zero, odd sizes.  End to
end, the CPU ``int8_chain`` forwards of a ResNet-18 and a ResNet-50 give
the same logits through the new stem as through the parent's composition.
The kernel itself runs on the card only (``tests/test_torch_cuda.py``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from resnetc_tpu_torch.models import resnet as tresnet
from resnetc_tpu_torch.ops import torch_ops
from resnetc_tpu_torch.ops.cuda import block, fused, pool
from resnetc_tpu_torch.ops.cuda.quant import quantize_with_scale
from resnetc_tpu_torch.serve import InferenceEngine
from resnetc_tpu_torch.tensor import BF16, FP32

SHAPES = [(2, 112, 112, 64), (1, 7, 9, 64), (3, 15, 15, 128)]
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
#: 0.5 makes many v / s land on exact .5 ties; 0.0371 rounds in the divide.
SCALES = [0.5, 0.0371]


def _stem_values(shape, dtype, seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """y and bias: most values on a 0.25 grid in [-40, 40] (with a 0.25-grid
    bias, v + b over s = 0.5 falls on .5 ties), a share far beyond 127 s of
    either sign, and in each image a block whose windows are all negative."""
    rng = np.random.default_rng(seed)
    b, h, w, c = shape
    y = rng.integers(-160, 161, size=shape).astype(np.float32) * 0.25
    far = rng.random(shape) < 0.05
    y[far] = rng.choice([-1e4, -300.0, 100.0, 300.0, 1e4], size=int(far.sum()))
    below = (slice(None), slice(h // 3, h // 3 + 4), slice(w // 3, w // 3 + 4))
    y[below] = -rng.random(y[below].shape) - 0.25
    bias = rng.integers(-2, 3, size=c).astype(np.float32) * 0.25
    bias[::7] += np.float32(0.01)  # off the grid: rounds to bf16 in the add
    return torch.from_numpy(y).to(dtype), torch.from_numpy(bias)


def _parent_tail(y, bias, s_in):
    """What the stem did after its convolution before the kernel."""
    y = torch_ops.relu(y + bias.to(y.dtype))
    yq = torch_ops.max_pool2d(quantize_with_scale(y, s_in), kernel_size=3, stride=2, padding=1)
    return block.pad_for_chain(yq)


def _kernel_order(y, bias, s_in):
    """The kernel's order of operations: the max of the raw inputs over each
    in-image 3x3/2 window, then bias (rounded to y's type), the add rounded
    to y's type, relu, the divide, round half to even, clamp, once per
    output; then the zero ring."""
    b, h, w, c = y.shape
    yp = F.pad(y.float(), (0, 0, 1, 1, 1, 1), value=float("-inf"))
    oh, ow = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    m = torch.stack([yp[:, u : u + 2 * oh - 1 : 2, v : v + 2 * ow - 1 : 2]
                     for u in range(3) for v in range(3)]).amax(0)
    t = (m.to(y.dtype).float() + bias.to(y.dtype).float()).to(y.dtype).float()
    q = torch.clamp(torch.round(torch.relu(t) / s_in), -127, 127).to(torch.int8)
    hp, wp = block.chain_meta(b, oh, ow)
    out = torch.zeros((b, hp, wp, c), dtype=torch.int8)
    out[:, 1 : 1 + oh, 1 : 1 + ow] = q
    return out.reshape(b * hp * wp, c)


@pytest.mark.parametrize("s", SCALES)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=["x".join(map(str, s)) for s in SHAPES])
def test_plain_is_the_parent_composition_and_the_kernel_order(shape, dtype, s):
    y, bias = _stem_values(shape, DTYPES[dtype], seed=sum(shape))
    s_in = torch.tensor(s, dtype=torch.float32)
    got = pool.stem_pool_int8_plain(y, bias, s_in)
    want = _parent_tail(y, bias, s_in)
    assert got.dtype == torch.int8 and got.shape == want.shape
    assert torch.equal(got, want)
    assert torch.equal(_kernel_order(y, bias, s_in), want)
    # The values reach what they were built for: both clamps' neighbourhood,
    # zeros from relu, and (at s = 0.5) ties the rounding has to break.
    q = want.float()
    assert (q == 127).any() and (q == 0).any()
    if s == 0.5:
        t = (y.float() + bias.to(y.dtype).float()).to(y.dtype).float() / s
        assert ((t - t.floor()) == 0.5).any()


@pytest.mark.parametrize("shape", SHAPES, ids=["x".join(map(str, s)) for s in SHAPES])
def test_the_op_on_the_cpu_is_the_plain_version(shape):
    """The wrapper on CPU tensors calls ``resnetc::stem_pool_int8``, whose
    CPU implementation is the plain version; its fake gives the shape."""
    y, bias = _stem_values(shape, torch.bfloat16, seed=3)
    s_in = torch.tensor(0.0371, dtype=torch.float32)
    got = pool.stem_pool_int8(y, bias, s_in)
    assert torch.equal(got, pool.stem_pool_int8_plain(y, bias, s_in))
    h, w_sp, hp, wp = pool.stem_pool_geometry(y)
    assert (h, w_sp) == ((shape[1] - 1) // 2 + 1, (shape[2] - 1) // 2 + 1)
    assert got.shape == (shape[0] * hp * wp, shape[3])


@pytest.mark.parametrize("case", ["int8", "fp16", "c24", "strided", "bias_shape", "bias_bf16",
                                  "scale_shape"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    y = torch.zeros((2, 9, 9, 32), dtype=torch.bfloat16)
    bias, s_in = torch.zeros(32), torch.tensor(0.5)
    if case == "int8":
        y = y.to(torch.int8)
    elif case == "fp16":
        y = y.half()
    elif case == "c24":
        y, bias = torch.zeros((2, 9, 9, 24), dtype=torch.bfloat16), torch.zeros(24)
    elif case == "strided":
        y = torch.zeros((2, 9, 32, 9), dtype=torch.bfloat16).transpose(2, 3)
    elif case == "bias_shape":
        bias = torch.zeros(16)
    elif case == "bias_bf16":
        bias = bias.to(torch.bfloat16)
    else:
        s_in = torch.tensor([0.5])
    with pytest.raises(ValueError):
        pool.stem_pool_int8(y, bias, s_in)


def test_plain_kernels_hold_the_plain_stem():
    assert fused.PLAIN.stem_pool is pool.stem_pool_int8_plain
    assert fused.KERNELS.stem_pool is pool.stem_pool_int8


def _parent_stem_chain(qtree, x, s_in, policy, kernels):
    """The parent's ``fused._stem_chain``: the biased, relu'd stock
    convolution, then quantize, the int8 pool through fp32, the pad."""
    x = x.to(policy.compute)
    y = fused._xla_conv(x, qtree["conv1"], stride=2, relu=True, policy=policy)
    yq = quantize_with_scale(y, s_in)
    yq = torch_ops.max_pool2d(yq, kernel_size=3, stride=2, padding=1)
    bsz, h, w_sp, _ = yq.shape
    return block.pad_for_chain(yq), bsz, h, w_sp


@pytest.mark.parametrize("policy", ["bf16", "fp32"])
@pytest.mark.parametrize("model", ["resnet18", "resnet50"])
def test_int8_chain_logits_equal_the_parent_stem(model, policy, monkeypatch):
    cfg = tresnet.get_config(model, num_classes=10)
    variables = tresnet.init(cfg, torch.Generator().manual_seed(4))
    x = torch.from_numpy(
        np.random.default_rng(5).standard_normal((2, 64, 64, 3)).astype(np.float32))
    pol = BF16 if policy == "bf16" else FP32
    eng = InferenceEngine(cfg, variables, policy=pol, backend="int8_chain", calib_batch=x,
                          device="cpu")
    calls = []
    stem_pool = fused.KERNELS.stem_pool

    def counted(*args):
        calls.append(args[0].shape)
        return stem_pool(*args)

    kernels = fused.KERNELS._replace(stem_pool=counted)
    got = fused.fused_forward_int8_chain(cfg, eng.folded, eng.chain_scales, x, policy=pol,
                                         kernels=kernels)
    assert calls == [(2, 32, 32, 64)]
    monkeypatch.setattr(fused, "_stem_chain", _parent_stem_chain)
    want = fused.fused_forward_int8_chain(cfg, eng.folded, eng.chain_scales, x, policy=pol)
    assert torch.equal(got, want)
