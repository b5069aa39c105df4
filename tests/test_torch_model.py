"""The port's model and checkpoint code vs the JAX package's.

A tiny bottleneck config (3,2,2,2 blocks, stem width 16, 11 classes),
64x64, batch 2; the JAX package's parameters are carried into the port with
``variables_from_jax_numpy``.  Tolerances: BN folding 1e-6 (rsqrt may
differ in the last bit); the fp32 folded forward atol 1e-4 (convolutions
sum in another order over 27 layers); checkpoint files byte-identical.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from resnetc_tpu import checkpoint as jckpt
from resnetc_tpu.models import resnet as jresnet
from resnetc_tpu.tensor import FP32 as JFP32
from resnetc_tpu_torch import checkpoint as tckpt
from resnetc_tpu_torch.models import resnet as tresnet
from resnetc_tpu_torch.tensor import BF16, FP32, flatten_tree

TINY = dict(name="tiny", block="bottleneck", stage_blocks=(3, 2, 2, 2), num_classes=11,
            stem_width=16)


@pytest.fixture(scope="module")
def trees():
    jcfg = jresnet.ResNetConfig(**TINY)
    tcfg = tresnet.ResNetConfig(**TINY)
    jvars = jresnet.init(jcfg, jax.random.key(5))
    tvars = tckpt.variables_from_jax_numpy(jax.tree.map(np.asarray, jvars))
    return jcfg, tcfg, jvars, tvars


def test_configs_and_shapes_match_jax():
    for name, jcfg in jresnet.RESNET_CONFIGS.items():
        tcfg = tresnet.get_config(name, num_classes=jcfg.num_classes)
        assert tcfg.stage_blocks == jcfg.stage_blocks and tcfg.feature_dim == jcfg.feature_dim
        assert [tcfg.stage_channels(s) for s in range(4)] == [
            jcfg.stage_channels(s) for s in range(4)
        ]
    for name in ("resnet50", "resnext50_32x4d"):
        assert tresnet.param_shapes(tresnet.get_config(name)) == jckpt.param_shapes(
            jresnet.get_config(name)
        )
    with pytest.raises(ValueError):
        tresnet.get_config("resnet9")


def test_init_is_seeded_and_shaped_like_torchvision():
    cfg = tresnet.ResNetConfig(**TINY)
    a = tresnet.init(cfg, torch.Generator().manual_seed(0))
    b = tresnet.init(cfg, torch.Generator().manual_seed(0))
    fa, fb = flatten_tree(a), flatten_tree(b)
    assert {k: tuple(v.shape) for k, v in fa.items()} == tresnet.param_shapes(cfg)
    assert all(torch.equal(fa[k], fb[k]) for k in fa)
    w = fa["layer1.0.conv2.weight"]  # kaiming normal, fan_out = 3*3*16
    assert abs(float(w.std()) - (2.0 / (9 * 16)) ** 0.5) < 0.02
    assert float(fa["fc.weight"].abs().max()) <= 1.0 / cfg.feature_dim**0.5
    assert torch.equal(fa["bn1.running_var"], torch.ones(16))


def test_fold_and_forward_folded_match_jax_fp32(trees, rng):
    jcfg, tcfg, jvars, tvars = trees
    jfold = jresnet.fold_inference_params(jcfg, jvars)
    tfold = tresnet.fold_inference_params(tcfg, tvars)
    jflat, tflat = jckpt.flatten_tree(jfold), flatten_tree(tfold)
    assert set(jflat) == set(tflat)
    for k in jflat:
        np.testing.assert_allclose(tflat[k].numpy(), np.asarray(jflat[k]), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jresnet.forward_folded(jcfg, jfold, jnp.asarray(x), policy=JFP32))
    got = tresnet.forward_folded(tcfg, tfold, torch.from_numpy(x), policy=FP32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    # bf16 compute: same argmax, logits within a few bf16 steps.
    got16 = tresnet.forward_folded(tcfg, tfold, torch.from_numpy(x), policy=BF16).numpy()
    assert np.abs(got16 - want).max() <= 0.05 * np.abs(want).max()


def test_reference_format_round_trip_is_byte_identical(trees, tmp_path):
    jcfg, tcfg, jvars, tvars = trees
    n_j = jckpt.save_reference_format(jvars, tmp_path / "jax")
    n_t = tckpt.save_reference_format(tvars, tmp_path / "torch")
    assert n_j == n_t == len(tresnet.param_shapes(tcfg))
    for f in (tmp_path / "jax").iterdir():
        assert (tmp_path / "torch" / f.name).read_bytes() == f.read_bytes(), f.name
    back = flatten_tree(tckpt.load_reference_format(tcfg, tmp_path / "jax"))
    for k, v in jckpt.flatten_tree(jvars).items():
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(v), err_msg=k)
    (tmp_path / "jax" / "fc.bias").write_bytes(b"\0" * 8)
    with pytest.raises(ValueError):
        tckpt.load_reference_format(tcfg, tmp_path / "jax")


def test_state_dict_import_matches_jax(trees):
    jcfg, tcfg, jvars, tvars = trees
    sd = jckpt.torch_state_dict_from_variables(jvars)
    sd["bn1.num_batches_tracked"] = torch.tensor(3)
    got = flatten_tree(tckpt.variables_from_torch_state_dict(sd))
    want = jckpt.flatten_tree(jckpt.variables_from_torch_state_dict(sd))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
