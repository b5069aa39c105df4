"""Serving from files: the port's preprocessing, ``.bin`` inputs, torch
checkpoint files and ``classify_files`` vs the JAX package's.

Every input is made here: images with PIL from seeded uint8 numpy arrays
(portrait, landscape, grayscale and RGBA, in odd sizes), ``.bin`` files
from seeded normal arrays, ``.pth`` files with ``torch.save``, weight
directories with ``save_reference_format``.  Preprocessing is numpy + PIL in
both packages, so arrays are held EQUAL, and files byte for byte.  The
engines: a tiny bottleneck config (3,2,2,2 blocks, stem width 16, 11
classes) on the CPU, inputs cropped to 64 px; the ``fp`` engine's indices
are the JAX ``xla`` engine's under FP32 (their logits agree to 1e-4), the
``int8_chain`` engine's are its own ``classify`` of the same arrays.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from resnetc_tpu import checkpoint as jckpt
from resnetc_tpu import serve as jserve
from resnetc_tpu.data import preprocess as jpre
from resnetc_tpu.models import resnet as jresnet
from resnetc_tpu.tensor import FP32 as JFP32
from resnetc_tpu_torch import checkpoint as tckpt
from resnetc_tpu_torch import serve as tserve
from resnetc_tpu_torch.data import preprocess as tpre
from resnetc_tpu_torch.models import resnet as tresnet
from resnetc_tpu_torch.tensor import FP32, flatten_tree

TINY = dict(name="tiny", block="bottleneck", stage_blocks=(3, 2, 2, 2), num_classes=11,
            stem_width=16)
#: (mode, numpy shape): height x width (x channels).
IMAGES = {"portrait": ("RGB", (300, 241, 3)), "landscape": ("RGB", (180, 311, 3)),
          "gray": ("L", (257, 263)), "rgba": ("RGBA", (240, 230, 4))}


def _image(kind: str, seed: int = 0) -> Image.Image:
    mode, shape = IMAGES[kind]
    arr = np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)
    return Image.fromarray(arr, mode)


@pytest.fixture(scope="module")
def net():
    jcfg, tcfg = jresnet.ResNetConfig(**TINY), tresnet.ResNetConfig(**TINY)
    jvars = jresnet.init(jcfg, jax.random.key(7))
    tvars = tckpt.variables_from_jax_numpy(jax.tree.map(np.asarray, jvars))
    return jcfg, tcfg, jvars, tvars


def _equal_trees(got: dict, want: dict) -> None:
    got, want = flatten_tree(got), flatten_tree(want)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
@pytest.mark.parametrize("kind", list(IMAGES))
def test_preprocess_image_matches_jax(kind, layout):
    img = _image(kind)
    got = tpre.preprocess_image(img, layout=layout)
    want = jpre.preprocess_image(img, layout=layout)
    assert got.dtype == np.float32
    assert got.shape == ((1, 224, 224, 3) if layout == "NHWC" else (1, 3, 224, 224))
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="layout"):
        tpre.preprocess_image(img, layout="HWC")


def test_preprocess_files_match_jax(tmp_path):
    paths = []
    for i, (kind, ext) in enumerate((("portrait", "png"), ("landscape", "jpg"),
                                     ("gray", "png"), ("rgba", "png"))):
        path = tmp_path / f"{i}_{kind}.{ext}"
        _image(kind, seed=i).save(path)
        paths.append(str(path))
        for kw in ({}, {"resize": 80, "crop": 64, "layout": "NCHW"}):
            np.testing.assert_array_equal(tpre.preprocess_file(path, **kw),
                                          jpre.preprocess_file(path, **kw))
    pngs = [p for p in paths if p.endswith(".png")]  # the JAX batch takes PIL for these
    got = tpre.preprocess_files_batch(pngs, resize=80, crop=64)
    assert got.shape == (3, 64, 64, 3)
    np.testing.assert_array_equal(got, jpre.preprocess_files_batch(pngs, resize=80, crop=64))
    # A JPEG batch: the port decodes every file with PIL.
    got = tpre.preprocess_files_batch(paths[:2], resize=80, crop=64)
    np.testing.assert_array_equal(got, np.concatenate(
        [jpre.preprocess_file(p, resize=80, crop=64) for p in paths[:2]]))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_bin_files_read_across_packages(tmp_path, writer):
    x = np.random.default_rng(5).standard_normal((2, 24, 40, 3)).astype(np.float32)
    write, read = (tpre, jpre) if writer == "port" else (jpre, tpre)
    write.save_input_bin(x, tmp_path / "a.bin")
    (tpre if writer == "jax" else jpre).save_input_bin(x, tmp_path / "b.bin")
    assert (tmp_path / "a.bin").read_bytes() == (tmp_path / "b.bin").read_bytes()
    assert (tmp_path / "a.bin").stat().st_size == x.size * 4
    got = read.load_input_bin(tmp_path / "a.bin", batch=2, height=24, width=40)
    np.testing.assert_array_equal(got, x)
    nchw = read.load_input_bin(tmp_path / "a.bin", batch=2, height=24, width=40, layout="NCHW")
    np.testing.assert_array_equal(nchw, x.transpose(0, 3, 1, 2))
    # An NCHW array is written as it is.
    write.save_input_bin(x.transpose(0, 3, 1, 2), tmp_path / "c.bin")
    assert (tmp_path / "c.bin").read_bytes() == (tmp_path / "a.bin").read_bytes()


def test_load_input_bin_checks_the_size(tmp_path):
    tpre.save_input_bin(np.zeros((1, 3, 8, 8), np.float32), tmp_path / "x.bin")
    with pytest.raises(ValueError, match="192 elems, expected 150528"):
        tpre.load_input_bin(tmp_path / "x.bin")
    with pytest.raises(ValueError, match="expected 384"):
        tpre.load_input_bin(tmp_path / "x.bin", batch=2, height=8, width=8)
    assert tpre.load_input_bin(tmp_path / "x.bin", height=8, width=8).shape == (1, 8, 8, 3)


def test_torch_state_dict_from_variables_matches_jax(net):
    _, _, jvars, tvars = net
    got = tckpt.torch_state_dict_from_variables(tvars)
    want = jckpt.torch_state_dict_from_variables(jvars)
    assert set(got) == set(want)
    for k, t in got.items():
        assert t.dtype == torch.float32 and t.is_contiguous(), k
        assert torch.equal(t, want[k]), k
    assert got["conv1.weight"].shape == (16, 3, 7, 7)  # OIHW
    _equal_trees(tckpt.variables_from_torch_state_dict(got), tvars)


@pytest.mark.parametrize("wrap", ["raw", "state_dict", "model"])
def test_variables_from_torch_file_matches_jax(net, tmp_path, wrap):
    _, _, jvars, tvars = net
    sd = tckpt.torch_state_dict_from_variables(tvars)
    sd["bn1.num_batches_tracked"] = torch.tensor(5)  # torchvision's bookkeeping, ignored
    obj = sd if wrap == "raw" else {wrap: sd, "epoch": 3}
    torch.save(obj, tmp_path / "w.pth")
    got = tckpt.variables_from_torch_file(tmp_path / "w.pth")
    _equal_trees(got, jax.tree.map(np.asarray, jckpt.variables_from_torch_file(tmp_path / "w.pth")))
    _equal_trees(got, tvars)


@pytest.mark.parametrize("obj", [{"epoch": 3, "lr": 0.1}, [torch.zeros(2)],
                                 {"state_dict": {"w": torch.zeros(2), "step": 4}}],
                         ids=["no-tensors", "a-list", "mixed"])
def test_variables_from_torch_file_rejects_a_bad_file(tmp_path, obj):
    path = tmp_path / "bad.pth"
    torch.save(obj, path)
    with pytest.raises(ValueError) as jerr:
        jckpt.variables_from_torch_file(path)
    with pytest.raises(ValueError, match="no tensor state_dict found") as terr:
        tckpt.variables_from_torch_file(path)
    assert str(terr.value) == str(jerr.value)


def _inputs(tmp_path, size: int) -> list[str]:
    """Two .bin files, a PNG and a JPEG."""
    paths = []
    for i in range(2):
        x = np.random.default_rng(10 + i).standard_normal((1, size, size, 3)).astype(np.float32)
        tpre.save_input_bin(x, tmp_path / f"x{i}.bin")
        paths.append(str(tmp_path / f"x{i}.bin"))
    _image("landscape", seed=2).save(tmp_path / "a.png")
    _image("portrait", seed=3).save(tmp_path / "b.jpeg")
    return paths[:1] + [str(tmp_path / "a.png"), paths[1], str(tmp_path / "b.jpeg")]


def test_classify_files_on_mixed_inputs(net, tmp_path):
    jcfg, tcfg, jvars, tvars = net
    paths = _inputs(tmp_path, 64)
    fp = tserve.InferenceEngine(tcfg, tvars, policy=FP32, backend="fp", device="cpu")
    jfp = jserve.InferenceEngine(jcfg, jvars, policy=JFP32, backend="xla")
    got = tserve.classify_files(fp, paths, image_size=64)
    assert len(got) == 4 and all(type(i) is int for i in got)
    assert got == [int(i) for i in jserve.classify_files(jfp, paths, image_size=64)]

    arrays = np.concatenate([
        tpre.load_input_bin(p, height=64, width=64) if p.endswith(".bin")
        else tpre.preprocess_file(p, crop=64) for p in paths])
    np.testing.assert_allclose(fp.logits(arrays).numpy(),
                               np.asarray(jfp.logits(jnp.asarray(arrays))), rtol=1e-4, atol=1e-4)
    eng = tserve.InferenceEngine(tcfg, tvars, policy=FP32, backend="int8_chain",
                                 calib_batch=arrays, device="cpu")
    assert tserve.classify_files(eng, paths, image_size=64) == list(eng.classify(arrays))


def test_reference_job_from_a_weights_directory(net, tmp_path):
    """A reference weights directory and a torchvision-layout .pth give the
    tree they were written from, and a .bin in gives the index out."""
    _, tcfg, _, tvars = net
    n = tckpt.save_reference_format(tvars, tmp_path / "weights")
    assert n == len(flatten_tree(tvars))
    loaded = tckpt.load_reference_format(tcfg, tmp_path / "weights")
    _equal_trees(loaded, tvars)
    torch.save(tckpt.torch_state_dict_from_variables(loaded), tmp_path / "w.pth")
    _equal_trees(tckpt.variables_from_torch_file(tmp_path / "w.pth"), tvars)

    paths = _inputs(tmp_path, 64)
    want = tserve.InferenceEngine(tcfg, tvars, backend="fp", policy=FP32, device="cpu")
    got = tserve.InferenceEngine(tcfg, loaded, backend="fp", policy=FP32, device="cpu")
    assert tserve.classify_files(got, paths, image_size=64) == \
        tserve.classify_files(want, paths, image_size=64)
