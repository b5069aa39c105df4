"""The port's native host helpers (``resnetc_tpu_torch/native``) vs the JAX
package's library, and the paths that use them.

Every input is made here: JPEGs and PNGs written with PIL from seeded uint8
numpy arrays (odd sizes, portrait and landscape, a grayscale JPEG, one
image smaller than the resize), raw-f32 files from seeded normal arrays,
weight directories with the JAX package's ``save_reference_format``.  The
two libraries are built from the same sources with the same flags, so the
ingest is held EQUAL to the JAX library's, bit for bit; against PIL within
one uint8 level per channel and exact on more than 90% of the values
(``tests/test_native.py:56-70``).  The weight reader equals ``np.fromfile``
bit for bit, and ``load_reference_format`` gives JAX's tree bit for bit on
both of its read paths.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from PIL import Image

from resnetc_tpu import checkpoint as jckpt
from resnetc_tpu import native as jnative
from resnetc_tpu.data import preprocess as jpre
from resnetc_tpu.models import resnet as jresnet
from resnetc_tpu_torch import checkpoint as tckpt
from resnetc_tpu_torch import native
from resnetc_tpu_torch.data import preprocess as tpre
from resnetc_tpu_torch.models import resnet as tresnet
from resnetc_tpu_torch.tensor import flatten_tree

#: (mode, numpy shape, JPEG quality) of the test JPEGs.
JPEGS = {"portrait": ("RGB", (301, 247, 3), 90), "landscape": ("RGB", (190, 333, 3), 75),
         "gray": ("L", (260, 255), 95), "small": ("RGB", (97, 120, 3), 85)}
#: (resize, crop) of each JPEG's check: the reference's, and a small one.
SIZES = {"portrait": (232, 224), "landscape": (232, 224), "gray": (73, 64), "small": (73, 64)}


def _write_jpeg(path, kind: str, seed: int = 0) -> str:
    mode, shape, quality = JPEGS[kind]
    arr = np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)
    # Smooth the noise a little so the JPEG holds real structure.
    arr = ((arr.astype(np.uint16) + np.roll(arr, 1, axis=0)) // 2).astype(np.uint8)
    Image.fromarray(arr, mode).save(path, quality=quality)
    return str(path)


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    d = tmp_path_factory.mktemp("jpegs")
    return {kind: _write_jpeg(d / f"{kind}.jpeg", kind, seed=i)
            for i, kind in enumerate(JPEGS)}


def _ingest(lib, paths, resize, crop, **kw):
    return lib.preprocess_files(paths, resize=resize, crop=crop, mean=tpre.IMAGENET_MEAN,
                                std=tpre.IMAGENET_STD, **kw)


def test_libraries_build_where_their_headers_are():
    # The reader needs only g++; the ingest also the libjpeg headers.  Where
    # they are, the build must not fail quietly behind the numpy / PIL path.
    assert native.available("binio") or native._cxx() is None, native.why_unavailable()
    assert native.available("ingest") or not native.jpeg_headers(), native.why_unavailable()
    if native.available():
        assert native.why_unavailable() is None
        for name in native.LIBS:
            lib = native.build(name)  # cached: the same file, not rebuilt
            assert lib == native.build(name) and lib.parent.parent == native.BUILD_ROOT


def test_the_reader_builds_without_libjpeg(tmp_path, monkeypatch, weights_dir, jpegs):
    """A host without the libjpeg headers: the ingest fails to build and
    says why, the reader builds, weights load through it, images take PIL."""
    src = tmp_path / "src"
    src.mkdir()
    (src / "binio.cpp").write_bytes((native._DIR / "binio.cpp").read_bytes())
    (src / "ingest.cpp").write_text("#include <no_such_jpeglib.h>\n")
    monkeypatch.setattr(native, "_DIR", src)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "_errors", {})
    assert native.available("binio") and not native.available("ingest")
    assert not native.available() and "no_such_jpeglib.h" in native.why_unavailable("ingest")
    with pytest.raises(RuntimeError, match="ingest not available"):
        _ingest(native, ["x.jpeg"], 232, 224)
    np.testing.assert_array_equal(tpre.preprocess_files_batch([jpegs["small"]]),
                                  tpre.preprocess_file(jpegs["small"]))
    cfg = tresnet.get_config("resnet18", num_classes=10)
    got = flatten_tree(tckpt.load_reference_format(cfg, weights_dir[0]))
    assert got["fc.bias"].shape == (10,) and set(native._libs) == {"binio"}


def test_loading_the_library_keeps_denormals():
    """Linked without -ffast-math: loading the library must not set
    flush-to-zero for the process (crtfastmath.o would), which would change
    torch's and numpy's CPU numerics."""
    assert native.available()
    tiny = np.float32(1e-39)  # a float32 denormal
    assert tiny * np.float32(1.0) != 0
    assert float(torch.tensor(1e-39, dtype=torch.float32) * 1.0) != 0


@pytest.mark.parametrize("kind", list(JPEGS))
def test_ingest_equals_the_jax_library(jpegs, kind):
    assert native.available() and jnative.available()
    resize, crop = SIZES[kind]
    got = _ingest(native, [jpegs[kind]], resize, crop)
    want = _ingest(jnative, [jpegs[kind]], resize, crop)
    assert got.shape == (1, crop, crop, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", list(JPEGS))
def test_ingest_within_one_level_of_pil(jpegs, kind):
    resize, crop = SIZES[kind]
    nat = _ingest(native, [jpegs[kind]], resize, crop)[0]
    pil = tpre.preprocess_file(jpegs[kind], resize=resize, crop=crop)[0]
    one_level = 1.0 / 255.0 / tpre.IMAGENET_STD  # one u8 step in normalized units
    diff = np.abs(pil - nat)
    assert (diff <= one_level[None, None, :] + 1e-5).all(), diff.max()
    assert (diff < 1e-6).mean() > 0.9


def test_ingest_threads_and_batch_order(jpegs):
    paths = [jpegs["portrait"], jpegs["landscape"], jpegs["portrait"], jpegs["gray"]]
    one = _ingest(native, paths, 232, 224, num_threads=1)
    four = _ingest(native, paths, 232, 224, num_threads=4)
    np.testing.assert_array_equal(one, four)
    np.testing.assert_array_equal(one[0], one[2])
    np.testing.assert_array_equal(one[1], _ingest(native, paths[1:2], 232, 224)[0])


@pytest.mark.parametrize("content", [b"not a jpeg", b""])
def test_ingest_rejects_a_bad_file(tmp_path, content):
    bad = tmp_path / "bad.jpeg"
    bad.write_bytes(content)
    with pytest.raises(ValueError, match="native preprocess failed"):
        _ingest(native, [str(bad)], 232, 224)


def test_preprocess_files_batch_routes_as_jax_does(jpegs, tmp_path):
    """All-JPEG batches take the ingest (equal to JAX's batch); a batch with
    a PNG takes PIL (equal to JAX's PIL batch); a corrupt JPEG raises PIL's
    error."""
    jp = [jpegs["portrait"], jpegs["small"]]
    got = tpre.preprocess_files_batch(jp, resize=73, crop=64)
    np.testing.assert_array_equal(got, _ingest(native, jp, 73, 64))
    np.testing.assert_array_equal(got, jpre.preprocess_files_batch(jp, resize=73, crop=64))
    png = tmp_path / "p.png"
    Image.open(jpegs["landscape"]).save(png)
    mixed = [jpegs["portrait"], str(png)]
    got = tpre.preprocess_files_batch(mixed, resize=73, crop=64)
    np.testing.assert_array_equal(got, np.concatenate(
        [tpre.preprocess_file(p, resize=73, crop=64) for p in mixed]))
    np.testing.assert_array_equal(got, jpre.preprocess_files_batch(mixed, resize=73, crop=64))
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"\xff\xd8 truncated")
    with pytest.raises(Exception, match="cannot identify|truncated"):
        tpre.preprocess_files_batch([jpegs["small"], str(bad)])


def test_preprocess_files_batch_without_the_library_is_pil(jpegs, monkeypatch):
    monkeypatch.setattr(native, "available", lambda name=None: False)
    jp = [jpegs["gray"], jpegs["small"]]
    np.testing.assert_array_equal(
        tpre.preprocess_files_batch(jp, resize=73, crop=64),
        np.concatenate([tpre.preprocess_file(p, resize=73, crop=64) for p in jp]))


def test_read_f32_many_equals_fromfile(tmp_path):
    rng = np.random.default_rng(3)
    sizes = [1, 7, 4096, 300_001, 64]
    paths = []
    for i, n in enumerate(sizes):
        p = tmp_path / f"w{i}"
        rng.standard_normal(n).astype("<f4").tofile(p)
        paths.append(str(p))
    got = native.read_f32_many(paths, sizes, num_threads=3)
    for p, a in zip(paths, got):
        np.testing.assert_array_equal(a, np.fromfile(p, dtype="<f4"))
    np.testing.assert_array_equal(native.read_f32(paths[3], sizes[3]), got[3])


def test_write_f32_is_the_reference_format(tmp_path):
    x = np.random.default_rng(4).standard_normal((3, 5)).astype(np.float32)
    native.write_f32(str(tmp_path / "a"), x)
    jnative.write_f32(str(tmp_path / "b"), x)
    assert (tmp_path / "a").read_bytes() == (tmp_path / "b").read_bytes() == x.tobytes()


@pytest.mark.parametrize("case", ["short", "long", "missing", "ragged"])
def test_a_bad_weight_file_raises_value_error(tmp_path, case):
    p = tmp_path / "w"
    np.zeros(10, "<f4").tofile(p)
    if case == "ragged":
        p.write_bytes(b"\0" * 10)  # not a whole number of floats
        with pytest.raises(ValueError):
            native.read_f32(str(p), 10)
        return
    want = {"short": 11, "long": 9, "missing": 10}[case]
    path = str(tmp_path / "absent") if case == "missing" else str(p)
    with pytest.raises(ValueError):
        native.read_f32_many([path], [want])
    with pytest.raises(ValueError):
        native.read_f32(path, want)


@pytest.fixture(scope="module")
def weights_dir(tmp_path_factory):
    import jax

    d = tmp_path_factory.mktemp("weights")
    jcfg = jresnet.get_config("resnet18", num_classes=10)
    jckpt.save_reference_format(jresnet.init(jcfg, jax.random.key(5)), d)
    return d, jcfg


@pytest.mark.parametrize("read", ["native", "fromfile"])
def test_load_reference_format_equals_jax(weights_dir, read, monkeypatch):
    d, jcfg = weights_dir
    if read == "fromfile":
        monkeypatch.setattr(native, "available", lambda name=None: False)
    want = jckpt.flatten_tree(jckpt.load_reference_format(jcfg, d))
    got = flatten_tree(tckpt.load_reference_format(
        tresnet.get_config("resnet18", num_classes=10), d))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)


def test_load_reference_format_names_the_bad_file(weights_dir, tmp_path):
    d, _ = weights_dir
    cfg = tresnet.get_config("resnet18", num_classes=10)
    for f in d.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    (tmp_path / "layer2.0.bn1.bias").write_bytes(b"\0" * 12)
    with pytest.raises(ValueError, match="layer2.0.bn1.bias"):
        tckpt.load_reference_format(cfg, tmp_path)
    (tmp_path / "fc.weight").unlink()
    with pytest.raises(FileNotFoundError, match="fc.weight"):
        tckpt.load_reference_format(cfg, tmp_path)
