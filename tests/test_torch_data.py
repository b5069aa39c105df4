"""The port's data pipeline vs the JAX package's: the ImageFolder scan, the
train and eval transforms, ``ImageFolderLoader`` and ``BatchLoader``.

Every input is made here: a 2-class ImageFolder tree of 12 images written
with PIL from seeded uint8 numpy arrays, PNG and JPEG mixed in every batch
(odd sizes, portrait and landscape, one strip narrow enough that
RandomResizedCrop falls back to its center crop).  Both packages decode
with PIL and draw from the same numpy ``Generator`` seeds, so images,
labels and batches are held EQUAL, bit for bit, JAX's loader taken with
``to_device=False`` (host arrays).  ``BatchLoader`` on the CPU gives the
batches of ``preprocess_files_batch``.  The abandoned-iterator and
decode-error contracts are those of ``tests/test_data.py:82-108``.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from resnetc_tpu import data as jdata
from resnetc_tpu.data import imagefolder as jif
from resnetc_tpu_torch import data as tdata
from resnetc_tpu_torch.data import imagefolder as tif
from resnetc_tpu_torch.data import loader as tloader
from resnetc_tpu_torch.data import preprocess as tpre

#: Per class: (file name, height, width); PNG and JPEG alternate so that no
#: eval batch is all JPEG (both packages then decode with PIL).
FILES = [("a.png", 70, 53), ("b.jpeg", 45, 88), ("c.jpg", 61, 61), ("d.png", 90, 40),
         ("e.jpeg", 52, 77), ("f.png", 20, 200)]
SIZE = 32


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("tree")
    rng = np.random.default_rng(0)
    for cls in ("cat", "dog"):
        (root / cls).mkdir()
        for name, h, w in FILES:
            arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            Image.fromarray(arr).save(root / cls / name)
    (root / "cat" / "notes.txt").write_text("not an image")
    return root


def _equal_batches(got, want):
    assert len(got) == len(want)
    for (gx, gy), (wx, wy) in zip(got, want):
        gx, gy = (np.asarray(t) for t in (gx, gy))
        assert gx.dtype == np.float32 and gy.dtype == np.int32
        np.testing.assert_array_equal(gx, np.asarray(wx))
        np.testing.assert_array_equal(gy, np.asarray(wy))


def test_data_exports_the_jax_names():
    names = {n for n in dir(jdata) if not n.startswith("_")}
    assert "ImageFolderLoader" in names and names <= set(dir(tdata)), names - set(dir(tdata))


def test_scan_imagefolder_equals_jax(tree):
    assert tif.scan_imagefolder(tree) == jif.scan_imagefolder(tree)
    samples, classes = tif.scan_imagefolder(tree)
    assert classes == ["cat", "dog"] and len(samples) == 12


def test_scan_imagefolder_rejects_empty_trees(tmp_path):
    with pytest.raises(ValueError, match="no class directories"):
        tif.scan_imagefolder(tmp_path)
    (tmp_path / "x").mkdir()
    with pytest.raises(ValueError, match="no images"):
        tif.scan_imagefolder(tmp_path)


@pytest.mark.parametrize("name, seed", [("a.png", 0), ("b.jpeg", 1), ("d.png", 2),
                                        ("f.png", 3), ("f.png", 11)])
def test_random_resized_crop_equals_jax(tree, name, seed):
    with Image.open(tree / "cat" / name) as img:
        img = img.convert("RGB")
        got = tif.random_resized_crop(img, np.random.default_rng(seed), size=SIZE)
        want = jif.random_resized_crop(img, np.random.default_rng(seed), size=SIZE)
    assert got.size == (SIZE, SIZE)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_random_resized_crop_falls_back_to_the_center():
    """A 1:10 strip with scale (0.9, 1): no try fits, so both packages take
    the center crop of the constrained aspect."""
    img = Image.fromarray(np.random.default_rng(5).integers(0, 256, (10, 100, 3), np.uint8))
    kw = dict(size=8, scale=(0.9, 1.0))
    got = tif.random_resized_crop(img, np.random.default_rng(0), **kw)
    want = jif.random_resized_crop(img, np.random.default_rng(0), **kw)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("name", ["a.png", "b.jpeg", "f.png"])
def test_transforms_equal_jax(tree, name):
    path = str(tree / "dog" / name)
    for seed in range(3):
        np.testing.assert_array_equal(
            tif._train_transform(path, np.random.default_rng(seed), SIZE),
            jif._train_transform(path, np.random.default_rng(seed), SIZE))
    for size in (SIZE, 224):
        np.testing.assert_array_equal(tif._eval_transform(path, size),
                                      jif._eval_transform(path, size))


@pytest.mark.parametrize("shard", [None, (0, 2), (1, 2)])
def test_train_loader_equals_jax(tree, shard):
    """Two shuffled epochs, augmentations drawn per image; sharded, each
    process's strided slice with its own draws."""
    kw = dict(batch_size=3, image_size=SIZE, train=True, epochs=2, seed=7, shard=shard)
    got = list(tif.ImageFolderLoader(tree, to_device=False, **kw))
    want = list(jif.ImageFolderLoader(tree, to_device=False, **kw))
    assert len(got) == (4 if shard is None else 2) * 2
    _equal_batches(got, want)


def test_train_shards_partition_each_epoch(tree):
    kw = dict(batch_size=3, image_size=SIZE, train=True, epochs=2, seed=7)
    one = tif.ImageFolderLoader(tree, **kw, device="cpu")
    parts = [tif.ImageFolderLoader(tree, **kw, shard=(i, 2), device="cpu") for i in range(2)]
    for epoch in range(2):
        order = one._epoch_order(epoch)
        assert sorted(parts[0]._epoch_order(epoch) + parts[1]._epoch_order(epoch)) == sorted(order)


def test_eval_loader_equals_jax_and_drops_the_remainder(tree):
    kw = dict(batch_size=5, image_size=SIZE, train=False)
    got = list(tif.ImageFolderLoader(tree, to_device=False, **kw))
    want = list(jif.ImageFolderLoader(tree, to_device=False, **kw))
    assert len(got) == 2  # 12 images, batch 5: 2 batches, 2 images dropped
    _equal_batches(got, want)
    np.testing.assert_array_equal(got[0][1], [0, 0, 0, 0, 0])


@pytest.mark.parametrize("prefetch", [0, 2])
def test_device_batches_equal_the_host_arrays(tree, prefetch):
    kw = dict(batch_size=4, image_size=SIZE, train=True, epochs=1, seed=3)
    host = list(tif.ImageFolderLoader(tree, to_device=False, **kw))
    dev = list(tif.ImageFolderLoader(tree, device="cpu", prefetch=prefetch, **kw))
    assert all(isinstance(t, torch.Tensor) for b in dev for t in b)
    _equal_batches(dev, host)


def test_loader_rejects_small_dataset(tree):
    with pytest.raises(ValueError, match="< batch_size"):
        tif.ImageFolderLoader(tree, batch_size=13, device="cpu")
    with pytest.raises(ValueError, match="per process"):
        tif.ImageFolderLoader(tree, batch_size=7, shard=(0, 2), device="cpu")


def _paths(tree):
    return [str(tree / cls / name) for cls in ("cat", "dog") for name, _, _ in FILES]


@pytest.mark.parametrize("prefetch", [0, 2])
def test_batch_loader_gives_the_preprocessed_batches(tree, prefetch):
    """Steps past the list recycle the paths in order."""
    paths = _paths(tree)[:5]
    loader = tdata.BatchLoader(paths, batch_size=2, steps=4, image_size=SIZE, device="cpu",
                               prefetch=prefetch)
    got = list(loader)
    assert len(got) == len(loader) == 4
    order = [paths[i % 5] for i in range(8)]
    for i, b in enumerate(got):
        assert b.shape == (2, SIZE, SIZE, 3) and b.dtype == torch.float32
        np.testing.assert_array_equal(
            b.numpy(), tpre.preprocess_files_batch(order[2 * i: 2 * i + 2], crop=SIZE))


def test_batch_loader_rejects_empty_and_undersized(tree):
    with pytest.raises(ValueError):
        tdata.BatchLoader([], batch_size=1, device="cpu")
    with pytest.raises(ValueError):
        tdata.BatchLoader(_paths(tree)[:1], batch_size=2, device="cpu")


@pytest.mark.parametrize("prefetch", [0, 2])
def test_batch_loader_surfaces_decode_errors(tmp_path, tree, prefetch):
    bad = tmp_path / "corrupt.jpeg"
    bad.write_bytes(b"not a jpeg")
    loader = tdata.BatchLoader([_paths(tree)[0], bad], batch_size=1, steps=2, image_size=SIZE,
                               device="cpu", prefetch=prefetch)
    it = iter(loader)
    assert next(it).shape == (1, SIZE, SIZE, 3)  # the batch before the bad file arrives
    with pytest.raises(Exception, match="cannot identify"):
        next(it)


def test_imagefolder_loader_surfaces_decode_errors(tree, tmp_path):
    for cls in ("x", "y"):
        (tmp_path / cls).mkdir()
        for i in range(2):
            (tmp_path / cls / f"{i}.png").write_bytes(b"broken")
    with pytest.raises(Exception, match="cannot identify"):
        list(tif.ImageFolderLoader(tmp_path, batch_size=2, image_size=SIZE, device="cpu"))


def _no_thread_leaks(before):
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        leaked = [t for t in threading.enumerate() if t.ident not in before and t.is_alive()]
        if not leaked:
            return
        time.sleep(0.05)
    raise AssertionError(f"producer thread(s) leaked after abandoned iteration: {leaked}")


@pytest.mark.parametrize("which", ["batch", "imagefolder"])
def test_abandoned_iteration_stops_producer(tree, which):
    """Breaking out of iteration early must not leak the producer thread
    blocked on a full queue (the take-n-steps pattern of ``train``)."""
    before = {t.ident for t in threading.enumerate()}
    if which == "batch":
        loader = tdata.BatchLoader(_paths(tree)[:1], batch_size=1, steps=100, image_size=SIZE,
                                   device="cpu", prefetch=2)
    else:
        loader = tif.ImageFolderLoader(tree, batch_size=2, image_size=SIZE, train=True,
                                       epochs=100, device="cpu", prefetch=2)
    for _ in loader:
        break  # abandon after one batch — producer is mid-stream, queue fills
    _no_thread_leaks(before)


def test_background_yields_in_order_then_raises():
    def items():
        yield 1
        yield 2
        raise KeyError("boom")

    got = []
    with pytest.raises(KeyError, match="boom"):
        for x in tloader.background(items, prefetch=1):
            got.append(x)
    assert got == [1, 2]
