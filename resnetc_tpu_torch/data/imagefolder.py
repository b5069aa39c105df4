"""ImageFolder dataset: labeled training and eval batches from a directory
tree.

Counterpart of ``resnetc_tpu/data/imagefolder.py`` (``scan_imagefolder``
:43, ``random_resized_crop`` :59, ``_train_transform`` :93,
``_eval_transform`` :103, ``ImageFolderLoader`` :108, ``evaluate`` :286),
with the same numpy ``Generator`` draws, so that with one seed the port's
host batches are JAX's bit for bit.  Layout ``root/<class_name>/<image>``
(the torchvision ImageFolder convention; classes are the sorted directory
names; ``.jpg``, ``.jpeg`` and ``.png`` files).

Two transforms:

- eval: short-side resize + center crop (``data.preprocess``, the
  torchvision eval transform), a batch at a time through
  ``preprocess_files_batch`` (the native ingest for an all-JPEG batch);
- train: RandomResizedCrop (scale 0.08-1.0, ratio 3/4-4/3) + horizontal
  flip with PIL, one ``default_rng((seed, draw))`` per image.

Decode runs on a producer thread (the train transform over
``decode_workers`` threads), and the batches reach the device as
``data.loader`` moves them (pinned memory, a side stream, the consumer's
stream waiting on the copy).  JAX's ``sharding`` / ``label_sharding`` are
``device=`` here.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import TYPE_CHECKING, Iterator

import numpy as np
import torch

from resnetc_tpu_torch.data.loader import DeviceCopy, background
from resnetc_tpu_torch.data.preprocess import (
    DEFAULT_CROP,
    DEFAULT_RESIZE,
    IMAGENET_MEAN,
    IMAGENET_STD,
    preprocess_files_batch,
)
from resnetc_tpu_torch.tensor import resolve_device

if TYPE_CHECKING:
    from PIL import Image

_EXTS = (".jpg", ".jpeg", ".png")


def scan_imagefolder(root: str | Path) -> tuple[list[tuple[str, int]], list[str]]:
    """Return ([(path, label)], class_names) for an ImageFolder tree."""
    root = Path(root)
    classes = sorted(d.name for d in root.iterdir() if d.is_dir())
    if not classes:
        raise ValueError(f"no class directories under {root}")
    samples: list[tuple[str, int]] = []
    for label, name in enumerate(classes):
        for f in sorted((root / name).iterdir()):
            if f.suffix.lower() in _EXTS:
                samples.append((str(f), label))
    if not samples:
        raise ValueError(f"no images under {root}")
    return samples, classes


def random_resized_crop(
    img: Image.Image,
    rng: np.random.Generator,
    *,
    size: int,
    scale: tuple[float, float] = (0.08, 1.0),
    ratio: tuple[float, float] = (3 / 4, 4 / 3),
) -> Image.Image:
    """torchvision RandomResizedCrop semantics (10 tries then center fallback)."""
    from PIL import Image

    w, h = img.size
    area = w * h
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        aspect = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            left = int(rng.integers(0, w - cw + 1))
            top = int(rng.integers(0, h - ch + 1))
            crop = img.crop((left, top, left + cw, top + ch))
            return crop.resize((size, size), Image.BILINEAR)
    # Fallback: center crop of the constrained aspect.
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        cw, ch = int(round(h * ratio[1])), h
    else:
        cw, ch = w, h
    left, top = (w - cw) // 2, (h - ch) // 2
    return img.crop((left, top, left + cw, top + ch)).resize((size, size), Image.BILINEAR)


def _train_transform(path: str, rng: np.random.Generator, size: int) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as img:
        img = img.convert("RGB")
        img = random_resized_crop(img, rng, size=size)
        if rng.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        x = np.asarray(img, np.float32) / 255.0
        return (x - IMAGENET_MEAN) / IMAGENET_STD


def _eval_resize(size: int) -> int:
    """The eval transform's short side: 232 at 224, scaled alike elsewhere."""
    return DEFAULT_RESIZE if size == DEFAULT_CROP else int(size * DEFAULT_RESIZE / DEFAULT_CROP)


def _eval_transform(path: str, size: int) -> np.ndarray:
    from resnetc_tpu_torch.data.preprocess import preprocess_file

    return preprocess_file(path, resize=_eval_resize(size), crop=size)[0]


class ImageFolderLoader:
    """Labeled (images, labels) batches from an ImageFolder tree: NHWC
    float32 images and int32 labels, as tensors on ``device`` (None = the
    card), or as numpy arrays with ``to_device=False``.

    train=True: shuffled epochs, RandomResizedCrop + flip; train=False:
    deterministic order, eval transform, remainder dropped (static shapes).
    ``shard=(i, n)``: this process's strided 1/n of every epoch's order, for
    multi-process data parallelism (``batch_size`` is then per process; all
    processes take the same ``seed``).
    """

    def __init__(
        self,
        root: str | Path,
        *,
        batch_size: int,
        image_size: int = DEFAULT_CROP,
        train: bool = False,
        epochs: int | None = None,
        seed: int = 0,
        device: str | torch.device | None = None,
        decode_workers: int = 2,
        prefetch: int = 2,
        shard: tuple[int, int] | None = None,
        to_device: bool = True,
    ):
        self.samples, self.classes = scan_imagefolder(root)
        self.shard = shard
        n_local = len(self.samples) if shard is None else len(self.samples) // shard[1]
        if n_local < batch_size:
            raise ValueError(f"{n_local} images (per process) < batch_size {batch_size}")
        self.batch_size = batch_size
        self.image_size = image_size
        self.train = train
        self.epochs = epochs if epochs is not None else 1
        self.seed = seed
        self.to_device = to_device
        self.device = resolve_device(device) if to_device else None
        self.decode_workers = max(1, decode_workers)
        self.prefetch = prefetch
        self.steps_per_epoch = n_local // batch_size

    def __len__(self) -> int:
        return self.steps_per_epoch * self.epochs

    def _epoch_order(self, epoch: int) -> list[int]:
        idx = np.arange(len(self.samples))
        if self.train:
            np.random.default_rng(self.seed + epoch).shuffle(idx)
        if self.shard is not None:
            i, n = self.shard
            # Strided post-shuffle slice: disjoint across processes, and
            # truncated to the common length so every process runs the
            # same number of steps (collectives stay in lockstep).
            idx = idx[i::n][: len(self.samples) // n]
        return idx.tolist()

    def host_batches(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """The (images, labels) batches as host arrays, decoded in this
        thread (the train transform over ``decode_workers`` threads)."""
        from concurrent.futures import ThreadPoolExecutor

        # Augmentation streams are distinct per process under sharding
        # (the same seed everywhere keeps the shuffles aligned): the draw
        # of image i of shard (p, n) is seeded (seed, i * n + p), which is
        # (seed, i) unsharded.
        aug_p, aug_n = self.shard if self.shard is not None else (0, 1)

        def decode_one(i: int, path: str) -> np.ndarray:
            rng = np.random.default_rng((self.seed, i * aug_n + aug_p))
            return _train_transform(path, rng, self.image_size)

        with ThreadPoolExecutor(self.decode_workers) as pool:
            counter = 0
            for epoch in range(self.epochs):
                order = self._epoch_order(epoch)
                for step in range(self.steps_per_epoch):
                    batch_idx = order[step * self.batch_size : (step + 1) * self.batch_size]
                    paths = [self.samples[i][0] for i in batch_idx]
                    labels = np.array([self.samples[i][1] for i in batch_idx], np.int32)
                    if self.train:
                        uniq = counter * self.batch_size
                        batch = np.stack(list(pool.map(
                            decode_one, range(uniq, uniq + self.batch_size), paths)))
                    else:
                        batch = preprocess_files_batch(
                            paths, resize=_eval_resize(self.image_size), crop=self.image_size,
                            num_threads=self.decode_workers,
                        )
                    counter += 1
                    yield batch, labels

    def __iter__(self) -> Iterator[tuple]:
        if not self.to_device:
            yield from background(self.host_batches, self.prefetch)
            return
        copy = DeviceCopy(self.device)
        for item in background(lambda: (copy.put(*b) for b in self.host_batches()),
                               self.prefetch):
            yield copy.take(item)


def evaluate(
    engine, root: str | Path, *, batch_size: int = 64, image_size: int = DEFAULT_CROP,
    prefetch: int = 2,
) -> dict[str, float]:
    """Top-1 and top-5 accuracy of an ``InferenceEngine`` over an
    ImageFolder tree, the batches on the engine's device (the remainder
    dropped, as in JAX).  The engine's class indices are the model's; for a
    self-labeled folder the folder order must match."""
    loader = ImageFolderLoader(root, batch_size=batch_size, image_size=image_size, train=False,
                               device=engine.device, prefetch=prefetch)
    correct = correct5 = total = 0
    for images, labels in loader:
        logits = engine.logits(images).float().cpu().numpy()
        y = labels.cpu().numpy()
        correct += int((logits.argmax(-1) == y).sum())
        top5 = np.argsort(logits, axis=-1)[:, -5:]
        correct5 += int((top5 == y[:, None]).any(axis=-1).sum())
        total += len(y)
    return {
        "top1": correct / max(total, 1),
        "top5": correct5 / max(total, 1),
        "count": float(total),
    }
