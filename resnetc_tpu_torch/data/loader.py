"""Batched ingest: background decode and host-to-device prefetch, and
synthetic training batches.

Counterpart of ``resnetc_tpu/data/loader.py`` (``BatchLoader`` :31,
``synthetic_batches`` :152).  The reference feeds its engine one
preprocessed image read from disk (main.cu:236-238); serving and training
need device-resident batches with decode overlapped against the card, so:

- a producer thread decodes and preprocesses (``preprocess_files_batch``:
  the native libjpeg ingest for JPEGs, PIL otherwise) into fixed-shape
  NHWC float32 batches;
- each batch is copied into pinned host memory, then to the device with
  ``non_blocking=True`` on a side stream, and an event is recorded after
  the copy; the producer runs at most ``prefetch`` batches ahead (a bounded
  queue);
- the consumer's stream waits on that event before the batch is handed
  out, and ``record_stream`` tells the caching allocator that the consumer's
  stream uses the batch, so its memory is not reused while work queued
  there may still read it.

Abandoning the iterator (``break``, ``islice``) stops the producer: its
``put`` gives up once the consumer is gone, as in JAX's fix
(``loader.py:96-105``, ``:136-143``), and the iterator's close waits for
it to finish the batch in hand.  An exception in the producer
(a corrupt file) is raised to the consumer after the batches before it.
``prefetch=0`` decodes and copies each batch in the caller's thread when it
is asked for (JAX's queue of size 0 would be unbounded).
"""

from __future__ import annotations

import queue
import threading
from collections.abc import Callable, Iterator, Sequence
from pathlib import Path

import numpy as np
import torch

from resnetc_tpu_torch.data.preprocess import DEFAULT_CROP
from resnetc_tpu_torch.tensor import resolve_device


def background(items: Callable[[], Iterator], prefetch: int) -> Iterator:
    """Run the iterator ``items()`` on a producer thread, at most
    ``prefetch`` items ahead of the consumer; re-raise its exception in the
    consumer.  ``prefetch <= 0`` runs it inline."""
    if prefetch <= 0:
        yield from items()
        return
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    sentinel = object()
    errbox: list[BaseException] = []
    stop = threading.Event()  # set when the consumer abandons iteration

    def put(item) -> bool:
        """Bounded put that gives up once the consumer is gone: without
        this, an abandoned iterator leaves the producer blocked on a full
        queue forever, leaking the thread and the prefetched batches."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in items():
                if not put(item):
                    return
        except BaseException as e:  # surfaced to the consumer below
            errbox.append(e)
        finally:
            put(sentinel)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
        t.join()
        if errbox:
            raise errbox[0]
    finally:
        stop.set()
        while True:  # drain so a producer blocked on put() wakes and exits
            try:
                q.get_nowait()
            except queue.Empty:
                break
        # The producer ends after the item in hand: it never outlives the
        # iterator (a thread still decoding or copying at interpreter exit
        # can abort the process).
        t.join()


class DeviceCopy:
    """Host arrays to ``device``: on the card through pinned memory and a
    side stream (``put``, in the producer), the consumer's stream made to
    wait for the copy (``take``); elsewhere ``torch.from_numpy``."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def put(self, *arrays: np.ndarray) -> tuple:
        if self.stream is None:
            return tuple(torch.from_numpy(a).to(self.device) for a in arrays), None
        with torch.cuda.stream(self.stream):
            out = tuple(torch.from_numpy(a).pin_memory().to(self.device, non_blocking=True)
                        for a in arrays)
            done = torch.cuda.Event()
            done.record(self.stream)
        return out, done

    def take(self, item) -> tuple:
        tensors, done = item
        if done is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(done)
            for t in tensors:
                t.record_stream(consumer)
        return tensors


class BatchLoader:
    """Iterate device-resident NHWC float32 batches decoded from image files.

    Parameters
    ----------
    paths: image files (JPEG / PNG). Recycled (in order) if ``steps`` needs
        more than one pass.
    batch_size: fixed output batch size (a short remainder is dropped).
    steps: number of batches to produce; None = one epoch.
    device: where the batches go (None = the card; "cpu" for tensors on
        the CPU).  JAX's ``sharding=``.
    prefetch: batches decoded and copied ahead of the consumer.
    decode_workers: the native ingest's threads.
    """

    def __init__(
        self,
        paths: Sequence[str | Path],
        *,
        batch_size: int,
        image_size: int = DEFAULT_CROP,
        steps: int | None = None,
        device: str | torch.device | None = None,
        prefetch: int = 2,
        decode_workers: int = 2,
    ):
        if not paths:
            raise ValueError("BatchLoader needs at least one image path")
        self.paths = [str(p) for p in paths]
        self.batch_size = batch_size
        self.image_size = image_size
        if steps is None:
            steps = len(self.paths) // batch_size
            if steps == 0:
                raise ValueError(
                    f"{len(self.paths)} images < batch_size {batch_size}; pass steps= to recycle"
                )
        self.steps = steps
        self.device = resolve_device(device)
        self.prefetch = prefetch
        self.decode_workers = max(1, decode_workers)

    def host_batches(self) -> Iterator[np.ndarray]:
        """The batches as host arrays, in order, decoded in this thread."""
        from resnetc_tpu_torch.data.preprocess import preprocess_files_batch

        n = len(self.paths)
        for step in range(self.steps):
            start = step * self.batch_size
            chunk = [self.paths[(start + j) % n] for j in range(self.batch_size)]
            yield preprocess_files_batch(chunk, crop=self.image_size,
                                         num_threads=self.decode_workers)

    def __iter__(self) -> Iterator[torch.Tensor]:
        copy = DeviceCopy(self.device)
        for item in background(lambda: (copy.put(b) for b in self.host_batches()),
                               self.prefetch):
            yield copy.take(item)[0]

    def __len__(self) -> int:
        return self.steps


def synthetic_batches(
    *,
    batch_size: int,
    image_size: int = DEFAULT_CROP,
    steps: int,
    num_classes: int = 1000,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
    """Deterministic fake (images NHWC fp32, labels int32) batches for
    benchmarks and tests: the JAX package's numpy draws from
    ``default_rng(seed)``, so both packages see the same arrays.  Made once
    and copied to the device once (the card unless ``device="cpu"``); the
    same batch is yielded ``steps`` times."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((batch_size, image_size, image_size, 3)).astype(np.float32)
    labels = rng.integers(0, num_classes, size=(batch_size,)).astype(np.int32)
    dev_images = torch.from_numpy(images).to(dev)
    dev_labels = torch.from_numpy(labels).to(dev)
    for _ in range(steps):
        yield dev_images, dev_labels
