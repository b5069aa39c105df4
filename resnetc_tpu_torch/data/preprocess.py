"""Image preprocessing: the torchvision ImageNet eval transform, standalone.

The port's own copy of ``resnetc_tpu/data/preprocess.py`` (numpy + PIL on
the host, no framework): resize the short side to 232 (bilinear),
center-crop 224, scale to [0, 1], normalize with the ImageNet mean and std
(convert_imgs_to_bin.py:12, through the weights' transform).  The output is
a numpy array; the engine moves it to its device.  A batch of JPEGs
takes the native libjpeg ingest where it built
(``preprocess_files_batch``).

Also reads and writes the reference's input format: a flat, headerless,
little-endian float32 file holding the preprocessed NCHW tensor
(convert_imgs_to_bin.py:21-23, read at main.cu:236-237).  PIL is imported
where an image is decoded, so the ``.bin`` functions need only numpy.
"""

from __future__ import annotations

import os
import typing
from pathlib import Path

import numpy as np

if typing.TYPE_CHECKING:
    from PIL import Image

# The torchvision constants (convert_imgs_to_bin.py via the weights'
# transform; pytorch_inference.py's normalize).
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)

#: The reference transform's short-side resize and center crop.
DEFAULT_RESIZE = 232
DEFAULT_CROP = 224


def _resize_short_side(img: Image.Image, size: int) -> Image.Image:
    from PIL import Image

    w, h = img.size
    if w <= h:
        new_w, new_h = size, max(1, round(h * size / w))
    else:
        new_w, new_h = max(1, round(w * size / h)), size
    return img.resize((new_w, new_h), Image.BILINEAR)


def _center_crop(img: Image.Image, size: int) -> Image.Image:
    w, h = img.size
    left = (w - size) // 2
    top = (h - size) // 2
    return img.crop((left, top, left + size, top + size))


def preprocess_image(
    img: Image.Image,
    *,
    resize: int = DEFAULT_RESIZE,
    crop: int = DEFAULT_CROP,
    layout: str = "NHWC",
) -> np.ndarray:
    """PIL image -> normalized float32 array with a leading batch dim of 1,
    in ``layout`` "NHWC" (the engine's) or "NCHW" (the reference's on
    disk).  Any mode PIL can convert to RGB (grayscale, RGBA, ...)."""
    if layout not in ("NHWC", "NCHW"):
        raise ValueError(f"layout must be 'NHWC' or 'NCHW', got {layout!r}")
    img = img.convert("RGB")
    img = _resize_short_side(img, resize)
    img = _center_crop(img, crop)
    x = np.asarray(img, dtype=np.float32) / 255.0  # HWC in [0, 1]
    x = (x - IMAGENET_MEAN) / IMAGENET_STD
    if layout == "NCHW":
        x = x.transpose(2, 0, 1)
    return x[None]


def preprocess_file(path: str | os.PathLike, **kwargs) -> np.ndarray:
    """An image file (JPEG, PNG, ...) -> preprocessed batch-of-1 array."""
    from PIL import Image

    with Image.open(path) as img:
        return preprocess_image(img, **kwargs)


def preprocess_files_batch(
    paths: list[str],
    *,
    resize: int = DEFAULT_RESIZE,
    crop: int = DEFAULT_CROP,
    num_threads: int = 4,
) -> np.ndarray:
    """Decode and preprocess a batch -> (N, crop, crop, 3) float32 NHWC.

    An all-JPEG batch goes through the native libjpeg ingest
    (``resnetc_tpu_torch.native``, ``num_threads`` threads) where the
    library built; any other batch, or a file the ingest refuses, through
    PIL one file at a time (the error a corrupt file raises is then PIL's).
    The two paths agree within one uint8 level (tests/test_torch_native.py),
    as in ``resnetc_tpu/data/preprocess.py:79-107``."""
    jpeg_only = all(str(p).lower().endswith((".jpg", ".jpeg")) for p in paths)
    if jpeg_only:
        from resnetc_tpu_torch import native

        if native.available("ingest"):
            try:
                return native.preprocess_files(
                    [str(p) for p in paths], resize=resize, crop=crop,
                    mean=IMAGENET_MEAN, std=IMAGENET_STD, num_threads=num_threads,
                )
            except ValueError:
                pass  # a corrupt file: PIL gives the real error
    return np.concatenate([preprocess_file(p, resize=resize, crop=crop) for p in paths])


def save_input_bin(x: np.ndarray, path: str | os.PathLike) -> None:
    """Write the reference's input format: flat little-endian f32 in NCHW
    order.  A 4-D array whose last axis is 3 is taken as NHWC and
    transposed."""
    x = np.asarray(x, dtype=np.float32)
    if x.ndim == 4 and x.shape[-1] == 3:
        x = x.transpose(0, 3, 1, 2)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    x.astype("<f4").tofile(path)


def load_input_bin(
    path: str | os.PathLike,
    *,
    batch: int = 1,
    height: int = DEFAULT_CROP,
    width: int = DEFAULT_CROP,
    layout: str = "NHWC",
) -> np.ndarray:
    """Read a reference ``.bin`` input (flat NCHW f32; the shape is the
    caller's, as main.cu:236-237 takes it) in ``layout`` "NHWC" or
    "NCHW".  A file of another size raises ``ValueError``."""
    raw = np.fromfile(path, dtype="<f4")
    expected = batch * 3 * height * width
    if raw.size != expected:
        raise ValueError(f"{path}: {raw.size} elems, expected {expected}")
    x = raw.reshape(batch, 3, height, width)
    if layout == "NHWC":
        x = x.transpose(0, 2, 3, 1)
    return np.ascontiguousarray(x)
