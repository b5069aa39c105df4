"""Host-side input handling: the reference's image preprocessing and its
``.bin`` input format (``preprocess``), the batch loaders with background
decode and device prefetch (``loader``), and the ImageFolder pipeline
(``imagefolder``).  The names of ``resnetc_tpu/data/__init__.py``."""

from resnetc_tpu_torch.data.preprocess import (  # noqa: F401
    IMAGENET_MEAN,
    IMAGENET_STD,
    load_input_bin,
    preprocess_file,
    preprocess_image,
    save_input_bin,
)
from resnetc_tpu_torch.data.loader import BatchLoader, synthetic_batches  # noqa: F401
from resnetc_tpu_torch.data.imagefolder import (  # noqa: F401
    ImageFolderLoader,
    evaluate,
    scan_imagefolder,
)
