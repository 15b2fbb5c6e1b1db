"""Dataset loaders.

Twin of ``sara_tpu/io/datasets.py`` (reference:
cpp/src/DO/Sara/Datasets/Strecha/Utilities.hpp:25
``read_internal_camera_parameters`` and the bundled demo image pair used by
BASELINE config 1). Host code; the port keeps its own copy. The port adds
``synthetic_image_pair``, the pair its demos default to.
"""

from __future__ import annotations

import os

import numpy as np

from sara_tpu_torch.io.image import imread_gray

# The twin's fixed, read-only data directory of the reference project
# (``sara_tpu/io/datasets.py``), the same absolute path in both packages.
REFERENCE_DATA = os.path.join(os.sep, "root", "reference", "data")


def read_strecha_camera(path: str) -> np.ndarray:
    """Read a Strecha '*.camera'-style file: the first 3 lines hold K
    (reference: Datasets/Strecha/Utilities.hpp:25)."""
    vals = []
    with open(path) as f:
        for line in f:
            vals.extend(float(x) for x in line.split())
    K = np.asarray(vals[:9]).reshape(3, 3)
    return K


def load_image_pair(max_width: int | None = None):
    """The bundled demo pair (data/sunflowerField.jpg + data/dog.jpg)."""
    a = imread_gray(os.path.join(REFERENCE_DATA, "sunflowerField.jpg"))
    b = imread_gray(os.path.join(REFERENCE_DATA, "dog.jpg"))
    if max_width:
        import PIL.Image

        def shrink(x):
            h, w = x.shape
            if w <= max_width:
                return x
            s = max_width / w
            img = PIL.Image.fromarray((x * 255).astype(np.uint8))
            img = img.resize((max_width, int(h * s)))
            return np.asarray(img, np.float32) / 255.0

        a, b = shrink(a), shrink(b)
    return a, b


def synthetic_image_pair(width: int = 640, shift: int = 16, seed: int = 0):
    """A frame pair for the demos where no photographs exist: frame A is
    uniform noise (``RandomState(seed)``) of ``width`` x 3/4 ``width``
    pixels, frame B is A rolled ``shift`` pixels along x, so
    B(x + shift) = A(x) (``bench.py``'s fallback pair at 640 wide)."""
    h = width * 3 // 4
    a = np.random.RandomState(seed).rand(h, width).astype(np.float32)
    return a, np.roll(a, shift, axis=1)
