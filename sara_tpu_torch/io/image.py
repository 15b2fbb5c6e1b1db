"""Image reading/writing (twin of ``sara_tpu/io/image.py``).

The codecs are PIL's, imported inside each function (a machine without
PIL imports the package and fails only when it reads or writes an image);
EXIF orientation is applied as in the twin. Host NumPy arrays in and out.
"""

from __future__ import annotations

import numpy as np


def supported_formats() -> dict[str, bool]:
    """Codec availability for the reference's ImageIO format set
    (reference: ImageIO/Details/Heif.cpp, WebP.cpp). HEIF needs the optional
    ``pillow_heif`` plugin; when absent, .heic/.heif reads raise with a clear
    message instead of PIL's generic "cannot identify image file".
    """
    from PIL import features

    heif = False
    try:  # registers HEIF with PIL as a side effect when present
        import pillow_heif  # noqa: F401

        pillow_heif.register_heif_opener()
        heif = True
    except ImportError:
        pass
    return {
        "jpeg": features.check("jpg"),
        "png": features.check("zlib"),
        "tiff": True,  # PIL core
        "webp": features.check("webp"),
        "heif": heif,
    }


def imread(path: str, apply_exif: bool = True) -> np.ndarray:
    """Read an image as uint8 RGB (H, W, 3) (grayscale -> (H, W))."""
    import PIL.Image
    from PIL import ImageOps

    if str(path).lower().endswith((".heic", ".heif")):
        if not supported_formats()["heif"]:
            raise RuntimeError(
                "HEIF support requires the optional 'pillow_heif' package"
            )
    img = PIL.Image.open(path)
    if apply_exif:
        img = ImageOps.exif_transpose(img)
    if img.mode in ("RGBA", "P", "CMYK"):
        img = img.convert("RGB")
    return np.asarray(img)


def imread_gray(path: str, scale: float | None = None) -> np.ndarray:
    """Read as float32 grayscale in [0, 1]; optional downscale factor."""
    import PIL.Image
    from PIL import ImageOps

    img = PIL.Image.open(path)
    img = ImageOps.exif_transpose(img).convert("L")
    if scale is not None and scale != 1.0:
        w, h = img.size
        img = img.resize((int(w * scale), int(h * scale)))
    return np.asarray(img, np.float32) / 255.0


def imwrite(path: str, image: np.ndarray, **save_kwargs):
    """Write an image; codec picked from the extension. Extra keyword args go
    to the encoder (e.g. ``quality=95``, ``lossless=True`` for WebP)."""
    import PIL.Image

    a = np.asarray(image)
    if a.dtype != np.uint8:
        a = (np.clip(a, 0.0, 1.0) * 255).astype(np.uint8)
    PIL.Image.fromarray(a).save(path, **save_kwargs)
