"""GEMM-based convolution via im2col patch extraction.

Twin of ``sara_tpu/image/im2col.py`` (reference:
cpp/src/DO/Sara/ImageProcessing/GemmBasedConvolution.hpp). ``im2col`` is an
index gather, written as two ``Tensor.unfold`` views copied once into the
patch matrix; ``gemm_conv2d`` is one matrix-vector product on it (TF32 is
pinned off package-wide, so the product stays float32). Each function runs
where its input tensor lies; a host array goes to the card.
"""

from __future__ import annotations

from sara_tpu_torch.utils.host import as_tensor


def im2col(image, kh: int, kw: int, stride: int = 1):
    """(H, W) -> (Ho*Wo, kh*kw) patch matrix (VALID padding)."""
    image = as_tensor(image)
    H, W = image.shape
    Ho = (H - kh) // stride + 1
    Wo = (W - kw) // stride + 1
    patches = image.unfold(0, kh, stride).unfold(1, kw, stride)
    return patches[:Ho, :Wo].reshape(Ho * Wo, kh * kw), (Ho, Wo)


def gemm_conv2d(image, kernel, stride: int = 1):
    """2-D VALID convolution as im2col + one GEMM (correlation convention,
    matching lax.conv with flipped kernel)."""
    image = as_tensor(image)
    kernel = as_tensor(kernel, device=image.device).to(image.dtype)
    kh, kw = kernel.shape
    cols, (Ho, Wo) = im2col(image, kh, kw, stride)
    out = cols @ kernel.reshape(-1)
    return out.reshape(Ho, Wo)
