"""Separable convolution and Gaussian filtering.

Twin of ``sara_tpu/image/filtering.py``, on the reference's CPU branch:
replicate-pad, then two 1-D ``F.conv2d`` passes (rows, then columns), in
float32 on the CPU and on the card alike; every leading plane of a stack is
one image of the same call. Under :func:`planewise` the CPU rounds each
plane as alone, so a stack of frames blurs exactly as its frames one by one.
The reference's TPU branch (blurs as banded-Toeplitz matmuls) was a TPU
workaround and is not carried over; ``band_matrix`` is kept because the
port's tests and later slices use it.
"""

from __future__ import annotations

import contextlib
import contextvars
import math

import numpy as np
import torch
import torch.nn.functional as F

from sara_tpu_torch import resolve_device
from sara_tpu_torch.utils.host import put


def gaussian_kernel_1d(sigma: float, truncate: float = 4.0,
                       dtype: torch.dtype = torch.float32,
                       device: str | torch.device | None = None
                       ) -> torch.Tensor:
    """Normalized 1-D Gaussian taps, radius = ceil(truncate * sigma), on
    ``device`` (None: the card, or raise)."""
    radius = max(1, int(math.ceil(truncate * float(sigma))))
    x = torch.arange(-radius, radius + 1, dtype=dtype,
                     device=resolve_device(device))
    k = torch.exp(-(x * x) / (2.0 * float(sigma) ** 2))
    return k / k.sum()


def band_matrix(taps, n_in: int, stride: int) -> np.ndarray:
    """(n_in, n_out) banded Toeplitz matrix applying a CORRELATION with
    ``taps`` at output stride ``stride``, with edge-replicated borders:

      out[j] = sum_k taps[k] * in[clip(stride*j + k - R, 0, n_in-1)].
    """
    R = (len(taps) - 1) // 2
    n_out = -(-n_in // stride)
    B = np.zeros((n_in, n_out), np.float32)
    for j in range(n_out):
        for k, t in enumerate(taps):
            i = min(max(stride * j + k - R, 0), n_in - 1)
            B[i, j] += t
    return B


def _taps(k, like: torch.Tensor) -> torch.Tensor:
    if not isinstance(k, torch.Tensor):
        # Host taps go over without waiting for the device's queue.
        k = put(np.asarray(k, np.float64), like.device)
    return k.to(dtype=like.dtype, device=like.device)


# On the CPU, PyTorch convolves ONE plane of at most this many values on
# its im2col + GEMM path and a larger plane, or a batch of planes, on
# oneDNN (torch 2.13's heuristic); the two round differently, while oneDNN
# rounds a plane alike whatever the batch.
_ONE_PLANE_IM2COL = 20480
_PLANEWISE = contextvars.ContextVar("planewise", default=False)


@contextlib.contextmanager
def planewise():
    """Within the block, every plane of a CPU separable convolution rounds
    as it does convolved alone: a batch of small planes takes the im2col
    path that one such plane takes. So frame b of a (B, H, W) stack blurs
    bit for bit as the frame alone (the Gaussian pyramid runs so). The
    card's cuDNN is left to choose."""
    token = _PLANEWISE.set(True)
    try:
        yield
    finally:
        _PLANEWISE.reset(token)


def _conv2d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``F.conv2d`` of (N, 1, H, W) planes; under :func:`planewise`, on
    the CPU, each plane rounded as alone."""
    if (_PLANEWISE.get() and x.is_cpu and x.shape[0] > 1
            and x[0].numel() <= _ONE_PLANE_IM2COL):
        was = torch.backends.mkldnn.enabled
        torch.backends.mkldnn.enabled = False
        try:
            return F.conv2d(x, w)
        finally:
            torch.backends.mkldnn.enabled = was
    return F.conv2d(x, w)


def separable_conv2d(image: torch.Tensor, kx, ky) -> torch.Tensor:
    """Convolve rows with ``kx`` then columns with ``ky``; replicate borders.

    ``image``: (..., H, W). Kernels are 1-D, odd length (numpy arrays,
    sequences or tensors); they are flipped, so this is a convolution as in
    the reference, where ``F.conv2d`` alone would correlate.
    """
    shape = image.shape
    x = image.reshape((-1, 1) + tuple(shape[-2:]))
    kx = _taps(kx, x)
    ky = _taps(ky, x)
    rx = kx.shape[0] // 2
    ry = ky.shape[0] // 2
    x = F.pad(x, (rx, rx, ry, ry), mode="replicate")
    x = _conv2d(x, kx.flip(0).reshape(1, 1, 1, -1))
    x = _conv2d(x, ky.flip(0).reshape(1, 1, -1, 1))
    return x.reshape(shape)


def gaussian_blur(image: torch.Tensor, sigma: float,
                  truncate: float = 4.0) -> torch.Tensor:
    """Isotropic Gaussian blur; ``sigma`` is a Python float."""
    radius = max(1, int(math.ceil(truncate * float(sigma))))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * float(sigma) ** 2))
    k = k / k.sum()
    return separable_conv2d(image, k, k)


def conv2d(image: torch.Tensor, kernel) -> torch.Tensor:
    """Dense 2-D convolution with replicate borders. kernel: (kh, kw)."""
    shape = image.shape
    x = image.reshape((-1, 1) + tuple(shape[-2:]))
    k = _taps(kernel, x)
    kh, kw = k.shape
    x = F.pad(x, (kw // 2, kw // 2, kh // 2, kh // 2), mode="replicate")
    x = F.conv2d(x, k.flip(0, 1)[None, None])
    return x.reshape(shape[:-2] + x.shape[-2:])


def box_blur(image: torch.Tensor, radius: int) -> torch.Tensor:
    n = 2 * radius + 1
    k = np.full((n,), 1.0 / n)
    return separable_conv2d(image, k, k)


def sobel(image: torch.Tensor):
    """Sobel x/y derivatives: central difference along one axis, [1 2 1]/4
    smoothing along the other."""
    d = np.array([-1.0, 0.0, 1.0])
    s = np.array([1.0, 2.0, 1.0]) / 4.0
    gx = separable_conv2d(image, d, s)
    gy = separable_conv2d(image, s, d)
    return gx, gy
