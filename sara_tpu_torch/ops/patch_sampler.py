"""Bilinear field-patch sampler: kernel K1 written by hand for Hopper.

Twin of ``sara_tpu/ops/patch_sampler.py``. The descriptor stage reads, for
K keypoints, N bilinear samples of contiguous C-channel rows from one scale
slice of a dense (S, H, W, C) field:

    out[k, n, c] = sum_{a,b} tri(y - a) * tri(x - b) * maps[s_k, a, b, c]

with the coordinates clamped to the map first (clamp-to-edge).

On a CUDA tensor :func:`sample_field_patches` launches the kernel of
``csrc/patch_sampler.cu`` (built by ``_build`` at first use), which replaces
the TPU kernel ``_sampler_kernel`` in its plain mode. The TPU kernel staged
one window per keypoint in VMEM and declined geometries whose window did not
fit; the CUDA kernel reads its four taps per sample straight from device
memory, so it samples every geometry and never returns ``None``. On a CPU
tensor the wrapper takes the plain version :func:`_sample_patches_reference`,
and only because the tensor lies on the CPU. The x-packed mode (kernel K2)
is not ported yet.
"""

from __future__ import annotations

import ctypes

import torch

from sara_tpu_torch.ops import _build

# Launches of the CUDA kernel in this process; a run reads it to show that
# its path went through the kernel.
LAUNCHES = 0

_ENTRY = {torch.float32: "sara_sample_patches_f32",
          torch.bfloat16: "sara_sample_patches_bf16"}


def _sample_patches_reference(maps: torch.Tensor, s_idx: torch.Tensor,
                              ys: torch.Tensor,
                              xs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: four flat row gathers, f32 weights."""
    S, H, W, C = maps.shape
    K, N = ys.shape
    s = s_idx.long().clamp(0, S - 1)
    yc = ys.clamp(0.0, H - 1.0)
    xc = xs.clamp(0.0, W - 1.0)
    y0 = torch.floor(yc).long()
    x0 = torch.floor(xc).long()
    y1 = torch.clamp(y0 + 1, max=H - 1)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    fy = (yc - y0)[..., None]
    fx = (xc - x0)[..., None]
    flat = maps.reshape(S * H * W, C)
    base = s[:, None] * (H * W)

    def take(yy, xx):
        rows = (base + yy * W + xx).reshape(-1)
        return flat.index_select(0, rows).reshape(K, N, C).float()

    return (take(y0, x0) * (1 - fx) * (1 - fy) + take(y0, x1) * fx * (1 - fy)
            + take(y1, x0) * (1 - fx) * fy + take(y1, x1) * fx * fy)


def _launch(maps: torch.Tensor, s_idx: torch.Tensor, ys: torch.Tensor,
            xs: torch.Tensor) -> torch.Tensor:
    global LAUNCHES
    S, H, W, C = maps.shape
    K, N = ys.shape
    fn = getattr(_build.load("patch_sampler"), _ENTRY[maps.dtype])
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((K, N, C), dtype=torch.float32, device=maps.device)
    with torch.cuda.device(maps.device):
        stream = torch.cuda.current_stream(maps.device).cuda_stream
        err = fn(maps.data_ptr(), s_idx.data_ptr(), ys.data_ptr(),
                 xs.data_ptr(), out.data_ptr(), S, H, W, C, K, N, stream)
    if err != 0:
        raise RuntimeError(f"patch_sampler kernel launch failed: "
                           f"cudaError_t {err}")
    LAUNCHES += 1
    return out


def sample_field_patches(maps: torch.Tensor, s_idx: torch.Tensor,
                         ys: torch.Tensor, xs: torch.Tensor,
                         max_sample_radius: float,
                         block: int = 8,
                         pack_x: bool = False) -> torch.Tensor:
    """Bilinear-sample (K, N) positions from (S, H, W, C) maps.

    Returns (K, N, C) float32 for every geometry: there is no fit rule and
    no ``None``. A CUDA tensor goes through the kernel, or the call raises;
    a CPU tensor goes through the plain version.

    Args:
      maps: (S, H, W, C) float32 or bfloat16 field, contiguous.
      s_idx: (K,) integer scale-slice index per keypoint (clamped to S - 1).
      ys, xs: (K, N) float32 sample positions in map pixels, contiguous.
      max_sample_radius, block: kept for the signature of the JAX twin,
        where they size the TPU window; they do not change the result.
      pack_x: the x-packed mode (kernel K2); not ported yet.
    """
    if pack_x:
        raise NotImplementedError("K2 not ported yet")
    if maps.dim() != 4 or maps.dtype not in _ENTRY:
        raise ValueError(f"maps must be (S, H, W, C) float32 or bfloat16, "
                         f"got {tuple(maps.shape)} {maps.dtype}")
    if ys.dim() != 2 or ys.shape != xs.shape or s_idx.shape != ys.shape[:1]:
        raise ValueError(f"need s_idx (K,), ys and xs (K, N); got "
                         f"{tuple(s_idx.shape)}, {tuple(ys.shape)}, "
                         f"{tuple(xs.shape)}")
    if ys.dtype != torch.float32 or xs.dtype != torch.float32:
        raise ValueError(f"ys and xs must be float32, got {ys.dtype}, "
                         f"{xs.dtype}")
    if s_idx.dtype.is_floating_point or s_idx.dtype == torch.bool:
        raise ValueError(f"s_idx must be an integer tensor, got "
                         f"{s_idx.dtype}")
    devices = {t.device for t in (maps, s_idx, ys, xs)}
    if len(devices) != 1:
        raise ValueError(f"all inputs must be on one device, got {devices}")
    if maps.device.type == "cpu":
        return _sample_patches_reference(maps, s_idx, ys, xs)
    if maps.device.type != "cuda":
        raise ValueError(f"unsupported device {maps.device}")
    if not (maps.is_contiguous() and ys.is_contiguous()
            and xs.is_contiguous()):
        raise ValueError("maps, ys and xs must be contiguous")
    if ys.numel() * maps.shape[3] >= 2 ** 39:   # 2^31 blocks of 256
        raise ValueError("K * N * C too large for one launch")
    return _launch(maps, s_idx.to(torch.int32).contiguous(), ys, xs)
