"""Color conversion (twin of ``sara_tpu/image/color.py``; reference:
cpp/src/DO/Sara/Core/Pixel/ColorConversion.hpp)."""

from __future__ import annotations

import numpy as np
import torch

# ITU-R BT.601 luma weights, as used by the reference's rgb->gray.
_LUMA = (0.299, 0.587, 0.114)


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) float in [0,1] -> (H, W) float32."""
    x = rgb[..., :3].to(torch.float32)
    w = torch.tensor(_LUMA, dtype=torch.float32, device=x.device)
    return x @ w


def gray_from_any(image) -> torch.Tensor:
    """uint8/float, gray or rgb(a) -> float32 gray in [0, 1].

    A numpy array stays on the CPU (the caller moves it); a tensor keeps
    its device."""
    x = torch.as_tensor(np.asarray(image) if not torch.is_tensor(image)
                        else image)
    if x.dtype == torch.uint8:
        x = x.to(torch.float32) / 255.0
    else:
        x = x.to(torch.float32)
    if x.dim() == 3:
        x = rgb_to_gray(x)
    return x
