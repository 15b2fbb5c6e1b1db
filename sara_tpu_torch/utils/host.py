"""Host-device transfers that wait as little as possible.

Each ``.cpu()`` of a CUDA tensor waits for the device; a stage that needs
several tensors on the host brings them over with :func:`fetch`, which
costs one wait whatever their number (the reference batches its fetches
the same way with one ``jax.device_get`` per stage). A plain copy of host
memory to the card waits for the device's queue too; :func:`put` stages
it in pinned memory and copies it asynchronously instead.
"""

from __future__ import annotations

import numpy as np
import torch

from sara_tpu_torch import resolve_device


def fetch(*tensors):
    """Bring tensors to the host in ONE device-to-host transfer: flattened
    into one float64 buffer (exact for float32, float64, int32 and bool
    values), then split and cast back. Returns numpy arrays of the
    tensors' own dtypes."""
    flat = torch.cat([t.detach().reshape(-1).to(torch.float64)
                      for t in tensors]).cpu().numpy()
    out, at = [], 0
    for t in tensors:
        n = t.numel()
        a = flat[at:at + n].reshape(tuple(t.shape))
        at += n
        dtype = torch.empty((), dtype=t.dtype).numpy().dtype
        if t.dtype == torch.bool:
            a = a != 0
        elif not t.dtype.is_floating_point:
            a = np.rint(a).astype(dtype)
        else:
            a = a.astype(dtype)
        out.append(a)
    return out


def put(a, device) -> torch.Tensor:
    """``a`` (a numpy array or a tensor) on ``device``. To a CUDA device
    from the host the copy goes through pinned memory without waiting (the
    caching host allocator keeps the pinned block until the copy is done);
    anything else is a plain ``.to``."""
    t = a if torch.is_tensor(a) else torch.from_numpy(np.ascontiguousarray(a))
    device = torch.device(device)
    if device.type != "cuda" or t.is_cuda:
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def as_tensor(a, dtype=np.float32, device=None) -> torch.Tensor:
    """``a`` as a tensor: a tensor stays on its device (or moves to
    ``device`` when one is given); a host array, cast to ``dtype``, goes to
    ``device`` through :func:`put` (None: the card, which raises without
    one)."""
    if isinstance(a, torch.Tensor):
        return a if device is None else a.to(device)
    return put(np.asarray(a, dtype), resolve_device(device))
