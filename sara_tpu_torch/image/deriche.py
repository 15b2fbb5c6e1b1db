"""Deriche recursive (IIR) Gaussian smoothing.

Twin of ``sara_tpu/image/deriche.py`` (reference:
cpp/src/DO/Sara/ImageProcessing/Deriche.hpp): an O(1)-per-pixel smoother
whose cost is independent of sigma.

The twin runs each 2nd-order pass as a ``lax.scan`` over the rows with the
row as a vector. The port loops over the rows on the device the same way:
one step updates a whole row. The feed-forward part of each pass
(``a0 x[n] + a1 x[n-1]``, ``c1 x[n+1] + c2 x[n+2]``) has no recursion and
is computed for all rows at once; the causal pass and the anticausal pass
(run on the reversed rows) share their feedback coefficients, so one loop
steps both, stacked. A step is two launches, ``s = u + b1 s1`` and
``s += b2 s2``, in the twin's order of operations. A call of an (H, W)
image with ``pad = int(4 sigma) + 4`` is ``2 (H + 2 pad) + 2 (W + 2 pad)``
step launches plus a few dozen for the padding, the feed-forward parts and
the sums (2,361 at 480x640, sigma 2). The column pass runs on the
transpose. Each function runs where its input tensor lies; a host array
goes to the card.
"""

from __future__ import annotations

import math

import torch

from sara_tpu_torch.utils.host import as_tensor


def _deriche_coeffs(sigma: float, dtype):
    """Deriche's 2nd-order smoothing coefficients, rounded to ``dtype``."""
    alpha = 1.695 / float(sigma)
    ea = math.exp(-alpha)
    e2a = math.exp(-2.0 * alpha)
    k = (1.0 - ea) ** 2 / (1.0 + 2.0 * alpha * ea - e2a)
    # Causal: y[n] = a0 x[n] + a1 x[n-1] + b1 y[n-1] + b2 y[n-2]
    a0 = k
    a1 = k * ea * (alpha - 1.0)
    b1 = 2.0 * ea
    b2 = -e2a
    # Anticausal: y[n] = c1 x[n+1] + c2 x[n+2] + b1 y[n+1] + b2 y[n+2]
    c1 = k * ea * (alpha + 1.0)
    c2 = -k * e2a
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    return tuple(float(np_dtype.type(v)) for v in (a0, a1, b1, b2, c1, c2))


def _recurse(u: torch.Tensor, b1: float, b2: float) -> torch.Tensor:
    """s[n] = u[n] + b1 s[n-1] + b2 s[n-2] along axis 0, s[-1] = s[-2] = 0:
    one step per row, each over the whole (..., M) row."""
    N = u.shape[0]
    s = torch.zeros((N + 2,) + tuple(u.shape[1:]), dtype=u.dtype,
                    device=u.device)
    for n in range(N):
        torch.add(u[n], s[n + 1], alpha=b1, out=s[n + 2])
        s[n + 2].add_(s[n], alpha=b2)
    return s[2:]


def _smooth_axis0(x: torch.Tensor, coeffs, pad: int) -> torch.Tensor:
    """Causal + anticausal pass along axis 0 of (N, M), the ends
    edge-replicated by ``pad`` rows."""
    a0, a1, b1, b2, c1, c2 = coeffs
    xp = torch.cat([x[:1].expand(pad, -1), x, x[-1:].expand(pad, -1)], 0)
    u = a0 * xp                               # causal: a0 x[n] + a1 x[n-1]
    u[1:].add_(xp[:-1], alpha=a1)
    r = xp.flip(0)                            # anticausal, in reversed time
    v = torch.zeros_like(r)                   # c1 r[k-1] + c2 r[k-2]
    v[1:] = c1 * r[:-1]
    v[2:].add_(r[:-2], alpha=c2)
    s = _recurse(torch.stack([u, v], 1), b1, b2)
    y = s[:, 0] + s[:, 1].flip(0)
    return y[pad:-pad]


def deriche_blur(image, sigma: float) -> torch.Tensor:
    """Deriche-smoothed image, separable in x then y.

    Borders are edge-replicated by ~4 sigma before each pass so the IIR
    warm-up transient (the filter starts from zero state) stays outside the
    output.
    """
    image = as_tensor(image)
    coeffs = _deriche_coeffs(sigma, image.dtype)
    pad = int(4 * float(sigma)) + 4
    y = _smooth_axis0(image, coeffs, pad)                            # rows
    y = _smooth_axis0(y.t().contiguous(), coeffs, pad).t()           # cols
    return y.contiguous()
