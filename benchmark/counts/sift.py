"""Work of one SIFT frame on the default branch (first octave -1, S = 3,
float32), counted as Lowe's SIFT needs it.

- Pyramid: the x2 bilinear upsample (8 operations per output pixel), the
  first blur, and per octave the five incremental separable blurs (two
  passes, a multiply-add per tap), the five DoG differences and the
  26-neighbour extremum test (52 comparisons) on the three inner levels.
- Per keypoint: two Newton steps and the final one (about 120 operations
  each), the orientation histogram over its window of radius
  ceil(4.5 sigma) at the octave's median sigma (a gradient, its magnitude
  and angle, a weight and a bin: 40 operations per pixel) with six
  circular smoothings of 36 bins, and the descriptor over a 16 x 16 grid
  (50 operations per sample, trilinear into 4 x 4 x 8 bins) with its
  normalisation (6 operations per bin).
- Bytes: the (H, W) float32 frame read once; per keypoint its position,
  scale, orientation, response, 128-float descriptor and mask written
  once (533 bytes).
"""

from __future__ import annotations

import math

S = 3
SIGMA0 = 1.6


def _taps(sigma):
    return 2 * max(1, math.ceil(4 * sigma)) + 1


def _octave_sizes(h, w):
    h, w = 2 * h, 2 * w
    n = int(math.floor(math.log2(min(h, w) / 16.0))) + 1
    sizes = []
    for _ in range(max(1, n)):
        sizes.append((h, w))
        h, w = (h + 1) // 2, (w + 1) // 2
        if min(h, w) < 16:
            break
    return sizes


def frame_work(hw, n_kp: float):
    """(operations, bytes) of one (H, W) frame with ``n_kp`` keypoints."""
    H, W = hw
    k = 2.0 ** (1.0 / S)
    incr = [SIGMA0 * k ** (s - 1) * math.sqrt(k * k - 1) for s in range(1, 6)]
    per_px = 4 * sum(_taps(s) for s in incr) + 5 + 3 * 52
    sizes = _octave_sizes(H, W)
    ops = 8 * 4 * H * W + 4 * _taps(math.sqrt(SIGMA0 ** 2 - 1.0)) * 4 * H * W
    ops += sum(per_px * h * w for h, w in sizes)
    r = math.ceil(4.5 * SIGMA0 * k)
    per_kp = (3 * 120 + 40 * (2 * r + 1) ** 2 + 6 * 36 * 3
              + 50 * 256 + 6 * 128)
    ops += per_kp * n_kp
    return float(ops), float(4 * H * W + 533 * n_kp)
