"""Plain SIFT of one frame: the reference the benchmark holds the port to.

A frozen, plain restatement of the SIFT that the port computes by default
(float32, orientation maps at stride 1, descriptors sampled nearest from
the blurred orientation field, first octave -1, capacity 8192), one frame
at a time and one plain PyTorch operation after another. It imports
nothing of the program. Its steps and constants:

- pyramid: bilinear x2 upsample (half-pixel centres), blur from 2 x 0.5 to
  1.6, per octave S + 3 = 6 Gaussians by an incremental cascade of
  separable convolutions (taps to ceil(4 sigma), replicated borders), the
  next octave seeded by decimating level S; as many octaves as
  floor(log2(min(2H, 2W) / 16)) + 1 allows while a side keeps 16 pixels;
- detection per octave: strict 26-neighbour extrema of the DoG with
  |DoG| >= 0.8 x 0.01 one pixel inside the border, the strongest
  min(4096, max(64, 5 h w / 512)) by the bucket rule (the maximum of each
  of max(8k, 4096) buckets, then the exact top k of those maxima; the
  exact top k where the octave has at most max(4k, 16384) candidates), two
  Newton steps with integer re-centring past 0.6, a final step clamped to
  1.5 (rejected beyond), |value| >= 0.01, edge ratio 10;
- orientation: 36-bin magnitude maps per level blurred by 1.5 sigma (taps
  to ceil(3 x 1.5 sigma), not normalised), read bilinearly at the
  keypoint, six circular box-3 smoothings, up to two peaks at >= 0.8 of
  the maximum, parabola-refined;
- descriptors: each keypoint repeated per peak, the valid ones moved to
  the front (stable), k + k // 4 of them described: 4 x 4 bin centres at
  3 sigma spacing, rotated, each reading the nearest pixel of the 36-bin
  field, collapsed to 8 rotated bins with circular triangle weights, a
  Gaussian window of 2 bins, L2 normalised, clamped at 0.2, renormalised;
- merge: the strongest 8192 |responses| over all octaves.

Positions are in input pixels, scales are absolute sigmas. ``low``
switches TF32 on for its convolutions and matrix products: the control
that the benchmark's comparison has to reject. On the H100 it moves the
descriptors (the 36-to-8 bin collapse is a matrix product) and the
matcher's distances; the blurs, which cuDNN runs as grouped direct
convolutions, stay bit for bit.
"""

from __future__ import annotations

import math
from contextlib import contextmanager

import torch
import torch.nn.functional as F

S = 3
SIGMA_CAMERA = 0.5
SIGMA0 = 1.6
BORDER_OCTAVES = 8
THRESH = 0.01
EDGE_R = 10.0
REFINE = 2
OCT_CAP = 4096
TOTAL_CAP = 8192
PEAKS = 2


@contextmanager
def precision(low: bool):
    """Full float32 (TF32 off), or TF32 on for ``low``."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = low
    torch.backends.cudnn.allow_tf32 = low
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _sep_conv(x, taps):
    """Convolve each plane of x (N, H, W) with ``taps`` along rows, then
    columns, borders replicated."""
    r = (len(taps) - 1) // 2
    k = torch.tensor(taps, dtype=torch.float64).to(x.device, x.dtype)
    y = F.pad(x[:, None], (r, r, r, r), mode="replicate")
    y = F.conv2d(y, k.flip(0).view(1, 1, 1, -1))
    y = F.conv2d(y, k.flip(0).view(1, 1, -1, 1))
    return y[:, 0]


def _gauss_taps(sigma, truncate=4.0, normalise=True):
    r = max(1, int(math.ceil(truncate * sigma)))
    t = [math.exp(-(i * i) / (2.0 * sigma * sigma)) for i in range(-r, r + 1)]
    s = sum(t) if normalise else 1.0
    return [v / s for v in t]


def pyramid(img):
    """List of (S + 3, h, w) Gaussian octaves and their pixel scales."""
    H, W = img.shape
    x = F.interpolate(img[None, None], size=(2 * H, 2 * W), mode="bilinear",
                      align_corners=False)[0]
    delta = math.sqrt(max(SIGMA0 ** 2 - (2 * SIGMA_CAMERA) ** 2, 1e-6))
    x = _sep_conv(x, _gauss_taps(delta))[0]
    k = 2.0 ** (1.0 / S)
    n_oct = int(math.floor(math.log2(min(2 * H, 2 * W)
                                     / (2.0 * BORDER_OCTAVES)))) + 1
    octaves, scales = [], []
    for o in range(max(1, n_oct)):
        levels = [x]
        for s in range(1, S + 3):
            incr = SIGMA0 * k ** (s - 1) * math.sqrt(k * k - 1.0)
            levels.append(_sep_conv(levels[-1][None], _gauss_taps(incr))[0])
        octaves.append(torch.stack(levels))
        scales.append(2.0 ** (o - 1))
        x = octaves[-1][S, ::2, ::2]
        if min(x.shape) < 2 * BORDER_OCTAVES:
            break
    return octaves, scales


def _top_k_buckets(score, k):
    """The port's selection rule: exact top k of a short row, else the
    exact top k of bucket maxima (first maximum of each bucket)."""
    n = score.shape[0]
    nb = max(8 * k, 4096)
    if n <= max(4 * k, 16384) or nb >= n:
        return torch.topk(score, min(k, n))
    per = -(-n // nb)
    s = torch.cat([score, score.new_full((nb * per - n,), -math.inf)])
    s = s.view(nb, per)
    arg = s.argmax(dim=1)
    vals, b = torch.topk(s.max(dim=1).values, k)
    return vals, torch.clamp(b * per + arg[b], max=n - 1)


def detect(dog):
    """Refined extrema of one (S + 2, h, w) DoG octave: x, y, s, value,
    mask, each (k,)."""
    L, H, W = dog.shape
    cap = min(OCT_CAP, max(64, (L * H * W) // 512))
    pad = F.pad(dog[None], (1, 1, 1, 1), mode="replicate")[0]
    c = dog[1:-1]
    nmax = torch.full_like(c, -math.inf)
    nmin = torch.full_like(c, math.inf)
    for ds in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if ds or dy or dx:
                    sl = pad[1 + ds:L - 1 + ds, 1 + dy:1 + dy + H,
                             1 + dx:1 + dx + W]
                    nmax = torch.maximum(nmax, sl)
                    nmin = torch.minimum(nmin, sl)
    ok = (c > nmax) | (c < nmin)
    inner = torch.zeros((H, W), dtype=torch.bool, device=dog.device)
    inner[1:H - 1, 1:W - 1] = True
    ok = ok & (c.abs() >= 0.8 * THRESH) & inner
    score = torch.where(ok, c.abs(), torch.full_like(c, -1.0)).reshape(-1)
    k_eff = min(cap, score.shape[0])
    vals, idx = _top_k_buckets(score, k_eff)
    if k_eff < cap:
        vals = torch.cat([vals, vals.new_full((cap - k_eff,), -1.0)])
        idx = torch.cat([idx, idx.new_zeros(cap - k_eff)])
    valid = vals > 0
    s = idx // (H * W) + 1
    y = (idx % (H * W)) // W
    x = idx % W
    # Central differences with replicated borders, read at (s, y, x).
    pd = F.pad(dog[None, None], (1, 1, 1, 1, 1, 1), mode="replicate")[0, 0]

    def d(s, y, x, a, b, e):
        return pd[s + 1 + a, y + 1 + b, x + 1 + e]

    def newton(s, y, x):
        c0 = d(s, y, x, 0, 0, 0)
        g = torch.stack([0.5 * (d(s, y, x, 1, 0, 0) - d(s, y, x, -1, 0, 0)),
                         0.5 * (d(s, y, x, 0, 1, 0) - d(s, y, x, 0, -1, 0)),
                         0.5 * (d(s, y, x, 0, 0, 1) - d(s, y, x, 0, 0, -1))],
                        dim=-1)
        hss = d(s, y, x, 1, 0, 0) + d(s, y, x, -1, 0, 0) - 2 * c0
        hyy = d(s, y, x, 0, 1, 0) + d(s, y, x, 0, -1, 0) - 2 * c0
        hxx = d(s, y, x, 0, 0, 1) + d(s, y, x, 0, 0, -1) - 2 * c0
        hsy = 0.25 * (d(s, y, x, 1, 1, 0) - d(s, y, x, 1, -1, 0)
                      - d(s, y, x, -1, 1, 0) + d(s, y, x, -1, -1, 0))
        hsx = 0.25 * (d(s, y, x, 1, 0, 1) - d(s, y, x, 1, 0, -1)
                      - d(s, y, x, -1, 0, 1) + d(s, y, x, -1, 0, -1))
        hyx = 0.25 * (d(s, y, x, 0, 1, 1) - d(s, y, x, 0, 1, -1)
                      - d(s, y, x, 0, -1, 1) + d(s, y, x, 0, -1, -1))
        Hm = torch.stack([torch.stack([hss, hsy, hsx], -1),
                          torch.stack([hsy, hyy, hyx], -1),
                          torch.stack([hsx, hyx, hxx], -1)], -2)
        Hm = Hm + 1e-12 * torch.eye(3, device=dog.device)
        h = -torch.linalg.solve_ex(Hm, g[..., None])[0][..., 0]
        return c0, g, h, (hyy, hxx, hyx)

    done = torch.zeros_like(valid)
    for _ in range(REFINE):
        _, _, h, _ = newton(s, y, x)
        sy = torch.where(h[:, 1].abs() > 0.6, torch.sign(h[:, 1]),
                         torch.zeros_like(h[:, 1])).long()
        sx = torch.where(h[:, 2].abs() > 0.6, torch.sign(h[:, 2]),
                         torch.zeros_like(h[:, 2])).long()
        moved = (sy != 0) | (sx != 0)
        go = moved & ~done
        y = torch.clamp(y + torch.where(go, sy, 0), 1, H - 2)
        x = torch.clamp(x + torch.where(go, sx, 0), 1, W - 2)
        done = done | ~moved
    c0, g, h, (hyy, hxx, hyx) = newton(s, y, x)
    ok_step = h.abs().amax(dim=-1) <= 1.5
    h = torch.clamp(h, -1.5, 1.5)
    value = c0 + 0.5 * (g * h).sum(dim=-1)
    tr = hxx + hyy
    det = hxx * hyy - hyx * hyx
    valid = (valid & ok_step & (value.abs() >= THRESH)
             & ~(tr * tr * EDGE_R >= (EDGE_R + 1.0) ** 2 * det))
    return (x.float() + h[:, 2], y.float() + h[:, 1], s.float() + h[:, 0],
            value, valid)


def orientation_field(gauss, sigmas):
    """(S + 2, h, w, 36) blurred 36-bin gradient magnitude maps of the
    first S + 2 Gaussians of an octave."""
    g = gauss[:-1]
    gx = 0.5 * (torch.cat([g[..., 1:], g[..., -1:]], -1)
                - torch.cat([g[..., :1], g[..., :-1]], -1))
    gy = 0.5 * (torch.cat([g[..., 1:, :], g[..., -1:, :]], -2)
                - torch.cat([g[..., :1, :], g[..., :-1, :]], -2))
    mag = torch.sqrt(gx * gx + gy * gy)
    ori = torch.remainder(torch.atan2(gy, gx), 2 * math.pi)
    b = torch.remainder(torch.floor(ori / (2 * math.pi) * 36).long(), 36)
    out = []
    for i in range(g.shape[0]):
        dense = F.one_hot(b[i], 36).permute(2, 0, 1).float() * mag[i]
        taps = _gauss_taps(1.5 * sigmas[i], truncate=3.0, normalise=False)
        out.append(_sep_conv(dense, taps).permute(1, 2, 0))
    return torch.stack(out)


def orientations(field, x, y, s):
    """Up to two dominant orientations per keypoint: (theta (k, 2),
    valid (k, 2))."""
    L, H, W, _ = field.shape
    si = torch.clamp(torch.round(s).long(), 0, L - 1)
    xc = x.clamp(0.0, W - 1.0)
    yc = y.clamp(0.0, H - 1.0)
    x0, y0 = xc.floor().long(), yc.floor().long()
    x1, y1 = (x0 + 1).clamp(max=W - 1), (y0 + 1).clamp(max=H - 1)
    fx, fy = (xc - x0)[:, None], (yc - y0)[:, None]
    h = (field[si, y0, x0] * (1 - fx) * (1 - fy)
         + field[si, y0, x1] * fx * (1 - fy)
         + field[si, y1, x0] * (1 - fx) * fy + field[si, y1, x1] * fx * fy)
    for _ in range(6):
        h = (torch.roll(h, 1, -1) + h + torch.roll(h, -1, -1)) / 3.0
    left, right = torch.roll(h, 1, -1), torch.roll(h, -1, -1)
    top = h.amax(dim=-1, keepdim=True)
    peak = (h > left) & (h > right) & (h >= 0.8 * top) & (top > 0)
    vals, idx = torch.topk(torch.where(peak, h, torch.full_like(h, -1.0)),
                           PEAKS, dim=-1)
    hl, hc, hr = (torch.gather(a, -1, idx) for a in (left, h, right))
    den = hl - 2 * hc + hr
    off = torch.where(den.abs() > 1e-12, 0.5 * (hl - hr) / den,
                      torch.zeros_like(den))
    theta = (idx.float() + off + 0.5) / 36 * (2 * math.pi)
    return torch.remainder(theta + math.pi, 2 * math.pi) - math.pi, vals > 0


def descriptors(field, x, y, s, theta, sigmas):
    """(k, 128) descriptors read from the orientation field."""
    L, H, W, _ = field.shape
    si = torch.clamp(torch.round(s).long(), 0, L - 1)
    lam = 3.0 * torch.tensor(sigmas, dtype=torch.float32,
                             device=field.device)[si]
    u = torch.arange(4, dtype=torch.float32, device=field.device) - 1.5
    vv, uu = torch.meshgrid(u, u, indexing="ij")
    c, sn = torch.cos(theta)[:, None, None], torch.sin(theta)[:, None, None]
    xs = (x[:, None, None] + (c * uu - sn * vv) * lam[:, None, None])
    ys = (y[:, None, None] + (sn * uu + c * vv) * lam[:, None, None])
    xi = torch.round(xs.clamp(0.0, W - 1.0)).long().view(-1, 16)
    yi = torch.round(ys.clamp(0.0, H - 1.0)).long().view(-1, 16)
    samples = field[si[:, None], yi, xi]                    # (k, 16, 36)
    alpha = (torch.arange(36, dtype=torch.float32, device=field.device)
             + 0.5) * (2 * math.pi / 36)
    ob = (alpha[None, :] - theta[:, None]) / (2 * math.pi) * 8
    o = torch.arange(8, dtype=torch.float32, device=field.device)
    dist = (torch.remainder(ob[..., None] - o + 4, 8) - 4).abs()
    wo = torch.clamp(1.0 - dist, min=0.0)                   # (k, 36, 8)
    win = torch.exp(-(uu ** 2 + vv ** 2) / 8.0).reshape(1, 16, 1)
    d = (torch.einsum("knf,kfo->kno", samples, wo) * win).reshape(-1, 128)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True).clamp(min=1e-12)
    d = torch.clamp(d, max=0.2)
    return d / torch.linalg.vector_norm(d, dim=-1,
                                        keepdim=True).clamp(min=1e-12)


def sift(img, low: bool = False):
    """Keypoints of one (H, W) float32 frame: a dict of xy (8192, 2),
    scale, theta, response, desc (8192, 128) and mask (8192,)."""
    k = 2.0 ** (1.0 / S)
    sigmas = [SIGMA0 * k ** i for i in range(S + 3)]
    with precision(low):
        octaves, scales = pyramid(img.float())
        parts = []
        for gauss, scale in zip(octaves, scales):
            dog = gauss[1:] - gauss[:-1]
            x, y, s, val, mask = detect(dog)
            field = orientation_field(gauss, sigmas)
            th, tv = orientations(field, x, y, s)
            K = x.shape[0]
            x, y, s, val, mask = (a.repeat_interleave(PEAKS)
                                  for a in (x, y, s, val, mask))
            mask = mask & tv.reshape(-1)
            th = th.reshape(-1)
            order = torch.argsort((~mask).int(), stable=True)[:K + K // 4]
            x, y, s, val, th, mask = (a[order]
                                      for a in (x, y, s, val, th, mask))
            desc = descriptors(field, x, y, s, th, sigmas[:-1])
            parts.append({
                "xy": torch.stack([x, y], -1) * scale,
                "scale": SIGMA0 * torch.pow(torch.tensor(
                    k, dtype=torch.float32, device=img.device), s) * scale,
                "theta": th, "response": val, "desc": desc, "mask": mask})
        kp = {key: torch.cat([p[key] for p in parts]) for key in parts[0]}
        n = kp["mask"].shape[0]
        if n <= TOTAL_CAP:
            return {key: torch.cat([v, v.new_zeros((TOTAL_CAP - n,)
                                                   + v.shape[1:])])
                    for key, v in kp.items()}
        score = torch.where(kp["mask"], kp["response"].abs(),
                            torch.full_like(kp["response"], -math.inf))
        idx = torch.topk(score, TOTAL_CAP).indices
        return {key: v[idx] for key, v in kp.items()}
