"""A-contrario RANSAC (ORSA / NFA-based model selection).

Twin of ``sara_tpu/ransac/orsa.py``: instead of a fixed inlier threshold,
each hypothesis selects the inlier count k that minimizes the Number of
False Alarms

    NFA(model, k) = N_models * C(n, k) * C(k, s) * alpha_k^(k - s)

where alpha_k is the probability that a random correspondence has residual
below the k-th smallest one. Residuals are sorted per hypothesis and the
NFA is evaluated for every k in one batched pass.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from sara_tpu_torch.ops.smallmat import select
from sara_tpu_torch.ransac.engine import hypotheses


class OrsaResult(NamedTuple):
    model: torch.Tensor
    inliers: torch.Tensor
    num_inliers: torch.Tensor
    log_nfa: torch.Tensor
    success: torch.Tensor


def _log_comb(n, k):
    """log C(n, k) via lgamma, elementwise."""
    return (torch.lgamma(n + 1.0) - torch.lgamma(k + 1.0)
            - torch.lgamma(n - k + 1.0))


def orsa(generator, data, data_mask, solver: Callable, residual: Callable,
         sample_size: int, num_samples: int, alpha0: float,
         max_threshold: float, log_nfa_max: float = 0.0) -> OrsaResult:
    """A-contrario robust estimation (engine conventions of ``ransac``).

    Args:
      alpha0: probability that a random point falls within residual 1 of
        the model (e.g. 2/area for epipolar bands of unit half-width).
      max_threshold: residuals above this never count as inliers.
      log_nfa_max: accept only models with log10(NFA) below this.
    """
    n = data_mask.shape[0]
    models, valid = hypotheses(generator, data, data_mask, solver,
                               sample_size, num_samples)
    ks = torch.arange(1, n + 1, dtype=torch.float32,
                      device=data_mask.device)              # candidate k
    s_f = float(sample_size)
    ln10 = math.log(10.0)

    r = residual(models, data)                              # (H, N)
    r_sorted = torch.sort(torch.where(data_mask, r, torch.inf), dim=-1).values
    alpha = torch.clamp(alpha0 * r_sorted, 1e-12, 1.0)
    lognfa = (math.log10(float(num_samples))
              + _log_comb(torch.full_like(ks, float(n)), ks) / ln10
              + _log_comb(ks, torch.full_like(ks, s_f)) / ln10
              + (ks - s_f) * torch.log10(alpha))
    bad = (ks <= s_f) | (r_sorted > max_threshold)
    lognfa = torch.where(bad, torch.inf, lognfa)
    best_k = torch.argmin(lognfa, dim=-1, keepdim=True)
    nfas = torch.where(valid, torch.gather(lognfa, -1, best_k)[:, 0],
                       torch.inf)
    thrs = torch.gather(r_sorted, -1, best_k)[:, 0]

    b = torch.argmin(nfas)
    inliers = (select(r, b) <= select(thrs, b)) & data_mask
    log_nfa = select(nfas, b)
    return OrsaResult(model=select(models, b), inliers=inliers,
                      num_inliers=torch.sum(inliers.to(torch.int32)),
                      log_nfa=log_nfa, success=log_nfa < log_nfa_max)
