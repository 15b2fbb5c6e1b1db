"""Batched RANSAC: all hypotheses evaluated at once.

Twin of ``sara_tpu/ransac/engine.py``. All minimal samples are drawn up
front, the solver runs on the whole batch of samples, every hypothesis is
scored in one batched residual call, and the best one is an argmax: there
is no early exit and no host sync, so on the card one call is one stream of
launches.

The engine is generic over (solver, residual) callables:
  solver(samples) -> (models (..., S, M, ...), model_valid (..., S, M)),
    where samples is the data tuple gathered to (..., S, sample_size, d);
  residual(models, data) -> (..., H, N) residuals of the hypotheses
    (..., H, ...) against data whose rows carry a hypothesis axis of one,
    (..., 1, N, d).

Data may carry leading batch dimensions (...): a batch of independent
problems (the pairs of a global-SfM chunk, where the reference ``vmap``s
over pairs) draws its samples in one ``torch.multinomial`` call and runs as
one program, each problem keeping its own best hypothesis.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from sara_tpu_torch.ops.smallmat import take


class RansacResult(NamedTuple):
    model: torch.Tensor        # best model parameters
    inliers: torch.Tensor      # (N,) bool inlier mask (includes data mask)
    num_inliers: torch.Tensor  # scalar int32
    success: torch.Tensor      # scalar bool


def ransac_num_samples(inlier_ratio: float, sample_size: int,
                       confidence: float = 0.99) -> int:
    """Classic adaptive sample count (a host-side helper; the engine uses
    a fixed batch)."""
    inlier_ratio = min(max(inlier_ratio, 1e-8), 1 - 1e-12)
    p_good = inlier_ratio ** sample_size
    return int(math.ceil(math.log(1 - confidence)
                         / math.log(1 - p_good + 1e-300)))


def draw_samples(generator: torch.Generator, num_samples: int,
                 sample_size: int, mask: torch.Tensor):
    """(..., S, k) random indices over the valid data rows of each problem,
    drawn with replacement from ``generator`` (on the mask's device) in one
    call; samples holding a repeated index are flagged invalid. ``mask`` is
    (..., N). Returns (idx (..., S, k) int64, ok (..., S) bool).

    A problem whose mask is all False draws uniformly (every hypothesis
    then scores 0)."""
    n = mask.shape[-1]
    probs = mask.to(torch.float32)
    probs = torch.where(probs.sum(dim=-1, keepdim=True) > 0, probs,
                        torch.ones_like(probs))
    idx = torch.multinomial(probs.reshape(-1, n),
                            num_samples * sample_size, replacement=True,
                            generator=generator)
    idx = idx.reshape(mask.shape[:-1] + (num_samples, sample_size)).clamp(
        max=n - 1)
    eq = idx[..., :, None] == idx[..., None, :]
    dup = torch.sum(eq.to(torch.int32), dim=(-2, -1)) > sample_size
    return idx, ~dup


def _gather_rows(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of a (..., N, d) at idx (..., S, k): (..., S, k, d)."""
    lead = idx.shape[:-2]
    flat = idx.reshape(lead + (-1, 1)).expand(lead + (-1, a.shape[-1]))
    return a.gather(-2, flat).reshape(idx.shape + a.shape[-1:])


def hypotheses(generator, data, data_mask, solver: Callable,
               sample_size: int, num_samples: int):
    """Draw the samples and solve them: flat models (..., S*M, ...) and
    their validity (..., S*M)."""
    idx, sample_ok = draw_samples(generator, num_samples, sample_size,
                                  data_mask)
    models, model_valid = solver(tuple(_gather_rows(a, idx) for a in data))
    model_valid = model_valid & sample_ok[..., None]
    lead = model_valid.shape[:-2]
    flat = lead + (-1,)
    return (models.reshape(flat + models.shape[len(lead) + 2:]),
            model_valid.reshape(flat))


def ransac(generator: torch.Generator, data, data_mask: torch.Tensor,
           solver: Callable, residual: Callable, sample_size: int,
           num_samples: int, threshold: float,
           min_inliers: int = 0) -> RansacResult:
    """Run batched RANSAC.

    Args:
      generator: random source of the samples, on the data's device.
      data: tuple of tensors (..., N, d) (correspondences).
      data_mask: (..., N) validity of data rows.
      solver: minimal solver over a batch of samples (see module doc).
      residual: (models, data) -> (..., H, N) residuals in threshold units.
      sample_size, num_samples: ints.
      threshold: inlier threshold.
      min_inliers: success requires at least this many inliers.

    Returns a RansacResult whose fields carry the data's leading dims.
    """
    models, valid = hypotheses(generator, data, data_mask, solver,
                               sample_size, num_samples)
    rows = tuple(a.unsqueeze(-3) for a in data)
    inl = ((residual(models, rows) < threshold)
           & data_mask.unsqueeze(-2))                        # (..., H, N)
    counts = torch.where(valid, torch.sum(inl.to(torch.int32), dim=-1), -1)
    best = torch.argmax(counts, dim=-1)   # first maximum, as jnp.argmax
    inliers = take(inl, best)
    n_inl = torch.sum(inliers.to(torch.int32), dim=-1)
    success = (take(counts, best) > 0) & (n_inl >= min_inliers)
    return RansacResult(take(models, best), inliers, n_inl, success)
