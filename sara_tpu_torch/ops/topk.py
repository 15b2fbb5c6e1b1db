"""Bucketed approximate top-k for sparse score maps.

Twin of ``sara_tpu/ops/topk.py``. ``bucketed_top_k`` keeps the reference's
bucket rule exactly (reduce each of B buckets to its max and argmax, then
take the exact top-k of the bucket maxima), so both packages select the same
candidates. ``chunked_top_k`` is one ``torch.topk``: the reference split
large k into passes of at most 1024 only to dodge a TPU runtime fault.
Both select along the last dim; leading dims are independent rows (the
frames of a batch), each selected as the reference's ``vmap`` selects it.
"""

from __future__ import annotations

import torch


def chunked_top_k(score: torch.Tensor, k: int):
    """Exact top-k along the last dim of ``score`` (..., N): (values
    (..., k), indices (..., k)), sorted descending like ``lax.top_k``."""
    k = min(k, score.shape[-1])
    return torch.topk(score, k, dim=-1, sorted=True)


def bucketed_top_k(score: torch.Tensor, k: int,
                   num_buckets: int | None = None):
    """Approximate top-k along the last dim of a score tensor.

    Args:
      score: (..., N) float scores (use -inf for invalid entries); each
        row of the leading dims is selected on its own.
      k: number of results.
      num_buckets: bucket count (default: max(8k, 4096) clamped to N).

    Returns (values (..., k), indices (..., k)), approximately the top k.
    """
    n = score.shape[-1]
    if num_buckets is None:
        num_buckets = max(8 * k, 4096)
    if n <= max(4 * k, 16384) or num_buckets >= n:
        return chunked_top_k(score, min(k, n))

    b = num_buckets
    per = -(-n // b)  # ceil
    pad = b * per - n
    lead = score.shape[:-1]
    s = torch.cat([score, score.new_full(lead + (pad,), float("-inf"))],
                  dim=-1)
    s = s.reshape(lead + (b, per))
    bucket_arg = torch.argmax(s, dim=-1)   # first maximum, like jnp.argmax
    bucket_max = s.gather(-1, bucket_arg[..., None])[..., 0]
    vals, bidx = chunked_top_k(bucket_max, k)
    idx = bidx * per + bucket_arg.gather(-1, bidx)
    idx = torch.clamp(idx, max=n - 1)
    return vals, idx
