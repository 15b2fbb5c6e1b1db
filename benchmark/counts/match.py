"""Work of one matched pair: the distance product over the valid rows
(2 D operations per entry), the norms' additions and the clamp (3 per
entry), the best-two and the column minimum (3 comparisons per entry), the
ratio test and the mutual check (4 per row). Bytes: both descriptor sets
and masks read once (4 D + 1 per row), and per row of the first set the
matched index, the flag and the distance written once (13 bytes)."""

from __future__ import annotations


def pair_work(nn: float, na: float, nb: float, D: int = 128):
    """(operations, bytes) of a pair with ``na`` and ``nb`` valid rows,
    ``nn`` = na * nb."""
    ops = (2 * D + 6) * nn + 4 * na
    return float(ops), float((4 * D + 1) * (na + nb) + 13 * na)
