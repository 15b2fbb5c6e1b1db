"""Share of the matcher's distance cells that lie between two kept
keypoints: the program's counters ``match.cells_valid`` over
``match.cells`` (masked slots and padded pairs are the rest)."""
from benchmark.metrics._program import share


def read(ctx):
    return share(ctx, "match.cells_valid", "match.cells")
