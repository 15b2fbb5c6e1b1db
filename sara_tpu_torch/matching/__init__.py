"""Descriptor matching (twin of ``sara_tpu/matching``): the brute-force
matcher and match propagation; ``ncc`` and ``key_proximity`` are imported
by module, as in the twin."""

from sara_tpu_torch.matching.brute_force import match_descriptors, MatchParams
from sara_tpu_torch.matching.propagation import (
    PropagationParams,
    match_consistency_matrix,
    propagate_matches,
)

__all__ = [
    "match_descriptors",
    "MatchParams",
    "PropagationParams",
    "match_consistency_matrix",
    "propagate_matches",
]
