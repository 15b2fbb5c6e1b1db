"""Descriptor matching (twin of ``sara_tpu/matching``, the slice's part)."""

from sara_tpu_torch.matching.brute_force import match_descriptors, MatchParams

__all__ = ["match_descriptors", "MatchParams"]
