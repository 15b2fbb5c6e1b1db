"""I/O (twin of ``sara_tpu/io``, the ported part: checkpoints of the
incremental SfM state)."""

from sara_tpu_torch.io.checkpoint import save_sfm_state, load_sfm_state

__all__ = ["save_sfm_state", "load_sfm_state"]
