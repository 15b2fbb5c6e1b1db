"""I/O (twin of ``sara_tpu/io``, the ported part: images, video and
checkpoints of the incremental SfM state)."""

from sara_tpu_torch.io.image import imread, imwrite, imread_gray
from sara_tpu_torch.io.video import VideoStream, VideoWriter
from sara_tpu_torch.io.checkpoint import save_sfm_state, load_sfm_state

__all__ = ["imread", "imwrite", "imread_gray", "VideoStream", "VideoWriter",
           "save_sfm_state", "load_sfm_state"]
