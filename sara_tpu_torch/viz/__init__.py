"""Visualization (twin of ``sara_tpu/viz``, the slice's part: the
self-contained HTML point-cloud viewer that the odometry pipeline's live
view writes)."""

from sara_tpu_torch.viz.html_viewer import write_html_viewer

__all__ = ["write_html_viewer"]
