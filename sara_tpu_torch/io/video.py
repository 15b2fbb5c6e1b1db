"""Video decode/encode (twin of ``sara_tpu/io/video.py``).

OpenCV's VideoCapture / VideoWriter, imported inside each method (a
machine without cv2 imports the package and fails only when it opens a
video): frame skipping and display-rotation metadata as in the twin. Host
NumPy frames in and out.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np


class VideoStream:
    """Iterate video frames as RGB uint8 arrays, with frame skipping."""

    def __init__(self, path: str, num_skips: int = 0,
                 apply_rotation: bool = True):
        import cv2

        self._cap = cv2.VideoCapture(path)
        if not self._cap.isOpened():
            raise IOError(f"cannot open video: {path}")
        self.num_skips = num_skips
        self.frame_index = -1
        # Display-rotation metadata (phone videos): the reference rotates
        # frames by the stream's rotation angle (VideoStream.hpp:40-93,
        # FrameRotater). OpenCV >= 4.5 exposes it; fall back to 0.
        self.rotation_angle = 0
        self._apply_rotation = apply_rotation
        try:
            meta = self._cap.get(cv2.CAP_PROP_ORIENTATION_META)
            if meta == meta and meta is not None:  # not NaN
                self.rotation_angle = int(meta) % 360
            # Let cv2 auto-rotate if it supports it; then frames arrive
            # already upright and we must not rotate twice.
            if self._cap.get(cv2.CAP_PROP_ORIENTATION_AUTO) == 1.0:
                self._apply_rotation = False
        except Exception:
            pass

    def _rotate(self, frame):
        import cv2

        if not self._apply_rotation or self.rotation_angle == 0:
            return frame
        code = {90: cv2.ROTATE_90_CLOCKWISE, 180: cv2.ROTATE_180,
                270: cv2.ROTATE_90_COUNTERCLOCKWISE}.get(self.rotation_angle)
        return cv2.rotate(frame, code) if code is not None else frame

    @property
    def sizes(self):
        import cv2

        h = int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        w = int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        return h, w

    @property
    def fps(self) -> float:
        import cv2

        return float(self._cap.get(cv2.CAP_PROP_FPS))

    def read(self) -> Optional[np.ndarray]:
        """Next (non-skipped) frame as RGB, or None at end of stream
        (reference: VideoStreamer::read with num_frames_to_skip)."""
        import cv2

        for _ in range(self.num_skips + 1):
            ok, frame = self._cap.read()
            if not ok:
                return None
            self.frame_index += 1
        return self._rotate(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            f = self.read()
            if f is None:
                return
            yield f

    def close(self):
        self._cap.release()


class VideoWriter:
    def __init__(self, path: str, sizes, fps: float = 30.0):
        import cv2

        h, w = sizes
        fourcc = cv2.VideoWriter_fourcc(*"mp4v")
        self._w = cv2.VideoWriter(path, fourcc, fps, (w, h))

    def write(self, frame_rgb: np.ndarray):
        import cv2

        self._w.write(cv2.cvtColor(np.asarray(frame_rgb), cv2.COLOR_RGB2BGR))

    def close(self):
        self._w.release()
