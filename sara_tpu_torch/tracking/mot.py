"""Multiple-object tracking: KF tracks + assignment + lifecycle.

Twin of ``sara_tpu/tracking/mot.py`` (reference:
cpp/src/DO/Sara/MultipleObjectTracking/*.hpp — noise models and a cosine
re-ID distance; the SORT-style tracker loop is the twin's). Cost = IoU
(+ optional appearance cosine distance), optimal assignment by scipy's
Hungarian solver on the host, the same lifecycle as the twin.

The twin predicts and updates one track at a time and reads each track's
box back on its own. Here the tracks' states live stacked on the device,
``(T, 8)`` means and ``(T, 8, 8)`` covariances: one batched predict and
one batched update of the matched rows per step, the same arithmetic in
float32. A step reads the device twice at most: the predicted boxes once
(when there are tracks and detections to associate) and the confirmed
tracks' boxes once (when there are any).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from sara_tpu_torch import resolve_device
from sara_tpu_torch.tracking.kalman import (
    GaussianState, constant_velocity_box_model, kf_predict, kf_update)
from sara_tpu_torch.utils.host import fetch, put


def iou_matrix(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """IoU between (N, 4) and (M, 4) boxes in (cx, cy, w, h)."""

    def to_xyxy(b):
        return np.stack([b[:, 0] - b[:, 2] / 2, b[:, 1] - b[:, 3] / 2,
                         b[:, 0] + b[:, 2] / 2, b[:, 1] + b[:, 3] / 2], axis=1)

    A = to_xyxy(np.asarray(boxes_a))
    B = to_xyxy(np.asarray(boxes_b))
    x1 = np.maximum(A[:, None, 0], B[None, :, 0])
    y1 = np.maximum(A[:, None, 1], B[None, :, 1])
    x2 = np.minimum(A[:, None, 2], B[None, :, 2])
    y2 = np.minimum(A[:, None, 3], B[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area_a = (A[:, 2] - A[:, 0]) * (A[:, 3] - A[:, 1])
    area_b = (B[:, 2] - B[:, 0]) * (B[:, 3] - B[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / np.maximum(union, 1e-9)


def cosine_distance(feat_a: np.ndarray, feat_b: np.ndarray) -> np.ndarray:
    """Appearance re-ID distance (reference: MultipleObjectTracking cosine
    distance)."""
    norm = lambda f: np.maximum(np.linalg.norm(f, axis=1, keepdims=True),
                                1e-9)
    a = feat_a / norm(feat_a)
    b = feat_b / norm(feat_b)
    return 1.0 - a @ b.T


@dataclass
class Track:
    """One track's bookkeeping. ``state`` views the track's row of the
    tracker's stacked state (valid until the tracker's next step)."""

    track_id: int
    state: Optional[GaussianState] = None
    hits: int = 1
    misses: int = 0
    age: int = 1
    feature: Optional[np.ndarray] = None


class MultiObjectTracker:
    def __init__(self, iou_threshold: float = 0.3, max_misses: int = 5,
                 min_hits: int = 3, dt: float = 1.0,
                 appearance_weight: float = 0.0,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.model = constant_velocity_box_model(dt=dt, q=1.0, r=1.0,
                                                 device=self.device)
        self.iou_threshold = iou_threshold
        self.max_misses = max_misses
        self.min_hits = min_hits
        self.appearance_weight = appearance_weight
        self.tracks: List[Track] = []
        self._next_id = 0
        f32 = dict(dtype=torch.float32, device=self.device)
        self._x = torch.zeros((0, 8), **f32)     # stacked means
        self._P = torch.zeros((0, 8, 8), **f32)  # stacked covariances
        self._P0 = torch.eye(8, **f32) * 10.0
        self.syncs = 0                           # device reads so far

    def _rows(self, rows) -> torch.Tensor:
        return put(np.asarray(rows, np.int64), self.device)

    def step(self, boxes: np.ndarray, features: Optional[np.ndarray] = None):
        """One tracking step with (N, 4) detections (cx, cy, w, h).

        Returns list of (track_id, box) for confirmed tracks."""
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)

        # Predict all tracks (one batched program).
        if self.tracks:
            st = kf_predict(GaussianState(self._x, self._P), self.model)
            self._x, self._P = st.x, st.P
        for t in self.tracks:
            t.age += 1

        # Associate.
        matched_t, matched_d = set(), set()
        if self.tracks and len(boxes):
            (pred,) = fetch(self._x[:, :4])
            self.syncs += 1
            cost = 1.0 - iou_matrix(pred, boxes)
            if self.appearance_weight > 0 and features is not None:
                tf = np.stack([t.feature if t.feature is not None
                               else np.zeros(features.shape[1])
                               for t in self.tracks])
                w = self.appearance_weight
                cost = (1 - w) * cost + w * cosine_distance(tf, features)
            from scipy.optimize import linear_sum_assignment

            rows, cols = linear_sum_assignment(cost)
            ur, uc = [], []
            for r, c in zip(rows, cols):
                if 1.0 - cost[r, c] >= self.iou_threshold or (
                        self.appearance_weight > 0 and cost[r, c] < 0.5):
                    t = self.tracks[r]
                    t.hits += 1
                    t.misses = 0
                    if features is not None:
                        t.feature = features[c]
                    matched_t.add(r)
                    matched_d.add(c)
                    ur.append(r)
                    uc.append(c)
            if ur:
                # One batched update of the matched rows.
                r_dev = self._rows(ur)
                post, _, _ = kf_update(
                    GaussianState(self._x[r_dev], self._P[r_dev]),
                    self.model, put(boxes[uc], self.device))
                self._x = self._x.index_copy(0, r_dev, post.x)
                self._P = self._P.index_copy(0, r_dev, post.P)

        # Unmatched tracks age out; unmatched detections spawn tracks.
        for i, t in enumerate(self.tracks):
            if i not in matched_t:
                t.misses += 1
        alive = [i for i, t in enumerate(self.tracks)
                 if t.misses <= self.max_misses]
        if len(alive) < len(self.tracks):
            a_dev = self._rows(alive)
            self._x, self._P = self._x[a_dev], self._P[a_dev]
            self.tracks = [self.tracks[i] for i in alive]
        new = [c for c in range(len(boxes)) if c not in matched_d]
        if new:
            x0 = np.concatenate([boxes[new], np.zeros((len(new), 4),
                                                      np.float32)], axis=1)
            self._x = torch.cat([self._x, put(x0, self.device)])
            self._P = torch.cat([self._P, self._P0.expand(len(new), 8, 8)])
            for c in new:
                self.tracks.append(Track(
                    self._next_id,
                    feature=features[c] if features is not None else None))
                self._next_id += 1
        for r, t in enumerate(self.tracks):
            t.state = GaussianState(self._x[r], self._P[r])

        confirmed = [r for r, t in enumerate(self.tracks)
                     if t.hits >= self.min_hits]
        if not confirmed:
            return []
        (xs,) = fetch(self._x[self._rows(confirmed), :4])
        self.syncs += 1
        return [(self.tracks[r].track_id, xs[k])
                for k, r in enumerate(confirmed)]
