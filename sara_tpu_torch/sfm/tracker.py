"""Feature tracker: incremental tracks from inlier matches.

Twin of ``sara_tpu/sfm/tracker.py`` (NumPy + the native union-find of
``sfm/disjoint_sets.py``). Host-side rebuild of the reference's FeatureTracker
(reference: cpp/src/DO/Sara/SfM/Graph/FeatureTracker.cpp:21-190 — add inlier
matches as feature-graph edges, recompute connected components with
union-find, filter consistent tracks; FeatureGID = (pose vertex, feature
index), SfM/Graph/FeatureGraph.hpp:20-75).

Features get global ids ``offset[frame] + feature_index``; components come
from the native union-find. A *track* is a component with >= min_length
members after per-frame non-max suppression (strongest response per frame,
reference: PointCloudGenerator.cpp:47-93).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from sara_tpu_torch.sfm.disjoint_sets import (DisjointSets, dense_labels,
                                        make_tracker_core)


class FeatureTracker:
    def __init__(self):
        self.offsets: List[int] = []     # global id base per frame
        self.counts: List[int] = []
        self.responses: List[np.ndarray] = []
        self.edges_a: List[np.ndarray] = []
        self.edges_b: List[np.ndarray] = []
        self._total = 0
        # Cached results of the last compute_tracks() call.
        self.track_of_feature: np.ndarray | None = None
        self.num_tracks = 0
        # Stable identity: dense track ids are renumbered on every
        # compute_tracks() (components merge/shift), so long-lived state
        # (scene points) must key on the REPRESENTATIVE feature gid — the
        # minimum global feature id of the component, which is monotone
        # under merges (the reference instead keys its scene-point map by
        # feature vertex, PointCloudGenerator.hpp:25-173).
        self.component_of_feature: np.ndarray | None = None
        self.comp_min_gid: np.ndarray | None = None
        self.rep_of_track: np.ndarray | None = None
        # Persistent union-find (unions are monotone — only NEW edges are
        # applied per compute_tracks call; the structure is recreated with
        # doubled capacity and all edges replayed when features outgrow it,
        # amortized O(1)).
        self._uf: DisjointSets | None = None
        self._uf_edges_done = 0
        # Native incremental tracker core (union-find + per-(component,
        # frame) NMS maintained online; winner maps merge small-into-large
        # on union). Makes compute_tracks flat in sequence length; the
        # NumPy batch path below is the fallback + parity oracle.
        self._tk = None
        self._tk_frames_done = 0
        self._tk_edges_done = 0

    # -- construction -------------------------------------------------------

    def add_frame(self, num_features: int, responses: np.ndarray) -> int:
        """Register a frame's (valid) features; returns the frame id."""
        frame_id = len(self.offsets)
        self.offsets.append(self._total)
        self.counts.append(int(num_features))
        self.responses.append(np.asarray(responses, np.float32))
        self._total += int(num_features)
        return frame_id

    def add_matches(self, frame_a: int, frame_b: int,
                    ia: np.ndarray, ib: np.ndarray):
        """Add inlier matches (feature indices within each frame)."""
        ga = self.offsets[frame_a] + np.asarray(ia, np.int64)
        gb = self.offsets[frame_b] + np.asarray(ib, np.int64)
        self.edges_a.append(ga)
        self.edges_b.append(gb)

    def global_id(self, frame: int, idx) -> np.ndarray:
        return self.offsets[frame] + np.asarray(idx, np.int64)

    def frame_of(self, gid: np.ndarray) -> np.ndarray:
        """Frame index of each global feature id."""
        bounds = np.asarray(self.offsets + [self._total])
        return np.searchsorted(bounds, np.asarray(gid), side="right") - 1

    # -- track computation --------------------------------------------------

    def compute_tracks(self, min_length: int = 2):
        """Recompute connected components -> track labels.

        Returns (track_of_feature (N,) with -1 for untracked features,
        num_tracks). A component is a track if, after per-frame NMS, it still
        spans >= min_length distinct frames.

        Uses the native incremental core when available (flat per-frame
        cost); falls back to the batch NumPy path otherwise. Both produce
        bit-identical outputs (covered by the parity test).
        """
        n = self._total
        if n == 0:
            self.track_of_feature = np.empty(0, np.int64)
            self.num_tracks = 0
            self.component_of_feature = np.empty(0, np.int64)
            self.comp_min_gid = np.empty(0, np.int64)
            self.rep_of_track = np.empty(0, np.int64)
            return self.track_of_feature, 0
        core = self._ensure_core(n)
        if core is None:
            return self._compute_tracks_batch(min_length)
        for f in range(self._tk_frames_done, len(self.offsets)):
            core.add_features(f, self.responses[f])
        self._tk_frames_done = len(self.offsets)
        for e in range(self._tk_edges_done, len(self.edges_a)):
            core.union_edges(self.edges_a[e], self.edges_b[e])
        self._tk_edges_done = len(self.edges_a)
        out, labels, comp_min, reps, k, t = core.tracks(min_length)
        self.track_of_feature = out
        self.num_tracks = t
        self.component_of_feature = labels
        self.comp_min_gid = comp_min
        self.rep_of_track = reps
        return out, self.num_tracks

    def _ensure_core(self, n: int):
        """Native core sized for n features, replaying history after a
        rebuild (growth or checkpoint restore). None = use the batch path."""
        if len(self.responses) != len(self.offsets):
            return None  # misaligned state (legacy checkpoint): batch path
        if (self._tk is not None and self._tk.capacity >= n
                and self._tk_frames_done <= len(self.offsets)
                and self._tk_edges_done <= len(self.edges_a)):
            return self._tk
        core = make_tracker_core(max(2 * n, 1 << 16))
        self._tk = core
        self._tk_frames_done = 0
        self._tk_edges_done = 0
        return core

    def _compute_tracks_batch(self, min_length: int = 2):
        n = self._total
        # Persistent union-find: apply only the edge batches added since
        # the last call (full relabel-from-scratch grew linearly with
        # history — 155 ms/frame by frame 100 of a VO run).
        if self._uf is None or self._uf.n < n:
            self._uf = DisjointSets(max(2 * n, 1 << 16))
            self._uf_edges_done = 0
        for e in range(self._uf_edges_done, len(self.edges_a)):
            self._uf.union_edges(self.edges_a[e], self.edges_b[e])
        self._uf_edges_done = len(self.edges_a)
        labels, k = dense_labels(self._uf.components()[:n])

        frames = self.frame_of(np.arange(n))
        resp = np.concatenate(self.responses) if self.responses else np.empty(0)

        # Per-frame NMS within each component: keep the strongest |response|
        # feature of each (component, frame) pair. Integer composite key +
        # stable argsort + per-run argmax — ~2x the 3-key lexsort (the
        # float key forces mergesort passes), bit-identical output.
        F = len(self.offsets)
        key = labels * F + frames
        order = np.argsort(key, kind="stable")
        key_o = key[order]
        resp_o = np.abs(resp)[order]
        starts = np.ones(n, bool)
        starts[1:] = key_o[1:] != key_o[:-1]
        run_id = np.cumsum(starts) - 1
        run_max = np.maximum.reduceat(resp_o, np.nonzero(starts)[0])
        is_max = resp_o == run_max[run_id]
        idx_sorted = np.nonzero(is_max)[0]
        rid = run_id[idx_sorted]
        first_of_run = np.ones(len(idx_sorted), bool)
        first_of_run[1:] = rid[1:] != rid[:-1]
        kept = order[idx_sorted[first_of_run]]

        # Count distinct frames per component (over kept members).
        comp_sizes = np.bincount(labels[kept], minlength=k)
        good = comp_sizes >= min_length

        out = np.full(n, -1, np.int64)
        # Dense track ids over good components.
        remap = np.full(k, -1, np.int64)
        remap[good] = np.arange(int(good.sum()))
        out[kept] = remap[labels[kept]]
        self.track_of_feature = out
        self.num_tracks = int(good.sum())
        # Stable representatives: min gid per component (ALL members,
        # including NMS-dropped ones — stability must not depend on which
        # feature wins the per-frame NMS).
        comp_min = np.full(k, n, np.int64)
        np.minimum.at(comp_min, labels, np.arange(n, dtype=np.int64))
        self.component_of_feature = labels
        self.comp_min_gid = comp_min
        self.rep_of_track = comp_min[np.nonzero(good)[0]]
        return out, self.num_tracks

    # -- stable identity ----------------------------------------------------

    def rep_of_tracks(self, tids) -> np.ndarray:
        """Stable representative gid for each (current-generation) track id
        (-1 passes through)."""
        tids = np.asarray(tids, np.int64)
        reps = self.rep_of_track
        if reps is None or len(reps) == 0:
            # No tracks yet (e.g. 2nd VO frame with min_track_length >= 3):
            # reps[safe] below would index an empty table.
            return np.full(tids.shape, -1, np.int64)
        safe = np.clip(tids, 0, len(reps) - 1)
        return np.where(tids >= 0, reps[safe], -1)

    def canonical_rep(self, gids) -> np.ndarray:
        """Current canonical representative of the component containing
        each feature gid (tracks merged since a rep was recorded resolve to
        the merged component's representative)."""
        gids = np.asarray(gids, np.int64)
        return self.comp_min_gid[self.component_of_feature[gids]]

    def tracks_in_frame(self, frame: int):
        """(feature_idx, track_id) arrays for tracked features of a frame."""
        if self.track_of_feature is None:
            self.compute_tracks()
        lo = self.offsets[frame]
        hi = lo + self.counts[frame]
        t = self.track_of_feature[lo:hi]
        sel = t >= 0
        return np.nonzero(sel)[0], t[sel]

    def track_members(self):
        """Dict track_id -> (frames array, feature_idx array), kept members
        only, sorted chronologically."""
        if self.track_of_feature is None:
            self.compute_tracks()
        gids = np.nonzero(self.track_of_feature >= 0)[0]
        tids = self.track_of_feature[gids]
        frames = self.frame_of(gids)
        feats = gids - np.asarray(self.offsets)[frames]
        out: Dict[int, tuple] = {}
        order = np.lexsort((frames, tids))
        gids, tids, frames, feats = gids[order], tids[order], frames[order], feats[order]
        starts = np.nonzero(np.r_[True, tids[1:] != tids[:-1]])[0]
        ends = np.r_[starts[1:], len(tids)]
        for s, e in zip(starts, ends):
            out[int(tids[s])] = (frames[s:e], feats[s:e])
        return out
