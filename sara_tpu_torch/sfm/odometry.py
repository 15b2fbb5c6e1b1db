"""Incremental visual odometry / SfM pipeline.

Twin of ``sara_tpu/sfm/odometry.py``, a rebuild of the reference's
OdometryPipeline (reference: cpp/src/DO/Sara/SfM/Odometry/
OdometryPipeline.cpp:29-423):

  per frame: undistort -> detect SIFT -> match vs previous -> E-RANSAC
  relative pose -> update feature tracks -> PnP (>= 3 poses) ->
  triangulate new tracks -> bundle adjust -> write back.

Detection, matching, RANSAC, triangulation and BA run on the pipeline's
device with fixed-capacity tensors; the pose graph, tracks and map live on
the host (NumPy + the native union-find). The reference fuses each
frame's undistort + detect + match + E-RANSAC (and a window of frames) into
one jitted program; here they are the same entry points called in
sequence, with the window and chain-break semantics of
:meth:`OdometryPipeline.process_frames` kept as they are. Every estimator
draws from one ``torch.Generator`` on the device, seeded 0. Each stage
brings its results to the host in ONE packed transfer
(``utils/host.py::fetch``).

Failure handling mirrors the reference: < min inliers for the relative pose
or PnP aborts geometry growth for that frame and the pipeline continues
(reference: OdometryPipeline.cpp:173-179, 270-274).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from sara_tpu_torch import resolve_device
from sara_tpu_torch.ba import BAOptions, BAProblem, bundle_adjust
from sara_tpu_torch.core.types import Keypoints
from sara_tpu_torch.features.api import SIFTParams, compute_sift_keypoints
from sara_tpu_torch.features.dog import DoGParams
from sara_tpu_torch.image import gray_from_any, warp_bilinear
from sara_tpu_torch.image.pyramid import PyramidParams
from sara_tpu_torch.matching.brute_force import MatchParams, match_descriptors
from sara_tpu_torch.mvg.two_view import triangulate_linear
from sara_tpu_torch.ransac.estimators import (estimate_absolute_pose,
                                              estimate_relative_pose)
from sara_tpu_torch.sfm.pointcloud import PointCloudGenerator
from sara_tpu_torch.sfm.pose_graph import CameraPoseGraph
from sara_tpu_torch.sfm.tracker import FeatureTracker
from sara_tpu_torch.utils.host import fetch, put


@dataclass(frozen=True)
class OdometryConfig:
    """Pipeline knobs (defaults mirror the reference, FeatureParams.hpp:8-14,
    RelativePoseEstimator.hpp:18-20, CameraPoseEstimator.hpp:41-49)."""

    # The reference SfM pipeline detects WITHOUT the -1 upsampled octave
    # (FeatureParams.hpp:10 `ImagePyramidParams(0)`); desc_sample_nearest
    # stays off (the nearest shift hurts trajectory accuracy on the small
    # VO frames).
    sift: SIFTParams = field(default_factory=lambda: SIFTParams(
        pyramid=PyramidParams(first_octave=0), dog=DoGParams(capacity=1024),
        total_capacity=4096, desc_sample_nearest=False))
    match_ratio: float = 0.8
    rel_pose_samples: int = 1000
    rel_pose_threshold_px: float = 4.0
    rel_pose_min_inliers: int = 100
    # Two-stage E-RANSAC: a cheap first pass of this many hypotheses, and
    # only on rejection a retry at the full rel_pose_samples. 0 disables
    # the fast pass.
    rel_pose_samples_fast: int = 128
    # Basis remixes of the 5-pt solver in the fast pass (full passes keep
    # the solver default).
    rel_pose_remix_fast: int = 2
    pnp_samples: int = 1000
    pnp_threshold_px: float = 5.0
    pnp_min_inliers: int = 50
    ba_options: BAOptions = field(
        default_factory=lambda: BAOptions(max_iters=20))
    ba_window: int = 8            # poses in the BA window (0 = all)
    ba_every: int = 1             # run BA every k accepted frames
    # Additionally re-adjust the FULL trajectory every k accepted frames
    # (0 = never): windowed BA freezes early poses once the window slides
    # past them; a periodic full-graph pass keeps re-polishing them.
    full_ba_every: int = 0
    min_track_length: int = 2
    frontend_batch: int = 4       # frames per frontend window
    # Live visualization: rewrite an interactive HTML viewer with the
    # growing cloud + trajectory every k accepted frames. "" disables.
    live_viewer_path: str = ""
    live_viewer_every: int = 5


def _bucket(n: int, lo: int = 256) -> int:
    """Round up to a power of two (the reference's shape buckets)."""
    b = lo
    while b < n:
        b *= 2
    return b


def _pad_to(a: np.ndarray, n: int, fill=0):
    out = np.full((n,) + a.shape[1:], fill, a.dtype)
    out[: len(a)] = a
    return out


def _host_image(image) -> np.ndarray:
    if torch.is_tensor(image):
        return image.detach().to(torch.float32).cpu().numpy()
    return np.asarray(image, np.float32)


class OdometryPipeline:
    """Monocular VO on ``device`` (None = the CUDA device; raises without
    one). ``K`` is the (3, 3) intrinsics matrix; ``undistortion_maps`` the
    (map_u, map_v) pair of :func:`core.cameras.undistortion_maps`, or
    None."""

    def __init__(self, K: np.ndarray, config: OdometryConfig = OdometryConfig(),
                 undistortion_maps=None, device=None):
        self.device = resolve_device(device)
        self.K = np.asarray(K, float)
        self._K = torch.as_tensor(self.K, dtype=torch.float32).to(self.device)
        self.cfg = config
        self.maps = (None if undistortion_maps is None else tuple(
            torch.as_tensor(m, dtype=torch.float32).to(self.device)
            for m in undistortion_maps))
        self.pose_graph = CameraPoseGraph()
        self.tracker = FeatureTracker()
        self.point_cloud = PointCloudGenerator()
        # Per accepted frame: host copies of keypoint data.
        self.frames: list[dict] = []
        self._prev_keypoints: Optional[Keypoints] = None
        self._frames_since_ba = 0
        self._frames_since_full_ba = 0
        self._accepted_since_viewer = 0
        # One generator for every estimator (the reference splits one
        # PRNGKey(0) per call).
        self._gen = torch.Generator(device=self.device).manual_seed(0)
        # Original pixels of the frame being integrated (for scene-point
        # colors); only the newest frame's image is retained.
        self._pending_image: Optional[np.ndarray] = None
        # Called as on_accept(kp, vertex_id) after every ACCEPTED frame
        # (device-resident Keypoints).
        self.on_accept = None

    # -- helpers ------------------------------------------------------------

    def _gray(self, image) -> torch.Tensor:
        img = put(gray_from_any(image), self.device)
        if self.maps is not None:
            img = warp_bilinear(img, self.maps[0], self.maps[1])
        return img

    def _detect(self, image) -> Keypoints:
        return compute_sift_keypoints(self._gray(image), self.cfg.sift,
                                      device=self.device)

    def _relative_pose(self, prev_kp, kp, m, num_samples, n_remix=0):
        return estimate_relative_pose(
            self._gen, prev_kp.xy, kp.xy[m.j.long()], m.mask, self._K,
            self._K, threshold_px=self.cfg.rel_pose_threshold_px,
            num_samples=num_samples,
            min_inliers=self.cfg.rel_pose_min_inliers, n_remix=n_remix)

    def _frontend(self, image, prev_kp, num_samples, n_remix=0):
        """Undistort + detect + match + E-RANSAC of one frame against
        ``prev_kp`` (the reference's fused per-frame program)."""
        kp = self._detect(image)
        m = match_descriptors(prev_kp, kp,
                              MatchParams(ratio=self.cfg.match_ratio),
                              device=self.device)
        res, R, t = self._relative_pose(prev_kp, kp, m, num_samples, n_remix)
        return kp, m, res, R, t

    def _n_fast(self) -> int:
        fast = self.cfg.rel_pose_samples_fast
        return (fast if 0 < fast < self.cfg.rel_pose_samples
                else self.cfg.rel_pose_samples)

    def _rays(self, xy: np.ndarray) -> np.ndarray:
        ph = np.concatenate([xy, np.ones((len(xy), 1))], axis=1)
        r = ph @ np.linalg.inv(self.K).T
        return r / np.linalg.norm(r, axis=1, keepdims=True)

    def _f32(self, a) -> torch.Tensor:
        return put(np.asarray(a, np.float32), self.device)

    # -- main entry ---------------------------------------------------------

    def process_frame(self, image, frame_index: int = -1) -> bool:
        """Process one (already frame-skipped) video frame.

        Returns True if a new pose was added to the graph."""
        self._pending_image = _host_image(image)
        if len(self.pose_graph) == 0:
            return self.process_keypoints(self._detect(image), frame_index)
        n_fast = self._n_fast()
        kp, m, res, R_rel, t_rel = self._frontend(
            image, self._prev_keypoints, n_fast,
            n_remix=(self.cfg.rel_pose_remix_fast
                     if n_fast < self.cfg.rel_pose_samples else 0))
        ok = self._integrate(kp, m, res, R_rel, t_rel, frame_index)
        if not ok and n_fast < self.cfg.rel_pose_samples:
            # Rare hard frame: retry the relative pose at full strength.
            res, R_rel, t_rel = self._relative_pose(
                self._prev_keypoints, kp, m, self.cfg.rel_pose_samples)
            ok = self._integrate(kp, m, res, R_rel, t_rel, frame_index)
        return ok

    def process_frames(self, images, frame_indices=None) -> list:
        """Process a sequence of frames through the windowed frontend.

        Runs the frontend on ``frontend_batch`` frames at a time, then grows
        the graph/tracks/map sequentially on the host. Within a window each
        frame is matched against its predecessor's detection; if a frame is
        rejected (< min inliers) the chain through it is invalid, so the
        remaining frames of that window fall back to the per-frame path
        against the last *accepted* frame. Window i+1 is computed before
        window i is integrated, as the reference dispatches ahead.

        Returns a list of per-frame booleans (pose added or not).
        """
        images = list(images)
        if frame_indices is None:
            frame_indices = [-1] * len(images)
        out = []
        start = 0
        if len(self.pose_graph) == 0 and images:
            out.append(self.process_frame(images[0], frame_indices[0]))
            start = 1
        B = max(1, self.cfg.frontend_batch)
        # The fast E-RANSAC pass applies here too: a rejected frame breaks
        # the window chain and its fallback (process_keypoints against the
        # last accepted frame) re-runs at full strength.
        n_full = (self.cfg.rel_pose_samples_fast
                  if self.cfg.rel_pose_samples_fast > 0
                  else self.cfg.rel_pose_samples)

        def dispatch(i, prev_kp):
            """One window's frontend; frame k pairs with frame k - 1 and
            the first with ``prev_kp``."""
            chunk = [_host_image(gray_from_any(im))
                     for im in images[i:i + B]]
            kps, ms, ress, Rs, ts = [], [], [], [], []
            left = prev_kp
            for im in chunk:
                kp, m, res, R, t = self._frontend(im, left, n_full)
                for lst, x in zip((kps, ms, ress, Rs, ts), (kp, m, res, R, t)):
                    lst.append(x)
                left = kp
            return dict(i=i, n=len(chunk), chunk=chunk, kps=kps, ms=ms,
                        ress=ress, Rs=Rs, ts=ts, last_kp=kps[-1])

        def integrate(p):
            """Host integration of one window, falling back per frame once
            a rejection broke the chain."""
            chain_ok = len(self.frames) == p["i"]
            for k in range(p["n"]):
                self._pending_image = p["chunk"][k]
                fi = frame_indices[p["i"] + k]
                if chain_ok:
                    ok = self._integrate(p["kps"][k], p["ms"][k],
                                         p["ress"][k], p["Rs"][k],
                                         p["ts"][k], fi)
                    if not ok:
                        chain_ok = False
                else:
                    # Re-match against the last accepted frame. On success
                    # this frame becomes the last accepted one, so the
                    # next frame's result (matched against this frame's
                    # detection) is valid again.
                    ok = self.process_keypoints(p["kps"][k], fi)
                    chain_ok = bool(ok)
                out.append(ok)

        pending = None
        i = start
        while i < len(images):
            prev_kp = (pending["last_kp"] if pending is not None
                       else self._prev_keypoints)
            cur = dispatch(i, prev_kp)
            i += cur["n"]
            if pending is not None:
                integrate(pending)
            pending = cur
        if pending is not None:
            integrate(pending)
        return out

    def process_keypoints(self, kp: Keypoints, frame_index: int = -1) -> bool:
        """Geometric core of process_frame, driveable with precomputed
        keypoints (moved to the pipeline's device)."""
        kp = Keypoints(*(f.to(self.device) for f in kp))
        if len(self.pose_graph) == 0:
            xy, scale, resp, mask = fetch(kp.xy, kp.scale, kp.response,
                                           kp.mask)
            kp_host = {"xy": xy, "scale": scale, "response": resp,
                       "mask": mask}
            self._accept_first_frame(kp, kp_host, frame_index)
            return True

        # Match previous accepted frame vs current.
        m = match_descriptors(self._prev_keypoints, kp,
                              MatchParams(ratio=self.cfg.match_ratio),
                              device=self.device)
        n_fast = self._n_fast()
        for n_samples in dict.fromkeys((n_fast, self.cfg.rel_pose_samples)):
            res, R_rel, t_rel = self._relative_pose(
                self._prev_keypoints, kp, m, n_samples,
                n_remix=(self.cfg.rel_pose_remix_fast
                         if n_samples < self.cfg.rel_pose_samples else 0))
            if self._integrate(kp, m, res, R_rel, t_rel, frame_index):
                return True
        return False

    def _integrate(self, kp, m, res, R_rel, t_rel, frame_index) -> bool:
        """Host-side graph/track/map growth from one frame's device results."""
        # ONE device->host transfer for everything this frame needs.
        (xy_h, scale_h, resp_h, mask_h, m_mask, mi, mj, inliers_h,
         success_h, R_rel, t_rel) = fetch(
            kp.xy, kp.scale, kp.response, kp.mask, m.mask, m.i, m.j,
            res.inliers, res.success, R_rel, t_rel)
        kp_host = {"xy": xy_h, "scale": scale_h, "response": resp_h,
                   "mask": mask_h}
        if not bool(success_h):
            return False
        inl = inliers_h & m_mask
        R_rel = np.asarray(R_rel, float)
        t_rel = np.asarray(t_rel, float)
        t_rel = t_rel / max(np.linalg.norm(t_rel), 1e-12)

        # Register the frame and its inlier matches with the tracker.
        prev_frame = len(self.frames) - 1
        fid = self.tracker.add_frame(kp.capacity, kp_host["response"])
        self.tracker.add_matches(prev_frame, fid, mi[inl], mj[inl])
        self.tracker.compute_tracks(self.cfg.min_track_length)
        # Tracks may have merged: unify their scene points (barycenter)
        # and re-key the map to the merged representatives.
        self.point_cloud.propagate(self.tracker)

        # Absolute pose of the new frame + new scene points (PnP and the
        # two-view triangulation run back to back when both apply).
        R_prev, t_prev = self.pose_graph.pose(prev_frame)
        pose_from_pnp = False
        tri_result = None
        pnp_prep = (self._prep_pnp(fid, kp_host)
                    if len(self.pose_graph) >= 2
                    and self.point_cloud.num_points >= 8 else None)
        tri_prep = self._prep_triangulation(prev_frame, fid,
                                            mi[inl], mj[inl], kp_host)
        if pnp_prep is not None and tri_prep is not None:
            got = self._pnp_triangulate(pnp_prep, tri_prep, R_prev, t_prev)
            if got is not None:
                R_abs, t_abs, tri_result = got
                pose_from_pnp = True
        elif pnp_prep is not None:
            got = self._estimate_pnp_prepared(pnp_prep)
            if got is not None:
                R_abs, t_abs = got
                pose_from_pnp = True
        if not pose_from_pnp:
            # Compose the (unit-scale) relative pose onto the previous one.
            R_abs = R_rel @ R_prev
            t_abs = R_rel @ t_prev + t_rel
        v_id = self.pose_graph.add_absolute_pose(R_abs, t_abs, frame_index)
        self.pose_graph.add_relative_pose(prev_frame, v_id, R_rel, t_rel,
                                          int(m_mask.sum()), int(inl.sum()))

        self.frames.append({"kp": kp_host, "tracker_id": fid,
                            "image": self._pending_image})
        self._pending_image = None
        if len(self.frames) >= 2:
            self.frames[-2]["image"] = None  # bound memory: newest only
        self._prev_keypoints = kp

        # Grow the map from fresh two-view tracks, then bundle adjust.
        if tri_result is not None:
            self._commit_triangulation(tri_prep, *tri_result)
        elif tri_prep is not None:
            self._triangulate_prepared(prev_frame, v_id, tri_prep)
        self._frames_since_ba += 1
        self._frames_since_full_ba += 1
        if (len(self.pose_graph) >= 3
                and self._frames_since_ba >= self.cfg.ba_every):
            full = (self.cfg.full_ba_every > 0
                    and self._frames_since_full_ba >= self.cfg.full_ba_every)
            self._bundle_adjust(window=0 if full else None)
            self._frames_since_ba = 0
            if full:
                self._frames_since_full_ba = 0
        self._maybe_write_viewer()
        if self.on_accept is not None:
            self.on_accept(kp, v_id)
        return True

    def trajectory(self) -> np.ndarray:
        """(N, 3) camera centers of all accepted frames."""
        return self.pose_graph.trajectory()

    def _maybe_write_viewer(self):
        """Periodically rewrite the HTML scene so a browser tab shows the
        growing cloud + trajectory mid-run."""
        if not self.cfg.live_viewer_path:
            return
        self._accepted_since_viewer += 1
        if self._accepted_since_viewer < max(self.cfg.live_viewer_every, 1):
            return
        self._accepted_since_viewer = 0
        try:
            from sara_tpu_torch.viz.html_viewer import write_html_viewer

            write_html_viewer(self.cfg.live_viewer_path,
                              self.point_cloud.points,
                              self.point_cloud.colors,
                              trajectory=self.trajectory())
        except Exception as e:  # never let viz kill the pipeline
            import logging

            logging.getLogger("sara_tpu_torch").warning("live viewer: %s", e)

    # -- stages -------------------------------------------------------------

    def _accept_first_frame(self, kp, kp_host, frame_index):
        self.pose_graph.add_absolute_pose(np.eye(3), np.zeros(3), frame_index)
        fid = self.tracker.add_frame(kp.capacity, kp_host["response"])
        self.frames.append({"kp": kp_host, "tracker_id": fid,
                            "image": self._pending_image})
        self._pending_image = None
        self._prev_keypoints = kp
        if self.on_accept is not None:
            self.on_accept(kp, 0)

    def _prep_pnp(self, fid: int, kp_host):
        """Host prep of the PnP inputs (track->scene-point association).
        Returns padded (X, rays, uv, mask, n) or None."""
        feat_idx, track_ids = self.tracker.tracks_in_frame(fid)
        if len(feat_idx) == 0:
            return None
        reps = self.tracker.rep_of_tracks(track_ids)
        spt = self.point_cloud.scene_point_of_track
        idxs = np.fromiter((spt.get(int(r), -1) for r in reps), np.int64,
                           len(reps))
        sel = idxs >= 0
        if int(sel.sum()) < max(6, self.cfg.pnp_min_inliers // 4):
            return None
        X = self.point_cloud.points[idxs[sel]]
        uv = kp_host["xy"][np.asarray(feat_idx)[sel]]
        rays = self._rays(uv)
        cap = _bucket(len(X))
        mask = np.zeros(cap, bool)
        mask[: len(X)] = True
        return (_pad_to(X, cap), _pad_to(rays, cap), _pad_to(uv, cap),
                mask, len(X))

    def _prep_triangulation(self, va: int, vb: int, ia, ib, kp_host):
        """Host prep of the new-track triangulation inputs. Returns
        (reps_sel, xb_sel, padded rays_a, rays_b, mask) or None."""
        if len(ia) == 0:
            return None
        tracks = self.tracker.track_of_feature
        ga = self.tracker.global_id(self.frames[va]["tracker_id"], ia)
        ta = tracks[ga]
        # Scene points key on STABLE representatives, not the
        # generation-local dense track ids.
        reps = self.tracker.rep_of_tracks(ta)
        need = [k for k in range(len(ia))
                if ta[k] >= 0
                and not self.point_cloud.track_has_point(int(reps[k]))]
        if not need:
            return None
        sel = np.asarray(need)
        xa = self.frames[va]["kp"]["xy"][np.asarray(ia)[sel]]
        xb = kp_host["xy"][np.asarray(ib)[sel]]
        ra = self._rays(xa)
        rb = self._rays(xb)
        cap = _bucket(len(sel))
        mask = np.zeros(cap, bool)
        mask[: len(sel)] = True
        return (reps[sel], xb, _pad_to(ra, cap), _pad_to(rb, cap), mask)

    def _pnp(self, prep):
        X, rays, uv, mask, n = prep
        return estimate_absolute_pose(
            self._gen, self._f32(X), self._f32(rays), self._f32(uv), self._K,
            put(mask, self.device),
            threshold_px=self.cfg.pnp_threshold_px,
            num_samples=self.cfg.pnp_samples,
            min_inliers=min(self.cfg.pnp_min_inliers, max(6, n // 2)))

    def _estimate_pnp_prepared(self, prep):
        """PnP of the current frame against the existing map
        (reference: CameraPoseEstimator.cpp:78-189)."""
        res, R, t = self._pnp(prep)
        success, R, t = fetch(res.success, R, t)          # one transfer
        if not bool(success):
            return None
        return np.asarray(R, float), np.asarray(t, float)

    def _pnp_triangulate(self, pnp_prep, tri_prep, R_prev, t_prev):
        """PnP RANSAC + triangulation of the new tracks with the PnP pose,
        back to back on the device, one transfer. Returns
        (R, t, (Xw, cheiral)) or None."""
        _, _, ra, rb, mask_t = tri_prep
        res, R, t = self._pnp(pnp_prep)
        R_prev_t = self._f32(R_prev)
        t_prev_t = self._f32(t_prev)
        R_rel = R @ R_prev_t.T
        t_rel = t - R_rel @ t_prev_t
        Xc, d1, d2 = triangulate_linear(R_rel, t_rel, self._f32(ra),
                                        self._f32(rb))
        # Prev-camera frame -> world.
        Xw = (Xc - t_prev_t) @ R_prev_t
        success, R, t, Xw, cheiral = fetch(res.success, R, t, Xw,
                                            (d1 > 0) & (d2 > 0))
        if not bool(success):
            return None
        cheiral = cheiral & mask_t
        return (np.asarray(R, float), np.asarray(t, float),
                (np.asarray(Xw), cheiral))

    def _commit_triangulation(self, tri_prep, Xw, cheiral):
        """Host-side map growth from the PnP + triangulation output."""
        reps_sel, xb, *_ = tri_prep
        k = len(reps_sel)
        self.point_cloud.add_points(
            reps_sel[cheiral[:k]], Xw[:k][cheiral[:k]],
            self._sample_colors(xb, cheiral[:k]))

    def _triangulate_prepared(self, va: int, vb: int, tri_prep):
        """Standalone triangulation (PnP-less path; reference:
        PointCloudGenerator::grow_point_cloud, .cpp:289-427)."""
        reps_sel, xb, ra, rb, mask_t = tri_prep
        Ra, tA = self.pose_graph.pose(va)
        Rb, tB = self.pose_graph.pose(vb)
        R = Rb @ Ra.T
        t = tB - R @ tA
        X, d1, d2 = triangulate_linear(self._f32(R), self._f32(t),
                                       self._f32(ra), self._f32(rb))
        X, d1, d2 = fetch(X, d1, d2)                       # one transfer
        cheiral = (d1 > 0) & (d2 > 0) & mask_t
        # Camera-a frame -> world: Xw = Ra^T (Xc - tA).
        Xw = (Ra.T @ (X.T - tA[:, None])).T
        k = len(reps_sel)
        self.point_cloud.add_points(
            reps_sel[cheiral[:k]], Xw[:k][cheiral[:k]],
            self._sample_colors(xb, cheiral[:k]))

    def _sample_colors(self, xb, keep):
        """Colors from the newest frame's pixels at the observed keypoint
        (reference retrieve_scene_point_color projects the scene point,
        PointCloudGenerator.cpp:376-427)."""
        img = self.frames[-1].get("image") if self.frames else None
        if img is None:
            return None
        h_i, w_i = img.shape[:2]
        xs = np.clip(np.round(xb[:, 0]).astype(int), 0, w_i - 1)
        ys = np.clip(np.round(xb[:, 1]).astype(int), 0, h_i - 1)
        px = img[ys, xs]
        return (np.repeat(px[:, None], 3, axis=1) if px.ndim == 1
                else np.asarray(px)[:, :3])[keep]

    def _bundle_adjust(self, window=None, pin=()):
        """Windowed BA over the latest poses (the reference adjusts the whole
        graph each frame, OdometryPipeline.cpp:315-422; ba_window=0 gives
        that). ``window`` overrides the config for one call (full_ba_every);
        ``pin`` freezes the given absolute pose indices completely."""
        n_poses = len(self.pose_graph)
        w = self.cfg.ba_window if window is None else window
        start = 0 if w == 0 else max(0, n_poses - w)
        # Only features detected in window frames matter.
        tof = self.tracker.track_of_feature
        offsets = np.asarray(self.tracker.offsets)
        lo = offsets[start]
        gids = lo + np.nonzero(tof[lo:] >= 0)[0]
        if len(gids) == 0:
            return
        frames_arr = self.tracker.frame_of(gids)
        tids = tof[gids]
        uniq, inv = np.unique(tids, return_inverse=True)
        cnt = np.bincount(inv)
        reps = self.tracker.rep_of_tracks(uniq)
        spt = self.point_cloud.scene_point_of_track
        sp_idx = np.fromiter((spt.get(int(r), -1) for r in reps), np.int64,
                             len(reps))
        keep = (cnt >= 2) & (sp_idx >= 0)
        kept = np.nonzero(keep)[0]
        if len(kept) < 8:
            return
        pt_of_uniq = np.full(len(uniq), -1, np.int64)
        pt_of_uniq[kept] = np.arange(len(kept))
        obs_sel = pt_of_uniq[inv] >= 0
        obs_cam = (frames_arr[obs_sel] - start).astype(np.int32)
        obs_pt = pt_of_uniq[inv][obs_sel].astype(np.int32)
        feats = gids[obs_sel] - offsets[frames_arr[obs_sel]]
        obs_uv = np.zeros((len(obs_cam), 2))
        for f in range(start, n_poses):
            m = frames_arr[obs_sel] == f
            if m.any():
                obs_uv[m] = self.frames[f]["kp"]["xy"][feats[m]]
        pt_ids = reps[kept]
        pt_xyz = self.point_cloud.points[sp_idx[kept]]
        if len(obs_cam) < 24:
            return

        C = n_poses - start
        # Bucketed axes (pow2, frozen padding), as the reference has them.
        Cb = _bucket(C, 8)
        P = _bucket(len(pt_ids), 64)
        O = _bucket(len(obs_cam), 256)
        poses = self.pose_graph.poses_se3()[start:]
        if Cb != C:
            poses = np.concatenate([poses, np.zeros((Cb - C, 6))])
        # Monocular gauge (7 dof: similarity): fixing the first pose removes
        # 6; the global scale is pinned explicitly (per-component freeze
        # masks, a (C, 6) pose_fixed).
        pose_fixed = np.zeros((Cb, 6), bool)
        pose_fixed[0] = True
        pose_fixed[C:] = True
        for p in pin:
            if start <= p < n_poses:
                pose_fixed[p - start] = True
        if start == 0 and C >= 2:
            # Freeze the second camera's largest translation component.
            t1 = poses[1, 3:]
            pose_fixed[1, 3 + int(np.argmax(np.abs(t1)))] = True
        elif start > 0 and C >= 3:
            # Sliding window: anchor scale to the previous estimate by
            # freezing the second window pose entirely.
            pose_fixed[1] = True

        intr = np.array([self.K[0, 0], self.K[1, 1],
                         self.K[0, 2], self.K[1, 2]])
        dev = self.device
        # float32 on the device: the reference's production dtype, which
        # takes the dense-Schur solver's bfloat16 path.
        prob = BAProblem(
            poses=self._f32(poses),
            points=self._f32(_pad_to(np.asarray(pt_xyz), P)),
            intrinsics=self._f32(intr),
            cam_idx=put(_pad_to(obs_cam, O), dev),
            pt_idx=put(_pad_to(obs_pt, O), dev),
            uv=self._f32(_pad_to(obs_uv, O)),
            obs_mask=put(_pad_to(np.ones(len(obs_cam), bool), O, False), dev),
            pose_fixed=put(pose_fixed, dev),
            point_fixed=put(~_pad_to(np.ones(len(pt_ids), bool), P, False),
                            dev),
        )
        out, info = bundle_adjust(prob, self.cfg.ba_options)
        new_poses, new_points = fetch(out.poses[:C],
                                       out.points[: len(pt_ids)])
        packed = self.pose_graph.poses_se3()
        packed[start:] = new_poses
        self.pose_graph.update_from_se3(packed)
        self.point_cloud.update_points(pt_ids, new_points)
