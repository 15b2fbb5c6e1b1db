"""Loop-closure detection + pose-graph correction for the VO pipeline.

Twin of ``sara_tpu/sfm/loop_closure.py``, a subsystem with no reference
counterpart (the reference pipeline never closes loops): candidate
retrieval by global descriptor similarity (VLAD), geometric verification
through the essential-matrix RANSAC or a metric PnP against the candidate's
map section, and drift correction via the Sim(3) / SE(3) pose-graph
optimizer (``sfm/pose_graph_opt.py``). Required by BASELINE config 3.

The closer runs on its device (None = the CUDA device; raises without
one). Every verification draws from one ``torch.Generator`` on that device,
seeded 42 (the reference splits one ``PRNGKey(42)``). Device results come
to the host in one packed transfer per stage (``utils/host.py::fetch``);
the VLAD signature is computed on the device and only its 8 KB come over.
The pose graph is optimized in float32 on the device, the reference's
production precision (its ``jnp.asarray`` of float64 numpy yields float32
with x64 off).
"""

from __future__ import annotations

import os
from collections import defaultdict
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from sara_tpu_torch import resolve_device
from sara_tpu_torch.core.types import Keypoints
from sara_tpu_torch.matching.brute_force import MatchParams, match_descriptors
from sara_tpu_torch.ransac.estimators import (estimate_absolute_pose,
                                              estimate_relative_pose)
from sara_tpu_torch.sfm.pose_graph_opt import (
    PoseGraphProblem, optimize_pose_graph, relative_pose_to_packing)
from sara_tpu_torch.utils.host import fetch, put
from sara_tpu_torch.utils.log import get_logger


@dataclass(frozen=True)
class LoopClosureConfig:
    min_gap: int = 15            # frames between candidates and current
    max_candidates: int = 3
    min_inliers: int = 60
    rel_pose_samples: int = 500
    threshold_px: float = 4.0
    loop_weight: float = 10.0
    # Translation components of a monocular loop edge carry a GUESSED
    # scale (the drifted baseline) — give them this fraction of the
    # rotation information (pose_graph_opt takes (E, 6) weights).
    loop_trans_frac: float = 0.25
    # Inliers at which a loop edge reaches full loop_weight (scales
    # linearly below; more inliers = more information).
    full_weight_inliers: int = 200
    # Huber threshold on the edge residual norm — a false or inconsistent
    # loop edge saturates instead of dragging the graph — and the trim
    # point (in units of huber_delta) beyond which an edge is dropped from
    # the solution entirely.
    huber_delta: float = 0.5
    edge_outlier_cutoff: float = 6.0
    # VLAD retrieval codebook size (0 falls back to mean-descriptor).
    vlad_k: int = 16
    # METRIC loop edges: matched features of the loop CANDIDATE frame that
    # carry scene points let the current frame be PnP-localized against the
    # candidate's (old, low-drift) map section — a loop edge with MEASURED
    # translation scale. The E-only fallback scales its unit translation by
    # the current drifted baseline, which bakes the drift into the edge.
    min_metric_points: int = 30
    metric_pnp_samples: int = 500
    # Optimize the pose graph over Sim(3) instead of SE(3): monocular
    # odometry accumulates SCALE drift that an SE(3) graph cannot express.
    # Sim(3) poses carry a log-scale state; metric PnP loop edges anchor
    # true scale, odometry edges softly prefer relative scale 1 (Strasdat
    # et al., RSS 2010).
    sim3: bool = True
    # Information weight of the odometry edges' relative-scale component
    # (how strongly consecutive frames resist scale change).
    odo_scale_weight: float = 1.0
    # After a successful pose-graph correction: rigidly re-anchor every
    # scene point with its anchor (first-observation) frame's pose delta —
    # the map must move WITH the corrected trajectory — and optionally
    # polish trajectory+map with one full-graph BA (post_ba, off by
    # default: loop edges are not in the BA cost, so reprojection walks
    # the graph back toward the drift-consistent optimum).
    correct_map: bool = True
    post_ba: bool = False
    metric_pnp_threshold_px: float = 5.0


def global_descriptor(kp) -> np.ndarray:
    """Cheap retrieval fallback: masked mean of L2-normalized descriptors."""
    d, m = fetch(kp.descriptors, kp.mask)
    m = m.astype(np.float64)
    v = (d * m[:, None]).sum(axis=0) / max(m.sum(), 1.0)
    n = np.linalg.norm(v)
    return v / max(n, 1e-12)


def vlad_signature(kp, codebook: np.ndarray) -> np.ndarray:
    """VLAD over the frame's SIFT descriptors (power + L2 normalized), on
    the host: per-centroid residual sums preserve the distribution of
    local appearance, so perceptually similar but distinct views stop
    colliding."""
    d, m = fetch(kp.descriptors, kp.mask)
    d = np.asarray(d, np.float64)[m]
    if len(d) == 0:
        return np.zeros(codebook.size)
    # Assign each descriptor to its nearest centroid.
    d2 = (np.sum(d * d, 1)[:, None] - 2.0 * d @ codebook.T
          + np.sum(codebook * codebook, 1)[None])
    a = np.argmin(d2, axis=1)
    K = len(codebook)
    v = np.zeros((K, d.shape[1]))
    np.add.at(v, a, d - codebook[a])
    v = v.reshape(-1)
    # Power-law (signed sqrt) + L2 normalization (standard VLAD recipe).
    v = np.sign(v) * np.sqrt(np.abs(v))
    return v / max(np.linalg.norm(v), 1e-12)


def _vlad_device(desc, mask, codebook):
    """VLAD signature on the descriptors' device (float32): one small
    device computation and an 8 KB fetch per frame instead of shipping the
    (N, 128) descriptor block to the host. Math mirrors
    :func:`vlad_signature`."""
    d = desc.to(torch.float32)
    cb = codebook.to(device=d.device, dtype=torch.float32)
    d2 = (torch.sum(d * d, 1)[:, None] - 2.0 * d @ cb.T
          + torch.sum(cb * cb, 1)[None])
    a = torch.argmin(d2, dim=1)
    oh = (F.one_hot(a, cb.shape[0]).to(torch.float32)
          * mask[:, None].to(torch.float32))
    v = oh.T @ d - torch.sum(oh, dim=0)[:, None] * cb
    v = v.reshape(-1)
    v = torch.sign(v) * torch.sqrt(torch.abs(v))
    return v / torch.clamp(torch.linalg.vector_norm(v), min=1e-12)


def kmeans_codebook(descs: np.ndarray, k: int, iters: int = 8,
                    seed: int = 0) -> np.ndarray:
    """Tiny k-means (enough for a VLAD vocabulary) on (N, D) descriptors."""
    rs = np.random.RandomState(seed)
    descs = np.asarray(descs, np.float64)
    cb = descs[rs.choice(len(descs), size=min(k, len(descs)),
                         replace=False)]
    if len(cb) < k:
        cb = np.concatenate([cb, rs.normal(size=(k - len(cb),
                                                 descs.shape[1]))])
    for _ in range(iters):
        d2 = (np.sum(descs * descs, 1)[:, None] - 2.0 * descs @ cb.T
              + np.sum(cb * cb, 1)[None])
        a = np.argmin(d2, axis=1)
        for c in range(k):
            sel = a == c
            if sel.any():
                cb[c] = descs[sel].mean(axis=0)
    return cb


def _scene_points(pipeline, frame: int, feats: np.ndarray) -> np.ndarray:
    """Scene-point index of each of ``frame``'s features (-1: none)."""
    tr = pipeline.tracker
    tracks = tr.track_of_feature[tr.global_id(
        pipeline.frames[frame]["tracker_id"], feats)]
    ok = tracks >= 0
    reps = tr.rep_of_tracks(np.where(ok, tracks, 0))
    spt = pipeline.point_cloud.scene_point_of_track
    return np.fromiter((spt.get(int(r), -1) if o else -1
                        for r, o in zip(reps, ok)), np.int64, len(reps))


class LoopCloser:
    """Maintains per-frame retrieval signatures; detects + verifies loops and
    optimizes the pose graph of an OdometryPipeline in place. Runs on
    ``device`` (None = the CUDA device; raises without one)."""

    def __init__(self, K: np.ndarray,
                 config: LoopClosureConfig = LoopClosureConfig(),
                 device=None):
        self.device = resolve_device(device)
        self.K = np.asarray(K, float)
        self._K = put(self.K.astype(np.float32), self.device)
        self.cfg = config
        self.signatures: list[np.ndarray] = []
        self.keypoint_sets: list = []
        self.loop_edges: list[tuple] = []
        self._gen = torch.Generator(device=self.device).manual_seed(42)
        self._codebook: np.ndarray | None = None
        self._codebook_dev = None

    def _vlad(self, kp) -> np.ndarray:
        return fetch(_vlad_device(kp.descriptors, kp.mask,
                                  self._codebook_dev))[0]

    def _signature(self, kp) -> np.ndarray:
        if self.cfg.vlad_k <= 0:
            return global_descriptor(kp)
        if self._codebook is None:
            # Build the VLAD vocabulary from the first frame's descriptors
            # (the vocabulary must stay FIXED so signatures are comparable).
            d, m = fetch(kp.descriptors, kp.mask)
            d = d[m]
            if len(d) < self.cfg.vlad_k:
                return global_descriptor(kp)
            self._codebook = kmeans_codebook(d, self.cfg.vlad_k)
            self._codebook_dev = put(self._codebook.astype(np.float32),
                                     self.device)
            # Re-signature any earlier frames (dimension consistency).
            # In place: add_frame holds a reference to this list.
            self.signatures[:] = [self._vlad(k2)
                                  for k2 in self.keypoint_sets]
        return self._vlad(kp)

    def add_frame(self, kp):
        kp = Keypoints(*(f.to(self.device) for f in kp))
        self.signatures.append(self._signature(kp))
        self.keypoint_sets.append(kp)
        return len(self.signatures) - 1

    def detect(self, frame_id: int):
        """Candidate loop frames for frame_id (older than min_gap)."""
        hi = frame_id - self.cfg.min_gap
        if hi <= 0:
            return []
        sims = np.asarray([self.signatures[frame_id] @ self.signatures[j]
                           for j in range(hi)])
        order = np.argsort(-sims)[: self.cfg.max_candidates]
        return [int(j) for j in order]

    def _match(self, a: int, b: int):
        ka, kb = self.keypoint_sets[a], self.keypoint_sets[b]
        return ka, kb, match_descriptors(ka, kb, MatchParams(ratio=0.8),
                                         device=self.device)

    def verify(self, a: int, b: int):
        """Geometric verification a -> b. Returns (R, t, n_inliers) or None."""
        ka, kb, m = self._match(a, b)
        res, R, t = estimate_relative_pose(
            self._gen, ka.xy, kb.xy[m.j.long()], m.mask, self._K, self._K,
            threshold_px=self.cfg.threshold_px,
            num_samples=self.cfg.rel_pose_samples,
            min_inliers=self.cfg.min_inliers)
        success, n_inl, R, t = fetch(res.success, res.num_inliers, R, t)
        if not bool(success):
            return None
        t = np.asarray(t, float)
        return (np.asarray(R, float), t / max(np.linalg.norm(t), 1e-12),
                int(n_inl))

    def verify_metric(self, pipeline, a: int, b: int):
        """Metric loop edge a -> b: PnP of frame b against the scene points
        attached to frame a's matched features. Unlike the E-based edge,
        the translation carries a MEASURED scale (the old map section's),
        so the edge constrains the drifted graph instead of restating it.
        Returns (R_rel, t_rel_metric, n_inliers, d_rel) or None."""
        _, kb, m = self._match(a, b)
        mi, mj, mmask, xy_b = fetch(m.i, m.j, m.mask, kb.xy)
        sel = np.flatnonzero(mmask)
        if len(sel) < self.cfg.min_metric_points:
            return None
        if a >= len(pipeline.frames):
            return None
        idxs = _scene_points(pipeline, a, mi[sel])
        has_pt = idxs >= 0
        if int(has_pt.sum()) < self.cfg.min_metric_points:
            return None
        X = pipeline.point_cloud.points[idxs[has_pt]]
        uv = xy_b[mj[sel][has_pt]]
        rays = pipeline._rays(uv)
        cap = 1 << max(6, int(len(X) - 1).bit_length())
        pad = cap - len(X)

        def pad3(arr):
            arr = np.asarray(arr, np.float32)
            return put(np.concatenate(
                [arr, np.zeros((pad,) + arr.shape[1:], arr.dtype)]),
                self.device)

        mask = np.zeros(cap, bool)
        mask[:len(X)] = True
        res, R_b, t_b = estimate_absolute_pose(
            self._gen, pad3(X), pad3(rays), pad3(uv), self._K,
            put(mask, self.device),
            threshold_px=self.cfg.metric_pnp_threshold_px,
            num_samples=self.cfg.metric_pnp_samples,
            min_inliers=min(self.cfg.min_metric_points, len(X) // 2 + 1))
        success, n_inl, R_b, t_b = fetch(res.success, res.num_inliers, R_b,
                                         t_b)
        if not bool(success):
            return None
        R_a, t_a = pipeline.pose_graph.pose(a)
        R_b = np.asarray(R_b, float)
        t_b = np.asarray(t_b, float)
        R_rel = R_b @ np.asarray(R_a).T
        t_rel = t_b - R_rel @ np.asarray(t_a)
        # Relative LOCAL-SCALE measurement for the Sim(3) graph (Strasdat
        # RSS'10): the same physical structure is measured in both frames'
        # map sections — the depth of frame a's points under the PnP pose
        # vs the depth of frame b's OWN (recently triangulated, drifted-
        # scale) points under b's graph pose. The median ratio is
        # s_local(b)/s_local(a); without it a scale-1 loop edge contradicts
        # the drift and Sim(3) converges to a warped compromise.
        d_rel = None
        if b < len(pipeline.frames):
            idxs_b = _scene_points(pipeline, b, mj[sel])
            both = has_pt & (idxs_b >= 0)
            if int(both.sum()) >= 8:
                Rbg, tbg = pipeline.pose_graph.pose(b)
                Xa = pipeline.point_cloud.points[idxs[both]]
                Xb = pipeline.point_cloud.points[idxs_b[both]]
                z_a = (Xa @ R_b.T + t_b)[:, 2]          # a-map scale
                z_b = (Xb @ np.asarray(Rbg).T + np.asarray(tbg))[:, 2]
                good = (z_a > 1e-6) & (z_b > 1e-6)
                if int(good.sum()) >= 8:
                    d_rel = float(np.median(z_b[good] / z_a[good]))
        return R_rel, t_rel, int(n_inl), d_rel

    def close(self, pipeline, frame_id: int) -> bool:
        """Try to close a loop at frame_id; on success optimize the pose
        graph in place. Returns True if a loop was applied."""
        log = get_logger("sara_tpu_torch.loop")
        applied = False
        for cand in self.detect(frame_id):
            got = self.verify_metric(pipeline, cand, frame_id)
            if got is not None:
                R, t, n_inl, d_rel = got
                self.loop_edges.append(
                    (cand, frame_id, R, t, n_inl, True, d_rel))
                log.info("loop edge %d->%d METRIC (%d inliers, "
                         "rel scale %s)", cand, frame_id, n_inl,
                         f"{d_rel:.3f}" if d_rel else "n/a")
                applied = True
                continue
            got = self.verify(cand, frame_id)
            if got is None:
                log.info("loop candidate %d->%d rejected", cand, frame_id)
                continue
            R, t, n_inl = got
            self.loop_edges.append(
                (cand, frame_id, R, t, n_inl, False, None))
            log.info("loop edge %d->%d E-only (%d inliers)",
                     cand, frame_id, n_inl)
            applied = True
        if not applied:
            return False
        self._optimize(pipeline)
        if self.cfg.post_ba:
            # Full-trajectory BA from the corrected, map-consistent state,
            # with the loop-edge endpoint poses PINNED: loop edges are not
            # in the BA cost, so an unconstrained BA walks back toward the
            # drift-consistent reprojection optimum.
            pins = sorted({f for (a, b, *_rest) in self.loop_edges
                           for f in (a, b)})
            pipeline._bundle_adjust(window=0, pin=pins)
        return True

    def _optimize(self, pipeline):
        pg = pipeline.pose_graph
        n = len(pg)
        packed = pg.poses_se3()
        D = 7 if self.cfg.sim3 else 6
        edges_i, edges_j, Rs, ts, weights = [], [], [], [], []
        # Odometry chain edges from the current (drifted) graph, weight 1;
        # loop edges with their measured relative motion, higher weight.
        for e in pg.edges:
            Ri, ti = pg.pose(e.src)
            Rj, tj = pg.pose(e.dst)
            R_rel = Rj @ Ri.T
            edges_i.append(e.src)
            edges_j.append(e.dst)
            Rs.append(R_rel)
            ts.append(tj - R_rel @ ti)
            w = np.ones(D)
            if self.cfg.sim3:
                w[6] = self.cfg.odo_scale_weight
            weights.append(w)
        sigmas = [0.0] * len(Rs)             # odometry: relative scale 1
        for (a, b, R, t, n_inl, metric, d_rel) in self.loop_edges:
            sigma_m = 0.0
            if metric:
                # PnP-measured edge: translation scale is the OLD map
                # section's (real). When the relative local scale d =
                # s_local(b)/s_local(a) was measured, express the Sim(3)
                # measurement in b's scale frame: t_m = d * t_pnp,
                # sigma_m = log d — this is what makes the Sim(3) graph
                # recover scale DRIFT instead of compromising.
                scale_known = d_rel is not None and d_rel > 0
                if self.cfg.sim3 and scale_known:
                    t_edge = d_rel * t
                    sigma_m = float(np.log(d_rel))
                else:
                    t_edge = t
                trans_frac = 1.0
            else:
                # E-only fallback: scale the unit loop translation with
                # the current graph's baseline estimate (monocular scale
                # is unobservable from E) and discount its information.
                scale_known = False
                ca = pg.poses[a].center()
                cb = pg.poses[b].center()
                s = max(np.linalg.norm(cb - ca), 1e-6)
                t_edge = s * t
                trans_frac = self.cfg.loop_trans_frac
            edges_i.append(a)
            edges_j.append(b)
            Rs.append(R)
            ts.append(t_edge)
            sigmas.append(sigma_m)
            # Information scales with the verified inlier count (a flat
            # scalar weight let one noisy edge outvote the odometry chain).
            w_rot = self.cfg.loop_weight * min(
                1.0, n_inl / max(self.cfg.full_weight_inliers, 1))
            w = np.full(D, w_rot)
            w[3:6] *= trans_frac
            if self.cfg.sim3:
                # A loop edge carries scale information only when its
                # relative local scale was actually measured.
                w[6] *= 1.0 if scale_known else 0.0
            weights.append(w)
        # All edges packed at once on the host (float64).
        rels = relative_pose_to_packing(
            torch.from_numpy(np.stack(Rs).astype(np.float64)),
            torch.from_numpy(np.stack(ts).astype(np.float64))).numpy()

        if self.cfg.sim3:
            # Lift SE(3) state + measurements to Sim(3): poses start at
            # log_s = 0; odometry edges are measured in their own drifted
            # scale with relative scale 1; metric loop edges carry their
            # measured relative scale — the per-pose scale states absorb
            # the drift.
            packed = np.concatenate([packed, np.zeros((n, 1))], axis=1)
            rels = np.concatenate([rels, np.asarray(sigmas)[:, None]],
                                  axis=1)

        def dev(a, dtype):
            return put(torch.as_tensor(np.asarray(a), dtype=dtype),
                       self.device)

        prob = PoseGraphProblem(
            poses=dev(packed, torch.float32),
            edge_i=dev(edges_i, torch.int64),
            edge_j=dev(edges_j, torch.int64),
            rel_pose=dev(rels, torch.float32),
            weight=dev(np.stack(weights), torch.float32),
            edge_mask=dev(np.ones(len(edges_i), bool), torch.bool),
            pose_fixed=dev([True] + [False] * (n - 1), torch.bool),
        )
        # --- Consensus-gated robust threshold. Monocular scale drift makes
        # GENUINE loop-edge residuals arbitrarily large in map units, so
        # any fixed huber/trim threshold either drops the true edges or
        # loses false-edge protection. Resolution: when >=2 loop edges onto
        # the same frame AGREE with each other (their implied absolute
        # poses cluster), raise the robust threshold to cover their common
        # residual. A single edge keeps the strict gate.
        delta_eff = self.cfg.huber_delta
        groups = defaultdict(list)
        for (a, b, R, t, n_inl, metric, _d) in self.loop_edges:
            if not metric:
                continue
            Ra, ta = pg.pose(a)
            Rb_g, tb_g = pg.pose(b)
            t_b_meas = t + R @ np.asarray(ta)
            t_rel_g = np.asarray(tb_g) - R @ np.asarray(ta)
            resid = float(np.linalg.norm(t - t_rel_g))
            groups[b].append((t_b_meas, resid))
        for b, rows in groups.items():
            if len(rows) < 2:
                continue
            tbs = np.stack([r[0] for r in rows])
            resids = np.asarray([r[1] for r in rows])
            spread = float(np.max(np.linalg.norm(
                tbs[:, None] - tbs[None, :], axis=-1)))
            if spread < max(0.3 * float(np.median(resids)), 1e-6) \
                    or float(np.median(resids)) < self.cfg.huber_delta:
                delta_eff = max(delta_eff, 1.2 * float(np.max(resids)))
        # Rounded to 2 significant digits, as the reference rounds it (a
        # static jit argument there); the value changes with it.
        delta_eff = float(f"{delta_eff:.2g}")

        if os.environ.get("SARA_DUMP_PG"):
            np.savez(os.environ["SARA_DUMP_PG"],
                     **dict(zip(prob._fields, fetch(*prob))))
        out, info = optimize_pose_graph(
            prob, max_iters=25, huber_delta=delta_eff,
            outlier_cutoff=self.cfg.edge_outlier_cutoff)
        new, cost0, cost_f = fetch(out.poses, info["initial_cost"],
                                   info["final_cost"])
        log = get_logger("sara_tpu_torch.loop")
        log.info("pose-graph opt: cost %.4f -> %.4f, max pose delta %.4f",
                 float(cost0), float(cost_f),
                 float(np.max(np.abs(new - packed))))
        if self.cfg.sim3:
            # Back to SE(3): a Sim(3) world->cam pose (s R, t) has camera
            # center -(1/s) R^T t, so the SE(3) pose with the same center
            # and rotation is (R, t / s). The per-pose scales also rescale
            # each camera's map depths below.
            s_new = np.exp(new[:, 6])
            new = np.concatenate([new[:, :3], new[:, 3:6] / s_new[:, None]],
                                 axis=1)
            log.info("sim3 scale field: %.3f .. %.3f (drift %.1f%%)",
                     float(s_new.min()), float(s_new.max()),
                     100.0 * float(s_new.max() / s_new.min() - 1.0))
        else:
            s_new = np.ones(n)
        pg.update_from_se3(new)
        if self.cfg.correct_map and len(pipeline.point_cloud.points):
            # Map correction: each scene point rides its anchor frame's
            # pose delta; its camera-frame coordinates are what the
            # closure cannot change, and under a Sim(3) correction the
            # anchor's scale rescales its depths:
            #   X' = R_new^T (R_old X + t_old - s_new * t_new_se3) / s_new.
            from scipy.spatial.transform import Rotation

            pc = pipeline.point_cloud
            m = len(pc.scene_point_of_track)
            reps = np.fromiter(pc.scene_point_of_track.keys(), np.int64, m)
            idxs = np.fromiter(pc.scene_point_of_track.values(), np.int64, m)
            uniq, first = np.unique(idxs, return_index=True)
            frames = np.clip(pipeline.tracker.frame_of(reps[first]), 0, n - 1)
            Ro = Rotation.from_rotvec(packed[frames, :3]).as_matrix()
            Rn = Rotation.from_rotvec(new[frames, :3]).as_matrix()
            sn = s_new[frames]
            Xc = np.einsum("pij,pj->pi", Ro, pc.points[uniq]) \
                + packed[frames, 3:6]
            pc.points[uniq] = np.einsum(
                "pji,pj->pi", Rn,
                Xc - sn[:, None] * new[frames, 3:]) / sn[:, None]
