"""Stage-isolated parity probe of the PyTorch / CUDA port: the batched
frontend against the per-frame one on the SAME inputs.

Twin of ``scripts/probe_batch_parity.py``. Stages probed independently,
each batched against single on identical inputs:
  detect : ``_compute_sift_batch`` vs per-frame ``compute_sift_keypoints``
  match  : ``_match_sets`` over the pair axis vs per-pair
           ``match_descriptors``, on IDENTICAL (per-frame) detections
  ransac : ``estimate_relative_pose`` with a leading pair axis vs per
           pair, on identical matches and identical samples: where the
           probe hands both calls the same keys, the twin draws each
           pair's samples once (``ransac/engine.py::draw_samples``) and
           hands them to both calls. Success, inliers and the rotation and
           direction errors against the rendered truth, and the batched
           pose's angles from the per-pair one.

Prints one JSON line per stage (``{"probe": ...}``), as the probe does, with
the device type for the probe's backend. The frames are the probe's
renders of ``scripts/torch_eval_real_images.py::make_real_room`` (the
reference's photographs, or ``make_room(seed=1)`` without them). It
imports only ``sara_tpu_torch``, numpy and the numpy helpers of
``tests/``, and runs on the card unless ``--device cpu`` is given; without
a card it raises.

Usage: python scripts/torch_probe_batch_parity.py [--device cpu]
       [--frames 5] [--width 320] [--height 240]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (ROOT, os.path.join(ROOT, "tests"), os.path.join(ROOT, "scripts")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import numpy as np  # noqa: E402

# The probe's RANSAC budget and key seed (it splits PRNGKey(7)).
RANSAC_SAMPLES = 300
SEED = 7


def kp_set_distance(a, b):
    """The probe's comparison of two Keypoints: the share of a's valid
    keypoints with one of b's within 0.05 px, the largest xy deviation of
    those, and the descriptor cosines of the pairs."""
    from sara_tpu_torch.utils.host import fetch

    axy, am, ad = fetch(a.xy, a.mask, a.descriptors)
    bxy, bm, bd = fetch(b.xy, b.mask, b.descriptors)
    axy, ad, bxy, bd = axy[am], ad[am], bxy[bm], bd[bm]
    if len(axy) == 0 or len(bxy) == 0:
        return dict(n_a=len(axy), n_b=len(bxy), frac_matched=0.0)
    d2 = ((axy[:, None] - bxy[None]) ** 2).sum(-1)
    j = d2.argmin(1)
    dmin = np.sqrt(d2[np.arange(len(axy)), j])
    matched = dmin < 0.05
    cos = (ad[matched] * bd[j[matched]]).sum(1) / np.maximum(
        np.linalg.norm(ad[matched], axis=1)
        * np.linalg.norm(bd[j[matched]], axis=1), 1e-9)
    return dict(
        n_a=int(len(axy)), n_b=int(len(bxy)),
        frac_matched=round(float(matched.mean()), 4),
        max_xy_dev_matched=round(float(dmin[matched].max()), 5)
        if matched.any() else None,
        min_desc_cos=round(float(cos.min()), 5) if matched.any() else None,
        med_desc_cos=round(float(np.median(cos)), 5) if matched.any()
        else None)


def render_frames(n: int, hw):
    """The probe's ``n`` renders of the room loop at ``hw``: (K, images,
    rotations, centres)."""
    from render3d import render
    from torch_eval_real_images import make_real_room

    h, w = hw
    K = np.array([[0.94 * w, 0, w / 2], [0, 0.94 * w, h / 2], [0, 0, 1.0]])
    planes = make_real_room()
    imgs, Rs, cs = [], [], []
    for i in range(n):
        a = 2 * np.pi * i / 100.0
        c = np.array([0.5 + 1.6 * np.sin(a), 0.0, 4.0 + 1.6 * (1 - np.cos(a))])
        yaw = 0.25 * np.sin(a)
        R = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                      [-np.sin(yaw), 0, np.cos(yaw)]])
        with np.errstate(invalid="ignore", divide="ignore"):
            imgs.append(np.asarray(render(planes, K, R, -R @ c, hw=hw),
                                   np.float32))
        Rs.append(R)
        cs.append(c)
    return K, imgs, Rs, cs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=240)
    args = ap.parse_args(argv)

    import torch

    from sara_tpu_torch import resolve_device
    from sara_tpu_torch.core.types import Keypoints
    from sara_tpu_torch.features.api import (_compute_sift_batch,
                                             compute_sift_keypoints)
    from sara_tpu_torch.matching import MatchParams, match_descriptors
    from sara_tpu_torch.matching.brute_force import _match_sets
    from sara_tpu_torch.ransac import engine, estimate_relative_pose
    from sara_tpu_torch.sfm.odometry import OdometryConfig
    from sara_tpu_torch.utils.host import fetch

    dev = resolve_device(args.device)
    K, imgs, Rgt, cgt = render_frames(args.frames, (args.height,
                                                    args.width))
    sift = OdometryConfig().sift
    backend = dev.type
    out = {}

    def emit(name, **rec):
        out[name] = rec
        print(json.dumps({"probe": name, "backend": backend, **rec}),
              flush=True)

    emit("setup", frames=args.frames)

    # --- Stage 1: detection, single vs batched. ---
    stack = torch.as_tensor(np.stack(imgs)).to(dev)
    single = [compute_sift_keypoints(stack[f], sift, device=dev)
              for f in range(args.frames)]
    batched = _compute_sift_batch(stack, sift, device=dev)
    emit("detect", per_frame=[
        kp_set_distance(single[f], Keypoints(*(x[f] for x in batched)))
        for f in range(args.frames)])

    # --- Stage 2: matching on IDENTICAL (single-path) detections. ---
    mp = MatchParams(ratio=OdometryConfig().match_ratio)
    stacked = Keypoints(*(torch.stack(xs) for xs in zip(*single)))
    lefts = Keypoints(*(x[:-1] for x in stacked))
    rights = Keypoints(*(x[1:] for x in stacked))
    bj, bk, _ = _match_sets(lefts.descriptors, lefts.mask,
                            rights.descriptors, rights.mask, mp.ratio,
                            mp.mutual)
    ms_list = [match_descriptors(single[f], single[f + 1], mp, device=dev)
               for f in range(args.frames - 1)]
    pair_stats = []
    for f in range(args.frames - 1):
        sj, sk, bjf, bkf = fetch(ms_list[f].j, ms_list[f].mask, bj[f],
                                 bk[f])
        pair_stats.append(dict(
            n_single=int(sk.sum()), n_batch=int(bkf.sum()),
            mask_diff=int((sk != bkf).sum()),
            j_diff_on_common=int((sj[sk & bkf] != bjf[sk & bkf]).sum())))
    emit("match", per_pair=pair_stats)

    # --- Stage 3: E-RANSAC on identical matches + identical samples. ---
    cfg = OdometryConfig()
    Kt = torch.as_tensor(K, dtype=torch.float32, device=dev)
    us = torch.stack([single[f].xy for f in range(args.frames - 1)])
    vs = torch.stack([single[f + 1].xy[ms_list[f].j.long()]
                      for f in range(args.frames - 1)])
    masks = torch.stack([ms_list[f].mask for f in range(args.frames - 1)])
    idx, ok = engine.draw_samples(
        torch.Generator(device=dev).manual_seed(SEED), RANSAC_SAMPLES, 5,
        masks)

    def rp(pair):
        """The pose with the drawn samples: of every pair (None) as one
        batched call, or of one pair."""
        sel = slice(None) if pair is None else pair
        draw = engine.draw_samples
        engine.draw_samples = lambda *a: (idx[sel], ok[sel])
        try:
            return estimate_relative_pose(
                None, us[sel], vs[sel], masks[sel], Kt, Kt,
                threshold_px=cfg.rel_pose_threshold_px,
                num_samples=RANSAC_SAMPLES,
                min_inliers=cfg.rel_pose_min_inliers)
        finally:
            engine.draw_samples = draw

    bres, bR, bt = rp(None)
    b_ok, b_inl, b_mask, bR, bt = fetch(bres.success, bres.num_inliers,
                                        bres.inliers, bR, bt)
    r_stats = []
    for f in range(args.frames - 1):
        sres, sR, st = rp(f)
        s_ok, s_inl, s_mask, sR, st = fetch(sres.success, sres.num_inliers,
                                            sres.inliers, sR, st)
        R_rel_gt = Rgt[f + 1] @ Rgt[f].T
        t_rel_gt = -Rgt[f + 1] @ (cgt[f + 1] - cgt[f])
        t_rel_gt = t_rel_gt / np.linalg.norm(t_rel_gt)

        def ang(Ra, Rb=R_rel_gt):
            c = (np.trace(np.asarray(Ra, float) @ np.asarray(Rb, float).T)
                 - 1) / 2
            return float(np.degrees(np.arccos(np.clip(c, -1, 1))))

        def tang(tv, tw=t_rel_gt):
            tv = np.asarray(tv, float).ravel()
            tw = np.asarray(tw, float).ravel()
            c = abs(tv @ tw) / max(np.linalg.norm(tv) * np.linalg.norm(tw),
                                   1e-12)
            return float(np.degrees(np.arccos(np.clip(c, -1, 1))))

        r_stats.append(dict(
            single=dict(ok=bool(s_ok), inl=int(s_inl),
                        rot_err_deg=round(ang(sR), 4),
                        dir_err_deg=round(tang(st), 4)),
            batch=dict(ok=bool(b_ok[f]), inl=int(b_inl[f]),
                       rot_err_deg=round(ang(bR[f]), 4),
                       dir_err_deg=round(tang(bt[f]), 4)),
            batch_vs_single=dict(
                rot_deg=round(ang(bR[f], sR), 4),
                dir_deg=round(tang(bt[f], st), 4),
                inlier_mask_diff=int((b_mask[f] != s_mask).sum()))))
    emit("ransac", per_pair=r_stats)
    return out


if __name__ == "__main__":
    main()
