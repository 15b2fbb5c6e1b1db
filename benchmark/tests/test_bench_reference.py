"""The plain reference against the port on the CPU at small sizes, and
the comparison's own arithmetic on cases whose answer is known."""

from __future__ import annotations

import torch

from benchmark import checks
from benchmark.inputs import ba_problem, room
from benchmark.reference import ba as ref_ba
from benchmark.reference import match as ref_match
from benchmark.reference import sift as ref_sift


def _port_kp(frames):
    from sara_tpu_torch.features.api import SIFTParams, _compute_sift_batch
    return _compute_sift_batch(frames, SIFTParams(), device="cpu")


def test_reference_sift_and_matches_agree_with_the_port():
    from sara_tpu_torch.matching.brute_force import _match_sets
    frames = room.sequence(2 ** 32 + 3, 8, "cpu", hw=(64, 200))[:2]
    kp = _port_kp(frames)
    refs, fcs = [], []
    for b in range(2):
        ref = ref_sift.sift(frames[b])
        prog = {"xy": kp.xy[b], "scale": kp.scale[b],
                "theta": kp.orientation[b], "desc": kp.descriptors[b],
                "mask": kp.mask[b]}
        fc = checks.FrameCompare(prog, ref)
        assert int(ref["mask"].sum()) > 100
        assert fc.off == 0 and fc.desc_gap < 1e-5
        refs.append(ref)
        fcs.append(fc)
    j, ok, d1 = _match_sets(kp.descriptors[:1], kp.mask[:1],
                           kp.descriptors[1:], kp.mask[1:], 0.8, True)
    want = ref_match.match(refs[0]["desc"], refs[0]["mask"],
                           refs[1]["desc"], refs[1]["mask"])
    rok = want[1]
    missed, counted = checks.match_pair((j[0], ok[0], d1[0]), want, *fcs)
    assert missed == 0 and counted == 2 * int(rok.sum()) > 20


def test_reference_ba_agrees_with_the_port():
    from sara_tpu_torch.ba import BAOptions, BAProblem, bundle_adjust
    d = ba_problem.make(12, 1500, 8000, 2 ** 34 + 1, "cpu")
    p = BAProblem(poses=d["poses"], points=d["points"],
                  intrinsics=d["intrinsics"], cam_idx=d["cam_idx"],
                  pt_idx=d["pt_idx"], uv=d["uv"],
                  obs_mask=torch.ones(8000, dtype=torch.bool),
                  pose_fixed=d["cam_fixed"],
                  point_fixed=torch.zeros(1500, dtype=torch.bool))
    q, _ = bundle_adjust(p, BAOptions(max_iters=10))
    args = (d["intrinsics"], d["cam_idx"], d["pt_idx"], d["uv"])
    rp, rx, costs = ref_ba.solve(d["poses"], d["points"], *args,
                                 d["cam_fixed"], 10)
    c0 = float(ref_ba.cost(d["poses"], d["points"], *args))
    cr = float(ref_ba.cost(rp, rx, *args))
    cp = float(ref_ba.cost(q.poses, q.points, *args))
    assert costs == sorted(costs, reverse=True) and cr < 0.1 * c0
    assert abs(cp - cr) / cr < 1e-3
    # Each point is seen by two distinct cameras at least.
    n = torch.bincount(d["pt_idx"].long(), minlength=1500)
    assert int(n.min()) >= 2


def test_problem_and_frames_repeat_for_a_seed():
    a = ba_problem.make(8, 300, 1000, 2 ** 40 + 9, "cpu")
    b = ba_problem.make(8, 300, 1000, 2 ** 40 + 9, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    f = room.sequence(2 ** 40 + 9, 2, "cpu", hw=(32, 96))
    assert torch.equal(f, room.sequence(2 ** 40 + 9, 2, "cpu", hw=(32, 96)))


def _kp(xy, theta, mask, desc=None):
    n = len(xy)
    return {"xy": torch.tensor(xy, dtype=torch.float32),
            "scale": torch.full((n,), 2.0), "theta": torch.tensor(theta),
            "desc": torch.eye(n, 4) if desc is None else desc,
            "mask": torch.tensor(mask)}


def test_twins_and_offs_by_hand():
    a = _kp([[1, 1], [5, 5], [9, 9]], [0.0, 1.0, 2.0], [True, True, True])
    b = _kp([[1, 1], [5.5, 5], [9, 9]], [0.0, 1.0, -2.0],
            [True, True, False])
    fc = checks.FrameCompare(a, b)
    assert fc.ta.tolist() == [0, -1, -1] and fc.tb.tolist() == [0, -1, -1]
    # Off: a's rows 1 and 2 (no twin) and b's row 1 (no twin); b's row 2
    # is masked. Checked: a's three rows and b's untwinned valid row.
    assert (fc.off, fc.count) == (3, 4) and fc.desc_gap == 0.0
    c = _kp([[1, 1], [5, 5]], [0.0, 1.0], [True, True],
            torch.tensor([[1.0, 0, 0, 0], [0.6, 0.8, 0, 0]]))
    d = _kp([[1, 1], [5, 5]], [0.0, 1.0], [True, True],
            torch.tensor([[1.0, 0, 0, 0], [0.6, 0.8 + 1e-4, 0, 0]]))
    fc = checks.FrameCompare(c, d)
    assert fc.off == 1 and fc.off_at(1e-3) == 0


def test_match_pair_by_hand():
    a = _kp([[1, 1], [5, 5], [9, 9]], [0.0, 1.0, 2.0], [True] * 3)
    fc = checks.FrameCompare(a, a)
    j = torch.tensor([1, 2, 0])
    ok = torch.tensor([True, True, False])
    d1 = torch.tensor([0.1, 0.2, 0.3])
    assert checks.match_pair((j, ok, d1), (j, ok, d1), fc, fc) == (0, 4)
    # Row 0 matched elsewhere and row 2 matched by one side only: the
    # program's 0 -> 2 and 2 -> 0 are not the reference's, whose 0 -> 1
    # the program does not make.
    assert checks.match_pair((torch.tensor([2, 2, 0]), torch.tensor(
        [True, True, True]), d1), (j, ok, d1), fc, fc) == (3, 5)
    # The same matches at a distance 1e-4 away: one program match off.
    far = d1 + torch.tensor([0.0, 1e-4, 0.0])
    assert checks.match_pair((j, ok, far), (j, ok, d1), fc, fc) == (1, 4)
