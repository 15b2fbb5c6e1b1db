"""The comparisons that decide ``correct``: the program's outputs against
the plain reference's, number by number.

SIFT. Keypoints of the program and of the reference pair up as twins when
both are valid and agree within 0.01 px in position, 1e-3 in relative
scale and 1e-3 rad in orientation; a twin's descriptor gap is the L2
distance between the two unit descriptors.
- ``desc_off``: keypoints that are off, over all keypoints checked: a
  valid keypoint of either side without a twin, or a twin whose
  descriptor gap exceeds ``DESC_TOL``;
- ``match_off``: matches that are off, over both sides' matches: a match
  that one side makes and the other does not make between the same twins,
  or a program match that the reference makes at a squared distance more
  than ``DIST_TOL`` away from the program's. A match is left out where
  one of its keypoints, or the keypoint that the other side matches its
  first keypoint to, has no twin or a gap above ``FLIP_TOL`` (flipped):
  such a keypoint is already counted by ``desc_off``, and a descriptor
  sampled one pixel over takes its matches with it. Ratio-test and mutual
  decisions part at the same rare rows under a descriptor change of 1e-5
  as under TF32; the distances part the two by orders of magnitude.

Bundle adjustment. The program's final state against the reference's
solve from the same initial state:
- ``pose_gap``: the RMS distance between the two sides' free camera
  parameters (angle-axis and translation), over the RMS distance the
  reference moved them;
- ``point_gap_median``: the median point's distance between the two
  sides, over the median point's distance the reference moved it. It
  catches a fault in the points' update that leaves the poses right. The
  RMS over points (``point_gap_rms``, shown but not compared) swings from
  run to run of one seed with the few points that two close cameras see,
  and reads within 2x of the control (PERF.md). The gap in cost is second
  order in the state's and does not part the control from the program.
"""

from __future__ import annotations

import math

import torch

XY_TOL = 0.01
SCALE_TOL = 1e-3
THETA_TOL = 1e-3
DESC_TOL = 5e-5
FLIP_TOL = 1e-3
DIST_TOL = 5e-5


def twins(a: dict, b: dict, rows: int = 1024):
    """(twin in b of each row of a, or -1; twin in a of each row of b)."""
    n, m = a["mask"].shape[0], b["mask"].shape[0]
    ta = torch.full((n,), -1, dtype=torch.long, device=a["xy"].device)
    tb = torch.full((m,), -1, dtype=torch.long, device=a["xy"].device)
    for i in range(0, n, rows):
        sl = slice(i, i + rows)
        d = (a["xy"][sl, None, :] - b["xy"][None, :, :]).abs().amax(-1)
        dth = torch.remainder(a["theta"][sl, None] - b["theta"][None, :]
                              + math.pi, 2 * math.pi) - math.pi
        ok = ((d <= XY_TOL)
              & ((a["scale"][sl, None] - b["scale"][None, :]).abs()
                 <= SCALE_TOL * b["scale"][None, :].abs())
              & (dth.abs() <= THETA_TOL)
              & a["mask"][sl, None] & b["mask"][None, :])
        ta[sl] = torch.where(ok.any(1), ok.int().argmax(1), ta[sl])
        tb = torch.where(ok.any(0) & (tb < 0), ok.int().argmax(0) + i, tb)
    return ta, tb


class FrameCompare:
    """One frame's twins, descriptor gaps and flipped keypoints."""

    def __init__(self, prog: dict, ref: dict):
        self.ta, self.tb = twins(prog, ref)
        paired = self.ta >= 0
        gap = torch.full(self.ta.shape, math.inf, device=self.ta.device)
        gap[paired] = torch.linalg.vector_norm(
            prog["desc"][paired] - ref["desc"][self.ta[paired]], dim=-1)
        pm, rm = prog["mask"], ref["mask"]
        ref_gap = torch.full(self.tb.shape, math.inf, device=gap.device)
        back = self.tb >= 0
        ref_gap[back] = gap[self.tb[back]]
        self.prog_flip = pm & ~(gap <= FLIP_TOL)
        self.ref_flip = rm & ~(ref_gap <= FLIP_TOL)
        self._pm, self.gap = pm, gap
        self._ref_alone = int((rm & (self.tb < 0)).sum())
        self.off = self.off_at(DESC_TOL)
        self.count = int(pm.sum()) + self._ref_alone
        twin_gap = gap[pm & paired]
        self.desc_gap = float(twin_gap.max()) if twin_gap.numel() else 0.0
        self.xy_gap = (float((prog["xy"][paired]
                              - ref["xy"][self.ta[paired]]).abs().max())
                       if bool(paired.any()) else 0.0)


    def off_at(self, tol: float) -> int:
        """Keypoints off at descriptor tolerance ``tol``."""
        return int((self._pm & ~(self.gap <= tol)).sum()) + self._ref_alone


def match_pair(prog, ref, fa: FrameCompare, fb: FrameCompare):
    """(matches off, matches counted) of one pair (frames a -> b); ``prog``
    and ``ref`` are each side's (j, ok, d1). A program match i -> j is
    made by the reference when the reference matches i's twin to j's
    twin, and back. A match is not counted where its keypoints, or the
    keypoint that the other side matches its first keypoint to, are
    flipped."""
    pj, pok, pd = prog
    rj, rok, rd = ref
    i = torch.nonzero(pok).view(-1)
    ra, rb = fa.ta[i], fb.ta[pj[i]]
    rac = ra.clamp(min=0)
    keep = ~fa.prog_flip[i] & ~fb.prog_flip[pj[i]] & ~(
        (ra >= 0) & rok[rac] & fb.ref_flip[rj[rac]])
    seen = ((ra >= 0) & (rb >= 0) & rok[rac] & (rj[rac] == rb)
            & ((pd[i] - rd[rac]).abs() <= DIST_TOL))
    k = torch.nonzero(rok).view(-1)
    pa, pb = fa.tb[k], fb.tb[rj[k]]
    pac = pa.clamp(min=0)
    keep_r = ~fa.ref_flip[k] & ~fb.ref_flip[rj[k]] & ~(
        (pa >= 0) & pok[pac] & fb.prog_flip[pj[pac]])
    back = (pa >= 0) & (pb >= 0) & pok[pac] & (pj[pac] == pb)
    missed = int((keep & ~seen).sum()) + int((keep_r & ~back).sum())
    return missed, int(keep.sum()) + int(keep_r.sum())


def verdict(numbers: dict, limits: dict):
    """[(name, value, limit)], and whether every value is within its
    limit (a value that is not a number fails)."""
    rows = [(k, float(v), float(limits[k])) for k, v in numbers.items()]
    ok = all(math.isfinite(v) and v <= lim for _, v, lim in rows)
    return rows, ok
