"""The SIFT frontend's traffic: frames detected in batches, pairs matched.

One general generator for every mix of the SIFT configurations; the mix's
file (``benchmark/traffic/<traffic>.json``) sets it:

- ``frames``: distinct frames rendered from the seed (stereo pairs where
  ``stereo``), cycled in order;
- ``unit_frames``: frames per unit of work (a stereo unit is one pair);
- ``batch``: frames per call of ``_compute_sift_batch``;
- ``pairs``: ``previous`` (each frame with the frame before it),
  ``stereo`` (left with right, and left with the previous left) or
  ``all`` (every pair within the unit);
- ``pair_chunk``: pairs per call of ``_match_sets`` (0: all of a unit's
  pairs in one call); a short last chunk is padded with masked pairs, as
  the port's global SfM pads its pair chunks;
- ``in_flight``: units dispatched before the oldest one's matches are read
  back to the host;
- ``check_units`` of the first ``check_span`` units of the window, drawn
  from the seed, are kept for the comparison, and within a unit of
  ``all`` pairs ``check_frames`` frames and every pair among them.

A unit's latency runs from its dispatch to its matches on the host.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from benchmark.checks import FrameCompare, match_pair
from benchmark.counts import match as match_counts
from benchmark.counts import sift as sift_counts
from benchmark.inputs import room
from benchmark.reference import match as ref_match
from benchmark.reference import sift as ref_sift


def _kp_dict(kp, row):
    return {"xy": kp.xy[row], "scale": kp.scale[row],
            "theta": kp.orientation[row], "response": kp.response[row],
            "desc": kp.descriptors[row], "mask": kp.mask[row]}


class Generator:
    def __init__(self, config, traffic, seed, device, spans):
        from sara_tpu_torch.features import api
        from sara_tpu_torch.matching import brute_force
        self.api, self.bf = api, brute_force
        self.params = dataclasses.replace(api.SIFTParams(),
                                          **config["sift"])
        self.ratio = config["match_ratio"]
        self.hw = tuple(config["image_hw"])
        self.t = traffic
        self.seed = seed
        self.dev = torch.device(device)
        self.spans = spans
        rng = np.random.default_rng(seed)
        self.sample = set(rng.choice(traffic["check_span"],
                                     traffic["check_units"],
                                     replace=False).tolist())
        self.stereo = traffic["pairs"] == "stereo"

    # -- inputs -------------------------------------------------------------

    def setup(self):
        t = self.t
        imgs = room.sequence(self.seed, t["frames"], self.dev,
                             stereo=self.stereo, hw=self.hw)
        self.images = imgs.reshape((-1,) + self.hw)   # stereo: 2t + side
        self.n_ids = self.images.shape[0]
        self.k = 0                  # units dispatched, warm-up included
        self.prev = {}              # frame id -> keypoints, last unit
        self.kp_sum = torch.zeros((), dtype=torch.float64, device=self.dev)
        self.kp_frames = 0
        self.pair_sum = torch.zeros((3,), dtype=torch.float64,
                                    device=self.dev)
        self.pairs_real = 0
        # Every shape the window uses: a unit of all pairs warms them all;
        # otherwise the second unit is the first with its cross pair.
        for _ in range(1 if t["pairs"] == "all" else 2):
            self._readback(self._dispatch(count=False))
        torch.cuda.synchronize() if self.dev.type == "cuda" else None

    def _unit_ids(self, k):
        u = self.t["unit_frames"]
        if self.stereo:
            return [2 * k, 2 * k + 1]
        return list(range(k * u, (k + 1) * u))

    def _unit_pairs(self, k, ids):
        """The unit's pairs; the very first unit has no previous frame."""
        mode = self.t["pairs"]
        if mode == "previous":
            pairs = [(i, i - 1) for i in ids]
        elif mode == "stereo":
            pairs = [(2 * k, 2 * k + 1), (2 * k, 2 * k - 2)]
        else:
            pairs = [(a, b) for n, a in enumerate(ids) for b in ids[n + 1:]]
        return [p for p in pairs if p[1] >= 0]

    def image(self, fid):
        return self.images[fid % self.n_ids]

    # -- the timed path -----------------------------------------------------

    def _dispatch(self, count=True):
        """Queue one unit's detection and matching; returns its record."""
        k = self.k
        self.k += 1
        sp = self.spans
        ids = self._unit_ids(k)
        kps = {}
        B = self.t["batch"]
        with sp.host_span("detect"):
            for a in range(0, len(ids), B):
                chunk = ids[a:a + B]
                imgs = torch.stack([self.image(i) for i in chunk])
                with sp.device_span("sift", len(chunk)):
                    kp = self.api._compute_sift_batch(imgs, self.params,
                                                      device=self.dev)
                for r, i in enumerate(chunk):
                    kps[i] = (kp, r)
                if count and sp.on:
                    self.kp_sum += kp.mask.sum()
                    self.kp_frames += len(chunk)
        known = {**self.prev, **kps}
        pairs = self._unit_pairs(k, ids)
        C = self.t["pair_chunk"] or len(pairs)
        out = []
        with sp.host_span("match"):
            for a in range(0, len(pairs), C):
                chunk = pairs[a:a + C]
                pad = C - len(chunk)

                def stack(side, f):
                    return torch.stack([f(*known[p[side]]) for p in chunk]
                                       + [f(*known[chunk[0][side]])] * pad)
                da = stack(0, lambda kp, r: kp.descriptors[r])
                db = stack(1, lambda kp, r: kp.descriptors[r])
                ma = stack(0, lambda kp, r: kp.mask[r])
                mb = stack(1, lambda kp, r: kp.mask[r])
                if pad:
                    live = torch.arange(C, device=self.dev) < len(chunk)
                    ma = ma & live[:, None]
                    mb = mb & live[:, None]
                with sp.device_span("match", len(chunk)):
                    j, ok, d1 = self.bf._match_sets(da, ma, db, mb,
                                                    self.ratio, True)
                if count and sp.on:
                    na = ma.sum(-1).double()
                    nb = mb.sum(-1).double()
                    self.pair_sum += torch.stack(
                        [(na * nb).sum(), na.sum(), nb.sum()])
                    self.pairs_real += len(chunk)
                out.append((chunk, j, ok, d1))
        self.prev = kps
        return {"k": k, "ids": ids, "kps": known, "matches": out}

    def _readback(self, unit):
        with self.spans.host_span("readback"):
            flat = torch.cat([torch.cat([j.to(torch.int32).reshape(-1),
                                         ok.to(torch.int32).reshape(-1)])
                              for _, j, ok, _ in unit["matches"]])
            return flat.cpu()

    def window(self, seconds: float):
        """Units back to back for ``seconds``, ``in_flight`` deep; returns
        the window's counts and per-unit latencies."""
        depth = self.t["in_flight"]
        k0 = self.k
        lat, frames, units = [], 0, 0
        pending = deque()
        self.kept = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds or pending:
            if time.perf_counter() - t0 < seconds:
                with self.spans.host_span("step"):
                    start = time.perf_counter()
                    pending.append((start, self._dispatch()))
            if len(pending) >= depth or (
                    pending and time.perf_counter() - t0 >= seconds):
                start, unit = pending.popleft()
                self._readback(unit)
                lat.append(time.perf_counter() - start)
                frames += len(unit["ids"])
                units += 1
                if unit["k"] - k0 in self.sample:
                    self.kept.append(unit)
        wall = time.perf_counter() - t0
        return {"wall_s": wall, "frames": frames, "units": units,
                "latency_s": lat}

    def trace_slice(self, n_units: int):
        """A steady slice of ``n_units`` units at the window's depth."""
        def run():
            depth = self.t["in_flight"]
            pending = deque()
            for _ in range(n_units):
                with self.spans.host_span("step"):
                    pending.append(self._dispatch(count=False))
                if len(pending) >= depth:
                    self._readback(pending.popleft())
            while pending:
                self._readback(pending.popleft())
        return run

    def step_fn(self):
        """One unit, dispatched and read back (for counting syncs)."""
        return lambda: self._readback(self._dispatch(count=False))

    def work(self):
        """Needed work of the traced window, per frame and per pair."""
        out = {}
        if self.kp_frames:
            n_kp = float(self.kp_sum) / self.kp_frames
            out["sift_frame"] = sift_counts.frame_work(self.hw, n_kp)
        if self.pairs_real:
            nn, na, nb = (float(v) / self.pairs_real for v in self.pair_sum)
            out["match_pair"] = match_counts.pair_work(nn, na, nb, 128)
        return out

    # -- the comparison -----------------------------------------------------

    def release(self):
        """Drop the program's state, keeping the units the check reads."""
        self.prev = {}
        torch.cuda.empty_cache() if self.dev.type == "cuda" else None

    def _checked(self, unit):
        """(frames, pairs) of a kept unit that the comparison covers."""
        ids = unit["ids"]
        if self.t["pairs"] == "all":
            rng = np.random.default_rng([self.seed, unit["k"]])
            pick = sorted(rng.choice(len(ids), self.t["check_frames"],
                                     replace=False))
            ids = [ids[i] for i in pick]
            pairs = [(a, b) for n_, a in enumerate(ids) for b in ids[n_ + 1:]]
        else:
            pairs = [p for chunk, *_ in unit["matches"] for p in chunk]
        frames = sorted({i for p in pairs for i in p} | set(ids))
        return frames, pairs

    def check(self, low: bool = False):
        """The comparison's numbers over the kept units; ``low`` puts the
        reference at TF32 in the program's place (the control)."""
        off = count = differ = compared = n_frames = n_pairs = 0
        diag = {"desc_gap": 0.0, "xy_gap": 0.0}
        for unit in self.kept:
            frames, pairs = self._checked(unit)
            ref, prog, fc = {}, {}, {}
            for f in frames:
                ref[f] = ref_sift.sift(self.image(f))
                prog[f] = (ref_sift.sift(self.image(f), low=True) if low
                           else _kp_dict(*unit["kps"][f]))
                fc[f] = c = FrameCompare(prog[f], ref[f])
                off, count = off + c.off, count + c.count
                diag["desc_gap"] = max(diag["desc_gap"], c.desc_gap)
                diag["xy_gap"] = max(diag["xy_gap"], c.xy_gap)
                n_frames += 1
            got = {}
            for chunk, j, ok, d1 in unit["matches"]:
                for r, p in enumerate(chunk):
                    got[p] = (j[r], ok[r], d1[r])
            for a, b in pairs:
                with ref_sift.precision(False):
                    want = ref_match.match(ref[a]["desc"], ref[a]["mask"],
                                           ref[b]["desc"], ref[b]["mask"],
                                           self.ratio)
                if low:
                    with ref_sift.precision(True):
                        have = ref_match.match(
                            prog[a]["desc"], prog[a]["mask"],
                            prog[b]["desc"], prog[b]["mask"], self.ratio)
                else:
                    have = got[(a, b)]
                d, n = match_pair(have, want, fc[a], fc[b])
                differ, compared = differ + d, compared + n
                n_pairs += 1
        return ({"desc_off": off / count if count else 0.0,
                 "match_off": differ / compared if compared else 0.0},
                {"frames_checked": n_frames, "pairs_checked": n_pairs,
                 "keypoints_checked": count, "matches_checked": compared,
                 **diag})
