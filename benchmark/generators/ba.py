"""Bundle adjustment traffic: back-to-back solves of one seeded problem.

One general generator for the BA configurations. The configuration's file
gives the problem's sizes (cameras, points, observations); the mix's file
(``benchmark/traffic/<traffic>.json``) gives ``max_iters``, the LM
iterations of each ``bundle_adjust`` call. Every solve starts from the
same seeded initial state, as an SfM user's repeated call would, and ends
with its final cost on the host. The mix's ``solver`` is passed to
``BAOptions``; the matrix-free LM loop (``core._lm_cg``) is wrapped by a
host-clock span and CUDA events, read in the traced run.
"""

from __future__ import annotations

import time

import torch

from benchmark.counts import ba as ba_counts
from benchmark.inputs import ba_problem
from benchmark.reference import ba as ref_ba


class Generator:
    def __init__(self, config, traffic, seed, device, spans):
        from sara_tpu_torch.ba import core
        self.core = core
        self.cfg = config
        self.opts = core.BAOptions(max_iters=traffic["max_iters"],
                                   solver=traffic["solver"])
        self.seed = seed
        self.dev = torch.device(device)
        self.spans = spans
        self._wrap()

    def _wrap(self):
        """Spans around the port's matrix-free LM loop, by wrapping the
        module function that ``bundle_adjust`` looks up at each call."""
        core, sp = self.core, self.spans
        if not hasattr(core, "_bench_original_lm_cg"):
            core._bench_original_lm_cg = core._lm_cg
        loop_cg = core._bench_original_lm_cg

        def timed_loop_cg(p, opts, *a, **k):
            with sp.host_span("lm"), sp.device_span("lm", opts.max_iters):
                return loop_cg(p, opts, *a, **k)
        core._lm_cg = timed_loop_cg

    def setup(self):
        c = self.cfg
        self.d = ba_problem.make(c["cameras"], c["points"],
                                 c["observations"], self.seed, self.dev)
        d = self.d
        O, P = d["uv"].shape[0], d["points"].shape[0]
        self.problem = self.core.BAProblem(
            poses=d["poses"], points=d["points"], intrinsics=d["intrinsics"],
            cam_idx=d["cam_idx"], pt_idx=d["pt_idx"], uv=d["uv"],
            obs_mask=torch.ones(O, dtype=torch.bool, device=self.dev),
            pose_fixed=d["cam_fixed"],
            point_fixed=torch.zeros(P, dtype=torch.bool, device=self.dev))
        self.result = self._solve()          # warms every shape

    def _solve(self):
        q, info = self.core.bundle_adjust(self.problem, self.opts)
        with self.spans.host_span("readback"):
            info["final_cost"].item()
        return q

    def window(self, seconds: float):
        """Whole solves back to back until ``seconds`` have passed."""
        solves = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            with self.spans.host_span("step"):
                self.result = self._solve()
            solves += 1
        return {"wall_s": time.perf_counter() - t0, "solves": solves,
                "iterations": solves * self.opts.max_iters}

    def trace_slice(self, n_units: int):
        def run():
            for _ in range(n_units):
                with self.spans.host_span("step"):
                    self._solve()
        return run

    def step_fn(self):
        return self._solve

    def work(self):
        d = self.d
        C, P, O = (d["poses"].shape[0], d["points"].shape[0],
                   d["uv"].shape[0])
        return {"ba_iteration": ba_counts.cg_iteration_work(
            C, P, O, self.opts.cg_iters)}

    def release(self):
        q = self.result
        self.final = (q.poses.detach(), q.points.detach())
        self.problem = self.result = None
        torch.cuda.empty_cache() if self.dev.type == "cuda" else None

    def check(self, low: bool = False):
        """``pose_gap`` and ``point_gap_median`` of the last solve of the
        window against the reference's solve from the same initial state;
        ``low`` puts the reference with TF32 operands in the program's
        place (the control)."""
        d = self.d
        args = (d["intrinsics"], d["cam_idx"], d["pt_idx"], d["uv"])
        n = self.opts.max_iters
        if not hasattr(self, "ref_cost"):
            rp, rx, _ = ref_ba.solve(d["poses"], d["points"], *args,
                                     d["cam_fixed"], n)
            self.ref_cost = float(ref_ba.cost(rp, rx, *args))
            self.ref_points, self.ref_poses = rx, rp
        ref_cost = self.ref_cost
        if low:
            pp, px, _ = ref_ba.solve(d["poses"], d["points"], *args,
                                     d["cam_fixed"], n,
                                     low=True)
        else:
            pp, px = self.final
        prog_cost = float(ref_ba.cost(pp, px, *args))
        init_cost = float(ref_ba.cost(d["poses"], d["points"], *args))

        def rms_gap(a, b, start):
            return float((a.double() - b).pow(2).sum(-1).mean().sqrt()
                         / (b - start.double()).pow(2).sum(-1).mean().sqrt())
        free = ~d["cam_fixed"]
        px_gap = (px.double() - self.ref_points).norm(dim=-1)
        px_move = (self.ref_points - d["points"].double()).norm(dim=-1)
        return ({"pose_gap": rms_gap(pp[free], self.ref_poses[free],
                                     d["poses"][free]),
                 "point_gap_median": float(px_gap.median()
                                           / px_move.median())},
                {"cost_initial": init_cost, "cost_reference": ref_cost,
                 "cost_program": prog_cost,
                 "cost_gap": abs(prog_cost - ref_cost) / ref_cost,
                 "point_gap_rms": rms_gap(px, self.ref_points,
                                          d["points"])})
