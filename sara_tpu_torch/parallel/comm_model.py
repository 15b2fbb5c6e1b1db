"""Analytic communication/compute model for the sharded Schur BA.

Twin of ``sara_tpu/parallel/comm_model.py``, the same arithmetic with the
H100's link rates. Sharding layout (``parallel/dist_ba.py``):

- observations + points sharded over the mesh axis (point V blocks stay on
  the shard owning the point's observations),
- cameras + 6x6 U blocks replicated; per-shard partial camera
  contributions combined by all-reduce.

Per LM iteration the collectives are therefore ONE all-reduce of the
camera-side normal-equation blocks (U (C, 6, 6) + camera gradient (C, 6):
42 C floats) and, per CG iteration, one all-reduce of the camera-space
matvec partials (C, 6) plus O(1) scalars for the dot products. Replicated
traffic is O(C), independent of O and of the shard count, while per-shard
FLOPs are O(O / n) + O(C): the structure the tests hold.

The link rates are data-sheet values, not measurements: NVLink 4 between
the H100s of one host (450 GB/s per direction, NVIDIA H100 SXM data
sheet) and one 400 Gb/s NDR InfiniBand NIC per host between hosts
(50 GB/s). One H100 gives a world of one, so no scaling across GPUs has
been measured.
"""

from __future__ import annotations

from dataclasses import dataclass

from sara_tpu_torch.utils.roofline import PEAK_F32_FLOPS

NVLINK_BW = 450e9  # bytes/s per direction, NVLink 4 (H100 SXM data sheet)
NIC_BW = 50e9      # bytes/s, one 400 Gb/s NDR NIC per host: what the
                   # cross-host boundary exchanges of the partitioned BA
                   # (ba/partitioned.py) ride on


@dataclass(frozen=True)
class BACommModel:
    C: int
    P: int
    O: int
    cg_iters: int
    n: int
    dtype_bytes: int = 4

    # -- compute ------------------------------------------------------------

    def per_shard_obs_flops(self) -> float:
        """Observation-proportional work of one shard (Jacobians, W/V block
        products, CG gather terms): shrinks ~ 1/n."""
        O_shard = -(-self.O // self.n)
        jac = O_shard * 800.0
        blocks = O_shard * 260.0
        cg = self.cg_iters * O_shard * 160.0
        return jac + blocks + cg

    def per_shard_cam_flops(self) -> float:
        """Replicated camera-side work (U inverse, camera matvecs): every
        shard repeats it; O(C), independent of n."""
        return self.C * 216.0 + self.cg_iters * self.C * 72.0

    def per_shard_flops(self) -> float:
        return self.per_shard_obs_flops() + self.per_shard_cam_flops()

    # -- communication ------------------------------------------------------

    def allreduce_bytes(self) -> float:
        """Payload all-reduced per LM iteration: O(C), independent of n
        and O."""
        cam_blocks = self.C * (36 + 6) * self.dtype_bytes
        per_cg = self.cg_iters * (self.C * 6 + 4) * self.dtype_bytes
        return cam_blocks + per_cg

    def allreduce_seconds(self) -> float:
        """Ring all-reduce time: 2 (n-1)/n * bytes / link_bw."""
        if self.n <= 1:
            return 0.0
        return 2.0 * (self.n - 1) / self.n * self.allreduce_bytes() / NVLINK_BW

    def compute_seconds(self, achieved: float = 1.0) -> float:
        """Per-shard compute time at ``achieved`` fraction of the float32
        peak (1.0 = speed of light)."""
        return self.per_shard_flops() / (PEAK_F32_FLOPS * achieved)

    def scaling_efficiency(self, achieved: float = 0.05) -> float:
        """Predicted efficiency against perfect 1/n scaling of the n = 1
        work, at compute throughput ``achieved`` (a fraction of peak)."""
        t1 = BACommModel(self.C, self.P, self.O, self.cg_iters, 1,
                         self.dtype_bytes).compute_seconds(achieved)
        tn = self.compute_seconds(achieved) + self.allreduce_seconds()
        return t1 / (self.n * tn)

    def report(self) -> str:
        eff = self.scaling_efficiency()
        return (f"BA comm model C={self.C} P={self.P} O={self.O} "
                f"cg={self.cg_iters} n={self.n}: "
                f"per-shard {self.per_shard_flops()/1e9:.3f} GFLOP "
                f"(obs {self.per_shard_obs_flops()/1e9:.3f} + cam "
                f"{self.per_shard_cam_flops()/1e9:.3f}), "
                f"all-reduce {self.allreduce_bytes()/1e6:.3f} MB "
                f"({self.allreduce_seconds()*1e6:.1f} us on NVLink) "
                f"-> predicted scaling efficiency {100*eff:.1f}% "
                f"at 5%-of-roofline compute")
