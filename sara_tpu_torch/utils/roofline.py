"""Roofline accounting for the hot pipelines.

Twin of ``sara_tpu/utils/roofline.py``: FLOPs and HBM bytes of one BA LM
iteration, one SIFT frontend frame and one matched pair, compared with a
device's roofline bound max(flops / peak_flops, bytes / peak_bw).

Peaks are the NVIDIA H100 SXM data sheet's: 67 TFLOP/s float32 (CUDA
cores), 989 TFLOP/s dense bfloat16 (tensor cores), 3.35 TB/s HBM3. The
estimates' operation counts are the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass

PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BW = 3.35e12


@dataclass(frozen=True)
class Estimate:
    flops: float
    bytes: float
    note: str = ""

    def roofline_seconds(self, peak_flops: float = PEAK_F32_FLOPS,
                         peak_bw: float = PEAK_HBM_BW) -> float:
        return max(self.flops / peak_flops, self.bytes / peak_bw)

    def bound(self, peak_flops: float = PEAK_F32_FLOPS,
              peak_bw: float = PEAK_HBM_BW) -> str:
        return ("compute" if self.flops / peak_flops
                > self.bytes / peak_bw else "memory")

    def achieved_fraction(self, measured_seconds: float,
                          peak_flops: float = PEAK_F32_FLOPS,
                          peak_bw: float = PEAK_HBM_BW) -> float:
        """roofline_time / measured: 1.0 means speed of light."""
        return self.roofline_seconds(peak_flops, peak_bw) / max(
            measured_seconds, 1e-12)


def ba_lm_iteration(C: int, P: int, O: int, cg_iters: int,
                    dtype_bytes: int = 4) -> Estimate:
    """One LM iteration of ``ba.core.bundle_adjust_cg``: per observation
    the residual and Jacobians (~800 flops), the U/V/W block products
    (~260) and per CG iteration the matrix-free Schur matvec; memory is
    dominated by the Jacobian and W arrays, W re-read per CG iteration."""
    jac_flops = O * 800.0
    block_flops = O * 260.0
    cg_flops = cg_iters * (O * 160.0 + C * 72.0 + P * 18.0)
    inv_flops = C * 216.0 + P * 27.0
    flops = jac_flops + block_flops + cg_flops + inv_flops

    w_bytes = O * 18 * dtype_bytes          # (O, 6, 3)
    jac_bytes = O * (12 + 6 + 2) * dtype_bytes
    cg_bytes = cg_iters * (O * 18 * dtype_bytes       # re-read W
                           + (C * 36 + P * 9) * dtype_bytes)
    bytes_ = 2 * jac_bytes + 2 * w_bytes + cg_bytes
    return Estimate(flops, bytes_, f"BA C={C} P={P} O={O} cg={cg_iters}")


def sift_frame(H: int, W: int, scales: int = 3, first_octave: int = -1,
               keypoints: int = 2048) -> Estimate:
    """One SIFT frontend frame (pyramid + DoG + orientation + descriptor),
    with the reference's operation counts: ~24-tap effective blurs,
    orientation maps at stride 2, nearest descriptor row gathers; octave
    areas sum to ~4/3 of the base octave (x4 when first_octave=-1)."""
    area = float(H * W) * (4.0 if first_octave < 0 else 1.0) * 4.0 / 3.0
    G = scales + 3
    blur_flops = area * (G - 1) * 2 * 2 * 24        # ~24-tap effective band
    dog_flops = area * (G - 1) * 2
    grad_flops = area * (G - 2) * 8
    ori_maps_flops = area / 4.0 * scales * 36 * 2 * 2 * 12  # ds=2 maps
    desc_flops = keypoints * 64 * 36 * 4
    flops = blur_flops + dog_flops + grad_flops + ori_maps_flops + desc_flops

    pyr_bytes = area * G * 4 * 2
    ori_bytes = area / 4.0 * scales * 36 * 2 * 2     # bf16 dense maps
    desc_bytes = keypoints * (16 * 36 * 2 + 128 * 4)
    bytes_ = pyr_bytes + ori_bytes + desc_bytes
    return Estimate(flops, bytes_,
                    f"SIFT {H}x{W} fo={first_octave} K={keypoints}")


def match_pair(k1: int, k2: int, dim: int = 128,
               dtype_bytes: int = 4) -> Estimate:
    """Brute-force descriptor matching of a (k1, dim) x (k2, dim) pair:
    one GEMM + top-2 row reductions + mutual check."""
    gemm_flops = 2.0 * k1 * k2 * dim
    reduce_flops = 4.0 * k1 * k2
    flops = gemm_flops + reduce_flops
    bytes_ = (k1 + k2) * dim * dtype_bytes + k1 * k2 * dtype_bytes
    return Estimate(flops, bytes_, f"match {k1}x{k2} d={dim}")


def report(name: str, est: Estimate, measured_seconds: float,
           peak_flops: float = PEAK_F32_FLOPS) -> str:
    frac = est.achieved_fraction(measured_seconds, peak_flops)
    return (f"{name}: {est.flops/1e9:.2f} GFLOP, {est.bytes/1e6:.1f} MB -> "
            f"roofline {est.roofline_seconds(peak_flops)*1e3:.2f} ms "
            f"({est.bound(peak_flops)}-bound), measured "
            f"{measured_seconds*1e3:.2f} ms, {100*frac:.1f}% of roofline")
