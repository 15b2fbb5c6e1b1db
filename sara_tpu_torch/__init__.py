"""sara_tpu_torch: the PyTorch / CUDA port of sara-tpu for NVIDIA Hopper.

A second package beside the JAX reference ``sara_tpu``. It mirrors that
package's file layout and public names, so each function has a findable
twin; it imports ``torch`` and numpy and nothing of JAX or ``sara_tpu``.
Every Pallas kernel of the reference becomes a kernel written by hand for
Hopper (``ops/csrc``), with a plain PyTorch version beside it.

Ported so far: the SIFT frontend and the brute-force matcher (Slice A),
two-view geometry (Slice B), and monocular visual odometry with bundle
adjustment (Slice C).

core      Keypoints / Matches containers, polynomial roots, SO(3)/SE(3)/Sim(3),
          camera models (pinhole, Brown-Conrady, Kannala-Brandt, omni)
image     separable filtering, transforms and dense warps, gradients,
          Gaussian/DoG pyramids, color conversion
features  DoG detection, orientation, field SIFT descriptors, the pipeline
matching  brute-force GEMM matcher (ratio test + mutual check)
mvg       minimal solvers (4/5/7/8-point, P3P), two-view geometry
ransac    batched RANSAC, ORSA and the H / F / E + pose / PnP estimators
ba        LM bundle adjustment: dense-Schur and matrix-free Schur + PCG
sfm       union-find (native C++), feature tracks, pose graph, point cloud,
          the odometry pipeline
utils     trajectory metrics (Umeyama alignment, ATE), host transfers
viz       the self-contained HTML point-cloud viewer
ops       top-k, small-matrix algebra and the CUDA patch-sampler kernels
convert   carries parameters, keypoints and BA problems over from the JAX
          package

Entry points run on the card: ``device=None`` means CUDA, and without a
card they raise instead of falling back to the CPU. Pass ``device="cpu"``
to run on the CPU.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

# The DoG detection threshold (0.01) sits far below TF32's precision, and
# cuDNN runs float32 convolutions in TF32 by default: pin full float32 for
# convolutions and matrix products (the reference pins its matmul precision
# to float32 for the same reason, sara_tpu/__init__.py).
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


def default_device() -> torch.device:
    """The CUDA device; raises RuntimeError when there is no card."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: sara_tpu_torch runs on the card "
                           "by default; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``device``, or :func:`default_device` when it is None."""
    return default_device() if device is None else torch.device(device)
