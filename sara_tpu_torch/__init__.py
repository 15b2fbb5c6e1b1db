"""sara_tpu_torch: the PyTorch / CUDA port of sara-tpu for NVIDIA Hopper.

A second package beside the JAX reference ``sara_tpu``. It mirrors that
package's file layout and public names, so each function has a findable
twin; it imports ``torch`` and numpy and nothing of JAX or ``sara_tpu``.
Every Pallas kernel of the reference becomes a kernel written by hand for
Hopper (``ops/csrc``), with a plain PyTorch version beside it.

Every module of ``sara_tpu`` has its twin here: the SIFT frontend and the
brute-force matcher (Slice A), two-view geometry (Slice B), monocular
visual odometry with bundle adjustment (Slice C), loop closure and global
SfM (Slice D1), the partitioned and distributed bundle adjusters (Slice
D2), checkpoints (Slice D3), camera calibration end to end (Slice E),
detection, tracking and the feature extras (Slice F), and contours,
segmentation, superpixels, Deriche smoothing, GEMM convolution and level
sets (E3). The demos in ``examples/`` have twins there, ``torch_*.py``.

core      Keypoints / Matches containers, polynomial roots, SO(3)/SE(3)/Sim(3),
          camera models (pinhole, Brown-Conrady, Kannala-Brandt, omni),
          2-D geometry (hulls, RDP, clipping, exact ellipse intersection),
          contours (border following, boundaries, circle fit, polylines)
image     separable and dense filtering, transforms and dense warps,
          differential operators (Harris, Hessian, curvature),
          Gaussian/DoG/LoG pyramids, color conversion, Canny and Hough,
          edge chains and line segments, Deriche smoothing, im2col GEMM
          convolution, Otsu / adaptive thresholds, watershed and CCL,
          SLIC superpixels, level sets (fast sweeping, fluxes, narrow band)
calib     chessboard corners, square reconstruction, pinhole and
          omnidirectional calibration, the CLI (``calib/cli.py``)
features  DoG detection, orientation, field SIFT descriptors, the pipeline
matching  brute-force GEMM matcher (ratio test + mutual check)
mvg       minimal solvers (4/5/7/8-point, P3P), two-view geometry
ransac    batched RANSAC, ORSA and the H / F / E + pose / PnP estimators
ba        LM bundle adjustment: dense-Schur and matrix-free Schur + PCG,
          keyframe/map-block partitioned BA
sfm       union-find (native C++), feature tracks, pose graph, point cloud,
          the odometry pipeline, SE(3)/Sim(3) pose-graph optimization,
          loop closure (VLAD retrieval, metric loop edges), rotation
          averaging, edge scales, the global SfM pipeline
parallel  device meshes on torch.distributed (NCCL on the card, gloo on
          the CPU), sharded BA, batched matching over pairs
io        image and video readers / writers (PIL, cv2), checkpoint / resume
          of the odometry state
utils     trajectory metrics (Umeyama alignment, ATE), host transfers,
          timers and traces, logging, roofline estimates, 1-D clustering,
          ADMM
config    the typed pipeline configuration and its JSON round trip
viz       the self-contained HTML point-cloud viewer
ops       top-k, small-matrix algebra and the CUDA patch-sampler kernels
convert   carries parameters, keypoints, BA and pose-graph problems over
          from the JAX package

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
    """``device``, or :func:`default_device` when it is None. A CUDA
    device raises without a card, as None does."""
    if device is None:
        return default_device()
    dev = torch.device(device)
    if dev.type == "cuda":
        default_device()
    return dev
