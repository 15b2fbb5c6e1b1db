"""Bilinear field-patch sampler: kernels K1 and K2 written by hand for
Hopper.

Twin of ``sara_tpu/ops/patch_sampler.py``. The descriptor stage reads, for
K keypoints, N bilinear samples of contiguous C-channel rows from one scale
slice of a dense (S, H, W, C) field:

    out[k, n, c] = sum_{a,b} tri(y - a) * tri(x - b) * maps[s_k, a, b, c]

with the coordinates clamped to the map first (clamp-to-edge).

On a CUDA tensor :func:`sample_field_patches` launches a kernel of
``csrc/patch_sampler.cu`` (built by ``_build`` at first use): K1, which
replaces the TPU kernel ``_sampler_kernel`` in its plain mode, or, with
``pack_x=True`` where the reference's layout rule allows it, K2, which
replaces its x-packed mode (the field read as (S, H, W/2, 2C) cells of
x-pairs). Each comes in two variants: the vector variant (a team of C/4
lanes per sample, 16-byte taps), taken wherever :func:`vector_layout_ok`
holds, and the general variant (one thread per output element) for the
layouts it cannot read. The TPU kernel staged one window per keypoint in
VMEM and declined geometries whose window did not fit; the CUDA kernels
read their taps straight from device memory, so they sample every geometry
and never return ``None``. On a CPU tensor the wrapper takes the plain
version of the kernel it would launch, and only because the tensor lies on
the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from sara_tpu_torch.ops import _build

# Launches of each CUDA kernel in this process, by kernel and variant; a
# run reads them to show that its path went through the kernels.
LAUNCHES = 0                  # K1, vector variant
GENERAL_LAUNCHES = 0          # K1, general variant
PACKED_LAUNCHES = 0           # K2, vector variant
PACKED_GENERAL_LAUNCHES = 0   # K2, general variant
# Copies of s_idx the wrapper made on the card (an index that is neither
# int32 nor int64, or not contiguous); the kernels read int32 and int64 in
# place.
INDEX_COPIES = 0

_DTYPE_SUFFIX = {torch.float32: "_f32", torch.bfloat16: "_bf16"}
_INDEX_SUFFIX = {torch.int32: "", torch.int64: "_i64"}
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
# The library's ctypes functions by entry name, argtypes and restype set
# once.
_ENTRIES: dict = {}

# The reference's budget for its double-buffered VMEM window scratch; kept
# only for :func:`tpu_window_fits`.
_VMEM_SCRATCH_BUDGET = 8 * 1024 * 1024


def patch_extent(max_sample_radius: float) -> int:
    """Smallest square window side of the reference's TPU kernel covering
    samples within ``max_sample_radius`` map pixels of the centre (+1 px
    bilinear support, +1 px origin rounding); -1 if none does."""
    need = 2 * (int(max_sample_radius + 2.0)) + 2
    for side in (8, 16, 24, 32, 40, 48, 64):
        if side >= need:
            return side
    return -1


def _fit_block(block: int, per_patch_bytes: int) -> int:
    """Largest BK <= block whose double-buffered scratch fits the budget
    (0 if even BK=1 does not fit)."""
    return int(min(block, max(0, _VMEM_SCRATCH_BUDGET
                              // (2 * per_patch_bytes))))


def tpu_window_fits(shape, itemsize: int, max_sample_radius: float,
                    block: int = 8) -> bool:
    """Whether the reference's plain-mode dispatcher samples (S, H, W, C)
    maps of ``itemsize``-byte entries with its TPU kernel (True) or
    declines the geometry and leaves its caller to row gathers (False).

    The port's kernels sample every geometry; a caller uses this plain
    shape test only where the reference's fallback computes a different
    function (nearest-sampled descriptors).
    """
    _, H, W, C = shape
    side = patch_extent(max_sample_radius)
    if side < 0 or H < side or W < side + 8 or W % 8 != 0:
        return False
    Cp = -(-C // 128) * 128
    return _fit_block(block, side * (side + 8) * Cp * itemsize) > 0


def packed_layout_ok(shape) -> bool:
    """The reference's rule for the x-packed mode: 2C <= 128 lanes and a
    width that is a multiple of 16. Elsewhere ``pack_x`` takes K1."""
    _, _, W, C = shape
    return 2 * C <= 128 and W % 16 == 0


def counts() -> dict[str, int]:
    """The launch counts by kernel and variant, and the index copies."""
    return {"K1": LAUNCHES, "K1 general": GENERAL_LAUNCHES,
            "K2": PACKED_LAUNCHES, "K2 general": PACKED_GENERAL_LAUNCHES,
            "index copies": INDEX_COPIES}


def reset_counts() -> None:
    global LAUNCHES, GENERAL_LAUNCHES, PACKED_LAUNCHES
    global PACKED_GENERAL_LAUNCHES, INDEX_COPIES
    LAUNCHES = GENERAL_LAUNCHES = PACKED_LAUNCHES = 0
    PACKED_GENERAL_LAUNCHES = INDEX_COPIES = 0


def vector_layout_ok(maps: torch.Tensor) -> bool:
    """Whether the vector variant reads ``maps``: C a positive multiple of 4
    (a lane's four channels) and at most 1024 (a team fits one block), and a
    base address aligned for its 16-byte (float32) or 8-byte (bfloat16)
    loads. Elsewhere the general variant runs."""
    C = maps.shape[-1]
    return (0 < C <= 1024 and C % 4 == 0
            and maps.data_ptr() % (4 * maps.element_size()) == 0)


def _sample_patches_reference(maps: torch.Tensor, s_idx: torch.Tensor,
                              ys: torch.Tensor,
                              xs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: four flat row gathers, f32 weights."""
    S, H, W, C = maps.shape
    K, N = ys.shape
    s = s_idx.long().clamp(0, S - 1)
    yc = ys.clamp(0.0, H - 1.0)
    xc = xs.clamp(0.0, W - 1.0)
    y0 = torch.floor(yc).long()
    x0 = torch.floor(xc).long()
    y1 = torch.clamp(y0 + 1, max=H - 1)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    fy = (yc - y0)[..., None]
    fx = (xc - x0)[..., None]
    flat = maps.reshape(S * H * W, C)
    base = s[:, None] * (H * W)

    def take(yy, xx):
        rows = (base + yy * W + xx).reshape(-1)
        return flat.index_select(0, rows).reshape(K, N, C).float()

    return (take(y0, x0) * (1 - fx) * (1 - fy) + take(y0, x1) * fx * (1 - fy)
            + take(y1, x0) * (1 - fx) * fy + take(y1, x1) * fx * fy)


def _sample_patches_packed_reference(maps: torch.Tensor,
                                     s_idx: torch.Tensor, ys: torch.Tensor,
                                     xs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2, independent of K1's: gathers from the
    (S, H, W/2, 2C) cell view, weights each cell's even half by
    tri(2a - x) and its odd half by tri(2a + 1 - x), and recombines the
    halves, as the TPU formula does."""
    S, H, W, C = maps.shape
    K, N = ys.shape
    Wc = W // 2
    cells = maps.reshape(S * H * Wc, 2 * C)
    s = s_idx.long().clamp(0, S - 1)
    yc = ys.clamp(0.0, H - 1.0)
    xc = xs.clamp(0.0, W - 1.0)
    y0 = torch.floor(yc).long()
    a0 = torch.floor(xc).long() // 2
    base = s[:, None] * (H * Wc)

    def tri(d):
        return torch.clamp(1.0 - d.abs(), min=0.0)[..., None]

    out = 0.0
    for dy in (0, 1):
        row = torch.clamp(y0 + dy, max=H - 1)
        wy = tri(yc - (y0 + dy))
        for da in (0, 1):
            a = a0 + da        # cell past the row: clamped, weight 0
            take = cells.index_select(0, (base + row * Wc + torch.clamp(
                a, max=Wc - 1)).reshape(-1)).reshape(K, N, 2 * C).float()
            out = out + wy * (tri(2.0 * a - xc) * take[..., :C]
                              + tri(2.0 * a + 1.0 - xc) * take[..., C:])
    return out


def _entry(name: str, argtypes=_ARGTYPES):
    fn = _ENTRIES.get(name)
    if fn is None:
        fn = getattr(_build.load("patch_sampler"), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _ENTRIES[name] = fn
    return fn


def _launch(maps: torch.Tensor, s_idx: torch.Tensor, ys: torch.Tensor,
            xs: torch.Tensor, packed: bool = False,
            vector: bool = True) -> torch.Tensor:
    """Launch one variant of K1 or K2 on checked CUDA inputs (``s_idx``
    int32 or int64, contiguous) and count it."""
    global LAUNCHES, GENERAL_LAUNCHES, PACKED_LAUNCHES, PACKED_GENERAL_LAUNCHES
    S, H, W, C = maps.shape
    K, N = ys.shape
    name = ("sara_sample_patches" + ("_packed" if packed else "")
            + ("_vec" if vector else "") + _DTYPE_SUFFIX[maps.dtype]
            + _INDEX_SUFFIX[s_idx.dtype])
    fn = _entry(name)
    out = torch.empty((K, N, C), dtype=torch.float32, device=maps.device)
    with torch.cuda.device(maps.device):
        stream = torch.cuda.current_stream(maps.device).cuda_stream
        err = fn(maps.data_ptr(), s_idx.data_ptr(), ys.data_ptr(),
                 xs.data_ptr(), out.data_ptr(), S, H, W, C, K, N, stream)
    if err != 0:
        raise RuntimeError(f"patch_sampler kernel {name} launch failed: "
                           f"cudaError_t {err}")
    if packed and vector:
        PACKED_LAUNCHES += 1
    elif packed:
        PACKED_GENERAL_LAUNCHES += 1
    elif vector:
        LAUNCHES += 1
    else:
        GENERAL_LAUNCHES += 1
    return out


def _sample_on_card(maps: torch.Tensor, s_idx: torch.Tensor,
                    ys: torch.Tensor, xs: torch.Tensor,
                    packed: bool) -> torch.Tensor:
    """The card's side of :func:`sample_field_patches`: layout checks, the
    index as it comes (int32 or int64), and the variant
    :func:`vector_layout_ok` picks."""
    global INDEX_COPIES
    if not (maps.is_contiguous() and ys.is_contiguous()
            and xs.is_contiguous()):
        raise ValueError("maps, ys and xs must be contiguous")
    check_launch_size(maps.shape, *ys.shape)
    if s_idx.dtype not in _INDEX_SUFFIX or not s_idx.is_contiguous():
        s_idx = s_idx.to(torch.int32).contiguous()
        INDEX_COPIES += 1
    return _launch(maps, s_idx, ys, xs, packed=packed,
                   vector=vector_layout_ok(maps))


def check_launch_size(shape, K: int, N: int) -> None:
    """Raise where a launch on (S, H, W, C) maps with K x N samples would
    overflow the kernels' 32-bit indices: their sample index k * N + n and
    pixel index (s * H + y) * W + x are ``int`` (the element offset, times
    C, is 64-bit), and the general variant's grid of 256-thread blocks over
    K * N * C stays below 2^31 blocks. A frame-folded field counts all its
    B * S slices."""
    S, H, W, C = shape
    if K * N >= 2 ** 31 or S * H * W >= 2 ** 31 or K * N * C >= 2 ** 39:
        raise ValueError(
            f"K * N = {K * N} samples or S * H * W = {S * H * W} pixels of "
            f"the field reach 2^31: too large for one launch")


def launch_floor() -> None:
    """Launch the empty one-block kernel ``sara_launch_floor`` on the
    current CUDA stream: timed, it is the floor under any launch of K1 or
    K2."""
    fn = _entry("sara_launch_floor", [ctypes.c_void_p])
    err = fn(torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"sara_launch_floor failed: cudaError_t {err}")


def sample_field_patches(maps: torch.Tensor, s_idx: torch.Tensor,
                         ys: torch.Tensor, xs: torch.Tensor,
                         max_sample_radius: float,
                         block: int = 8,
                         pack_x: bool = False) -> torch.Tensor:
    """Bilinear-sample (K, N) positions from (S, H, W, C) maps.

    Returns (K, N, C) float32 for every geometry: there is no fit rule and
    no ``None``. A CUDA tensor goes through a kernel, or the call raises;
    a CPU tensor goes through that kernel's plain version. On the card,
    sizes the kernels' 32-bit indices cannot address raise
    (:func:`check_launch_size`).

    Args:
      maps: (S, H, W, C) float32 or bfloat16 field, contiguous; a batch's
        frames come folded into S (frame b's scale s at slice b * S' + s).
      s_idx: (K,) integer scale-slice index per keypoint (clamped to S - 1);
        int32 and int64 are read in place.
      ys, xs: (K, N) float32 sample positions in map pixels, contiguous.
      max_sample_radius, block: kept for the signature of the JAX twin,
        where they size the TPU window; they do not change the result.
      pack_x: the x-packed mode: kernel K2 where
        :func:`packed_layout_ok` holds, else K1, as the reference's
        dispatcher falls through to its plain mode.
    """
    if maps.dim() != 4 or maps.dtype not in _DTYPE_SUFFIX:
        raise ValueError(f"maps must be (S, H, W, C) float32 or bfloat16, "
                         f"got {tuple(maps.shape)} {maps.dtype}")
    if ys.dim() != 2 or ys.shape != xs.shape or s_idx.shape != ys.shape[:1]:
        raise ValueError(f"need s_idx (K,), ys and xs (K, N); got "
                         f"{tuple(s_idx.shape)}, {tuple(ys.shape)}, "
                         f"{tuple(xs.shape)}")
    if ys.dtype != torch.float32 or xs.dtype != torch.float32:
        raise ValueError(f"ys and xs must be float32, got {ys.dtype}, "
                         f"{xs.dtype}")
    if s_idx.dtype.is_floating_point or s_idx.dtype == torch.bool:
        raise ValueError(f"s_idx must be an integer tensor, got "
                         f"{s_idx.dtype}")
    devices = {t.device for t in (maps, s_idx, ys, xs)}
    if len(devices) != 1:
        raise ValueError(f"all inputs must be on one device, got {devices}")
    packed = pack_x and packed_layout_ok(maps.shape)
    if maps.device.type == "cpu":
        if packed:
            return _sample_patches_packed_reference(maps, s_idx, ys, xs)
        return _sample_patches_reference(maps, s_idx, ys, xs)
    if maps.device.type != "cuda":
        raise ValueError(f"unsupported device {maps.device}")
    return _sample_on_card(maps, s_idx, ys, xs, packed)
