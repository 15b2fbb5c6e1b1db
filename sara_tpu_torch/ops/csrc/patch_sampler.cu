// Bilinear field-patch sampler (kernels K1 and K2) for Hopper, sm_90a.
//
// K1 replaces the TPU kernel sara_tpu/ops/patch_sampler.py::_sampler_kernel
// in its plain mode (reached through _sample_patches and pl.pallas_call);
// K2, at the end of this file, replaces its x-packed mode. K1 computes,
// for K keypoints with N sample positions each in scale slice s_idx[k] of
// an (S, H, W, C) field:
//
//   out[k, n, c] = sum_{a, b in {0, 1}} wy_a * wx_b * maps[s, y_a, x_b, c]
//
// with (y, x) clamped to the map first (clamp-to-edge), y_0 = floor(y),
// y_1 = min(y_0 + 1, H - 1), wy_1 = y - y_0, wy_0 = 1 - wy_1 (x alike).
//
// What bounds it on the card: bytes. Each of the K*N*C outputs is written
// once as f32, the coordinates are read once, and each sample reads four tap
// rows of C contiguous channels (144 B at C = 36, f32); the arithmetic is
// about ten flops per output. The TPU kernel staged one (PH, PW) window per
// keypoint in VMEM by DMA because the TPU's row-gather rate was its limit.
// Here the taps are read straight from device memory: the 16 samples of a
// keypoint share rows, which the L1/L2 caches serve. So there is no window,
// no fit rule and no geometry the kernel declines; staging the window in
// shared memory by TMA is left to a later change (an f32 64x72x36 window is
// 663 KB and would need re-tiling to fit the 227 KB a block can hold).
//
// Layout: one thread per output element, flat over (k, n, c) with c fastest,
// so neighbouring threads read neighbouring channels of a tap row and write
// neighbouring outputs (coalesced both ways). Accumulation is f32 for f32 and
// bf16 maps alike.
//
// C interface (loaded with ctypes): each entry point launches on `stream`,
// does not synchronise, allocates nothing, and returns the cudaError_t of
// the launch (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load_tap(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_tap(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sample_patches_kernel(const T* __restrict__ maps,
                      const int32_t* __restrict__ s_idx,
                      const float* __restrict__ ys,
                      const float* __restrict__ xs,
                      float* __restrict__ out,
                      int S, int H, int W, int C, int N, int64_t total) {
  const int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= total) return;
  const int64_t kn = e / C;               // (k, n) sample index
  const int c = (int)(e - kn * C);
  const int64_t k = kn / N;

  const int s = min(max(s_idx[k], 0), S - 1);
  // fmaxf/fminf return the non-NaN operand, so a NaN coordinate reads the
  // first row or column instead of leaving the map.
  const float y = fminf(fmaxf(__ldg(ys + kn), 0.f), (float)(H - 1));
  const float x = fminf(fmaxf(__ldg(xs + kn), 0.f), (float)(W - 1));
  const int y0 = (int)floorf(y);
  const int x0 = (int)floorf(x);
  const int y1 = min(y0 + 1, H - 1);
  const int x1 = min(x0 + 1, W - 1);
  const float fy = y - (float)y0;
  const float fx = x - (float)x0;

  const T* slice = maps + (int64_t)s * H * W * C + c;
  const float v00 = load_tap(slice + ((int64_t)y0 * W + x0) * C);
  const float v01 = load_tap(slice + ((int64_t)y0 * W + x1) * C);
  const float v10 = load_tap(slice + ((int64_t)y1 * W + x0) * C);
  const float v11 = load_tap(slice + ((int64_t)y1 * W + x1) * C);
  out[e] = v00 * (1.f - fx) * (1.f - fy) + v01 * fx * (1.f - fy)
         + v10 * (1.f - fx) * fy + v11 * fx * fy;
}

template <typename T>
int launch(const void* maps, const void* s_idx, const void* ys,
           const void* xs, void* out, int S, int H, int W, int C, int K,
           int N, void* stream) {
  const int64_t total = (int64_t)K * N * C;
  if (total <= 0) return (int)cudaSuccess;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  sample_patches_kernel<T><<<(unsigned)blocks, kThreads, 0,
                             (cudaStream_t)stream>>>(
      (const T*)maps, (const int32_t*)s_idx, (const float*)ys,
      (const float*)xs, (float*)out, S, H, W, C, N, total);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sara_sample_patches_f32(const void* maps, const void* s_idx,
                                       const void* ys, const void* xs,
                                       void* out, int S, int H, int W, int C,
                                       int K, int N, void* stream) {
  return launch<float>(maps, s_idx, ys, xs, out, S, H, W, C, K, N, stream);
}

extern "C" int sara_sample_patches_bf16(const void* maps, const void* s_idx,
                                        const void* ys, const void* xs,
                                        void* out, int S, int H, int W, int C,
                                        int K, int N, void* stream) {
  return launch<__nv_bfloat16>(maps, s_idx, ys, xs, out, S, H, W, C, K, N,
                               stream);
}

// ---------------------------------------------------------------------------
// K2: the x-packed sampler.
//
// Replaces _sampler_kernel(packed_c=C), reached through
// _sample_patches_packed. The field is read as (S, H, W/2, 2C) cells: cell a
// of a row holds real column 2a in channels [0, C) and column 2a+1 in
// channels [C, 2C) (a free view of the row-major maps, W even). It computes
// the same clamp-to-edge bilinear samples as K1, with the x-weights of the
// TPU formula, split by cell half:
//
//   out[k, n, c] = sum_{rows r} wy_r * sum_{cells a}
//                    ( tri(2a - x) * cell[r, a, c] + tri(2a + 1 - x) * cell[r, a, C + c] )
//
// with tri(d) = max(0, 1 - |d|) and x, y clamped to the map first. Only the
// cells covering {x0, x1} carry weight: one cell when x0 = floor(x) is even
// (both halves of cell x0/2), two when it is odd (the odd half of cell
// (x0-1)/2 and the even half of the next cell). The kernel reads just those
// halves; a cell index past the row is clamped, and its triangle weight,
// taken from the unclamped column, is 0 there.
//
// What bounds it: bytes, as for K1 (the same outputs, coordinates and tap
// channels). The TPU kernel packed x-pairs to fill 72 of 128 lanes of its
// window DMA; on Hopper there is no window, so the packing changes which
// addresses a thread reads and not how many bytes move. Layout as K1: one
// thread per output element, c fastest; a warp reads one or two contiguous
// C-channel halves of a 2C-channel cell row per row of taps.

namespace {

__device__ __forceinline__ float tri(float d) {
  return fmaxf(0.f, 1.f - fabsf(d));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sample_patches_packed_kernel(const T* __restrict__ maps,
                             const int32_t* __restrict__ s_idx,
                             const float* __restrict__ ys,
                             const float* __restrict__ xs,
                             float* __restrict__ out,
                             int S, int H, int W, int C, int N,
                             int64_t total) {
  const int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= total) return;
  const int64_t kn = e / C;
  const int c = (int)(e - kn * C);
  const int64_t k = kn / N;
  const int Wc = W / 2;                   // cells per row
  const int C2 = 2 * C;                   // channels per cell

  const int s = min(max(s_idx[k], 0), S - 1);
  const float y = fminf(fmaxf(__ldg(ys + kn), 0.f), (float)(H - 1));
  const float x = fminf(fmaxf(__ldg(xs + kn), 0.f), (float)(W - 1));
  const int y0 = (int)floorf(y);
  const int y1 = min(y0 + 1, H - 1);
  const float fy = y - (float)y0;
  const int x0 = (int)floorf(x);
  const int a0 = x0 >> 1;                 // cell holding column x0
  const int a1 = min(a0 + 1, Wc - 1);     // next cell (weight 0 if clamped)
  const bool odd = (x0 & 1) != 0;
  // Triangle weights of the two halves that carry weight.
  const float w_first = odd ? tri(2.f * a0 + 1.f - x) : tri(2.f * a0 - x);
  const float w_second = odd ? tri(2.f * (a0 + 1) - x)
                             : tri(2.f * a0 + 1.f - x);
  // Channel offsets: even x0 reads both halves of cell a0; odd x0 reads the
  // odd half of a0 and the even half of a1.
  const int64_t off_first = (int64_t)a0 * C2 + (odd ? C : 0) + c;
  const int64_t off_second = odd ? (int64_t)a1 * C2 + c
                                 : (int64_t)a0 * C2 + C + c;

  const T* slice = maps + (int64_t)s * H * Wc * C2;
  const T* row0 = slice + (int64_t)y0 * Wc * C2;
  const T* row1 = slice + (int64_t)y1 * Wc * C2;
  const float v0 = w_first * load_tap(row0 + off_first)
                 + w_second * load_tap(row0 + off_second);
  const float v1 = w_first * load_tap(row1 + off_first)
                 + w_second * load_tap(row1 + off_second);
  out[e] = v0 * (1.f - fy) + v1 * fy;
}

template <typename T>
int launch_packed(const void* maps, const void* s_idx, const void* ys,
                  const void* xs, void* out, int S, int H, int W, int C,
                  int K, int N, void* stream) {
  const int64_t total = (int64_t)K * N * C;
  if (total <= 0) return (int)cudaSuccess;
  if (W % 2 != 0) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  sample_patches_packed_kernel<T><<<(unsigned)blocks, kThreads, 0,
                                    (cudaStream_t)stream>>>(
      (const T*)maps, (const int32_t*)s_idx, (const float*)ys,
      (const float*)xs, (float*)out, S, H, W, C, N, total);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sara_sample_patches_packed_f32(
    const void* maps, const void* s_idx, const void* ys, const void* xs,
    void* out, int S, int H, int W, int C, int K, int N, void* stream) {
  return launch_packed<float>(maps, s_idx, ys, xs, out, S, H, W, C, K, N,
                              stream);
}

extern "C" int sara_sample_patches_packed_bf16(
    const void* maps, const void* s_idx, const void* ys, const void* xs,
    void* out, int S, int H, int W, int C, int K, int N, void* stream) {
  return launch_packed<__nv_bfloat16>(maps, s_idx, ys, xs, out, S, H, W, C,
                                      K, N, stream);
}
