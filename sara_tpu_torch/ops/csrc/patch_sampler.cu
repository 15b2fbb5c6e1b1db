// Bilinear field-patch sampler (kernel K1) for Hopper, sm_90a.
//
// Replaces the TPU kernel sara_tpu/ops/patch_sampler.py::_sampler_kernel in
// its plain mode (reached through _sample_patches and pl.pallas_call). It
// computes, for K keypoints with N sample positions each in scale slice
// s_idx[k] of an (S, H, W, C) field:
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
