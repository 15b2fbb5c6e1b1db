// Bilinear field-patch sampler (kernels K1 and K2) for Hopper, sm_90a.
//
// K1 replaces the TPU kernel sara_tpu/ops/patch_sampler.py::_sampler_kernel
// in its plain mode (reached through _sample_patches and pl.pallas_call);
// K2 replaces its x-packed mode (_sample_patches_packed). K1 computes, for K
// keypoints with N sample positions each in scale slice s_idx[k] of an
// (S, H, W, C) field:
//
//   out[k, n, c] = sum_{a, b in {0, 1}} wy_a * wx_b * maps[s, y_a, x_b, c]
//
// with (y, x) clamped to the map first (clamp-to-edge), y_0 = floor(y),
// y_1 = min(y_0 + 1, H - 1), wy_1 = y - y_0, wy_0 = 1 - wy_1 (x alike).
//
// What bounds it on the card: bytes. Each of the K*N*C outputs is written
// once as f32, the coordinates are read once, and each sample reads four tap
// rows of C contiguous channels (144 B at C = 36, f32); the arithmetic is
// about 13 flops per output. On the descriptor path the 16 samples of a
// keypoint are its 4x4 bin centres, at least 4.8 px apart, so no two share a
// tap row: a keypoint needs exactly 64 tap rows (9.2 KB at C = 36, f32). The
// TPU kernel instead DMAs one (PH, PW+8) window per keypoint into VMEM and
// contracts a dense (PH*PW x N) weight matrix on its matrix unit; at side 64
// that window is 64*72*144 B = 663 KB, 72 times the tap bytes and three times
// the 227 KB of shared memory a block can hold, and all but 64 of the
// 4,608 x 16 weights are zero. Staging windows in shared memory (by TMA or
// re-tiled) would move more bytes than the kernel needs, and tensor cores
// would multiply zeros. So this file uses no shared memory, no TMA and no
// wgmma: the kernels are gathers that move exactly the tap bytes.
//
// The vector variant (sample_patches_vec_kernel, and its K2 twin) moves
// them in the fewest requests. A team of L = C/4 lanes serves one (k, n)
// sample; lane j owns channels 4j..4j+3. The block is (L, NB, KB) threads:
// lane, sample, keypoint, so k and n come from the block and thread indices
// with no integer division, the index arithmetic is 32-bit and only the
// final element offsets are 64-bit. Each lane loads the sample's slice and
// coordinates once (a broadcast within the team), clamps and weights once
// for its four channels, issues four 16-byte read-only loads, one per tap
// (8-byte loads of four bf16 values, widened to f32), lerps in f32 and
// writes one 16-byte store. The (y0, x0) and (y0, x1) rows are contiguous
// (288 B at C = 36), and so are the two y1 rows; a sample's output row
// (144 B) is a multiple of 16 B, so the stores of a team, and of a block,
// are contiguous. It needs C % 4 == 0 and a base address aligned to 16 B
// (f32) or 8 B (bf16). On the H100 it runs in the time of a contiguous
// copy of the bytes it requests, 1.2x that at the largest octave, where
// its reads scatter over 884 MB (chip_smoke.py phase 6 times both): what
// is left between it and the bytes bound is the memory system's rate, and
// the fixed cost of a launch on the small octaves.
//
// The general variant (sample_patches_kernel, and its K2 twin) takes the
// layouts the vector variant cannot: one thread per output element, flat
// over (k, n, c) with c fastest, four scalar tap loads each. It is the first
// Hopper version of these kernels, kept so that both can be timed on the
// same inputs. The wrapper (ops/patch_sampler.py::vector_layout_ok) chooses.
//
// Both variants take s_idx as int32 or int64 (the frontend's indices are
// int64), so the wrapper never converts them. Accumulation is f32 for f32
// and bf16 maps alike.
//
// C interface (loaded with ctypes): each entry point launches on `stream`,
// does not synchronise, allocates nothing, and returns the cudaError_t of
// the launch (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;     // general variant: threads per block
constexpr int kVecThreads = 288;  // vector variant: at most (9 full warps at
                                  // the descriptor's C = 36, N = 16)

__device__ __forceinline__ float load_tap(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_tap(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Channels 4j..4j+3 of the tap row starting at `row`: one 16-byte load for
// f32, one 8-byte load of four bf16 values (each widened exactly).
__device__ __forceinline__ float4 load_tap4(const float* row, int j) {
  return __ldg(reinterpret_cast<const float4*>(row) + j);
}

__device__ __forceinline__ float4 load_tap4(const __nv_bfloat16* row, int j) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(row) + j);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// s_idx[k] clamped to [0, S - 1].
template <typename Idx>
__device__ __forceinline__ int slice_of(const Idx* s_idx, int64_t k, int S) {
  const Idx s = s_idx[k];
  return s < 0 ? 0 : (s > S - 1 ? S - 1 : (int)s);
}

// fmaxf/fminf return the non-NaN operand, so a NaN coordinate reads the
// first row or column instead of leaving the map.
__device__ __forceinline__ float clamp_coord(float v, int n) {
  return fminf(fmaxf(v, 0.f), (float)(n - 1));
}

template <typename T, typename Idx>
__global__ void __launch_bounds__(kThreads)
sample_patches_kernel(const T* __restrict__ maps,
                      const Idx* __restrict__ s_idx,
                      const float* __restrict__ ys,
                      const float* __restrict__ xs,
                      float* __restrict__ out,
                      int S, int H, int W, int C, int N, int64_t total) {
  const int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= total) return;
  const int64_t kn = e / C;               // (k, n) sample index
  const int c = (int)(e - kn * C);
  const int64_t k = kn / N;

  const int s = slice_of(s_idx, k, S);
  const float y = clamp_coord(__ldg(ys + kn), H);
  const float x = clamp_coord(__ldg(xs + kn), W);
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

template <typename T, typename Idx>
int launch(const void* maps, const void* s_idx, const void* ys,
           const void* xs, void* out, int S, int H, int W, int C, int K,
           int N, void* stream) {
  const int64_t total = (int64_t)K * N * C;
  if (total <= 0) return (int)cudaSuccess;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  sample_patches_kernel<T, Idx><<<(unsigned)blocks, kThreads, 0,
                                  (cudaStream_t)stream>>>(
      (const T*)maps, (const Idx*)s_idx, (const float*)ys,
      (const float*)xs, (float*)out, S, H, W, C, N, total);
  return (int)cudaGetLastError();
}

// The vector variant's block: L lanes x NB samples x KB keypoints, at most
// kVecThreads threads; the grid covers K keypoints and N samples.
struct VecShape {
  dim3 grid, block;
};

__host__ inline bool vec_shape(int C, int K, int N, VecShape* v) {
  const int L = C / 4;
  if (C % 4 != 0 || L > kVecThreads) return false;
  const int nb = std::min(N, std::max(1, kVecThreads / L));
  // blockDim.z is at most 64.
  const int kb = std::min(64, std::max(1, kVecThreads / (L * nb)));
  v->block = dim3(L, nb, kb);
  v->grid = dim3((K + kb - 1) / kb, (N + nb - 1) / nb);
  return v->grid.y <= 65535;
}

template <typename T, typename Idx>
__global__ void __launch_bounds__(kVecThreads)
sample_patches_vec_kernel(const T* __restrict__ maps,
                          const Idx* __restrict__ s_idx,
                          const float* __restrict__ ys,
                          const float* __restrict__ xs,
                          float4* __restrict__ out,
                          int S, int H, int W, int K, int N) {
  const int j = threadIdx.x;              // lane: channels 4j..4j+3
  const int L = blockDim.x;               // C / 4
  const int n = blockIdx.y * blockDim.y + threadIdx.y;
  const int k = blockIdx.x * blockDim.z + threadIdx.z;
  if (k >= K || n >= N) return;
  const int kn = k * N + n;

  const int s = slice_of(s_idx, k, S);
  const float y = clamp_coord(__ldg(ys + kn), H);
  const float x = clamp_coord(__ldg(xs + kn), W);
  const int y0 = (int)floorf(y);
  const int x0 = (int)floorf(x);
  const int y1 = min(y0 + 1, H - 1);
  const int x1 = min(x0 + 1, W - 1);
  const float fy = y - (float)y0;
  const float fx = x - (float)x0;
  const float w00 = (1.f - fx) * (1.f - fy), w01 = fx * (1.f - fy);
  const float w10 = (1.f - fx) * fy, w11 = fx * fy;

  const int64_t C = 4 * L;
  const int p0 = (s * H + y0) * W;        // first pixel of rows y0 and y1
  const int p1 = (s * H + y1) * W;
  const float4 v00 = load_tap4(maps + (int64_t)(p0 + x0) * C, j);
  const float4 v01 = load_tap4(maps + (int64_t)(p0 + x1) * C, j);
  const float4 v10 = load_tap4(maps + (int64_t)(p1 + x0) * C, j);
  const float4 v11 = load_tap4(maps + (int64_t)(p1 + x1) * C, j);
  float4 o;
  o.x = v00.x * w00 + v01.x * w01 + v10.x * w10 + v11.x * w11;
  o.y = v00.y * w00 + v01.y * w01 + v10.y * w10 + v11.y * w11;
  o.z = v00.z * w00 + v01.z * w01 + v10.z * w10 + v11.z * w11;
  o.w = v00.w * w00 + v01.w * w01 + v10.w * w10 + v11.w * w11;
  out[(int64_t)kn * L + j] = o;
}

template <typename T, typename Idx>
int launch_vec(const void* maps, const void* s_idx, const void* ys,
               const void* xs, void* out, int S, int H, int W, int C, int K,
               int N, void* stream) {
  if (K <= 0 || N <= 0 || C <= 0) return (int)cudaSuccess;
  VecShape v;
  if (!vec_shape(C, K, N, &v)) return (int)cudaErrorInvalidValue;
  sample_patches_vec_kernel<T, Idx><<<v.grid, v.block, 0,
                                      (cudaStream_t)stream>>>(
      (const T*)maps, (const Idx*)s_idx, (const float*)ys,
      (const float*)xs, (float4*)out, S, H, W, K, N);
  return (int)cudaGetLastError();
}

}  // namespace

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
// (x0-1)/2 and the even half of the next cell). The kernels read just those
// halves; a cell index past the row is clamped, and its triangle weight,
// taken from the unclamped column, is 0 there.
//
// What bounds it: bytes, as for K1 (the same outputs, coordinates and tap
// channels). The TPU kernel packed x-pairs to fill 72 of 128 lanes of its
// window DMA; on Hopper there is no window, so the packing changes which
// addresses are read and not how many bytes move: K2 moves K1's bytes in
// K1's requests. Its vector variant is K1's team design: lane j reads
// channels 4j..4j+3 of each of the two halves that carry weight, in each of
// the two tap rows (at C = 36 a half is 144 B and 16-byte aligned). Its
// general variant is one thread per output element, c fastest.

namespace {

__device__ __forceinline__ float tri(float d) {
  return fmaxf(0.f, 1.f - fabsf(d));
}

template <typename T, typename Idx>
__global__ void __launch_bounds__(kThreads)
sample_patches_packed_kernel(const T* __restrict__ maps,
                             const Idx* __restrict__ s_idx,
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

  const int s = slice_of(s_idx, k, S);
  const float y = clamp_coord(__ldg(ys + kn), H);
  const float x = clamp_coord(__ldg(xs + kn), W);
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

template <typename T, typename Idx>
int launch_packed(const void* maps, const void* s_idx, const void* ys,
                  const void* xs, void* out, int S, int H, int W, int C,
                  int K, int N, void* stream) {
  const int64_t total = (int64_t)K * N * C;
  if (total <= 0) return (int)cudaSuccess;
  if (W % 2 != 0) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  sample_patches_packed_kernel<T, Idx><<<(unsigned)blocks, kThreads, 0,
                                         (cudaStream_t)stream>>>(
      (const T*)maps, (const Idx*)s_idx, (const float*)ys,
      (const float*)xs, (float*)out, S, H, W, C, N, total);
  return (int)cudaGetLastError();
}

template <typename T, typename Idx>
__global__ void __launch_bounds__(kVecThreads)
sample_patches_packed_vec_kernel(const T* __restrict__ maps,
                                 const Idx* __restrict__ s_idx,
                                 const float* __restrict__ ys,
                                 const float* __restrict__ xs,
                                 float4* __restrict__ out,
                                 int S, int H, int W, int K, int N) {
  const int j = threadIdx.x;              // lane: channels 4j..4j+3
  const int L = blockDim.x;               // C / 4
  const int n = blockIdx.y * blockDim.y + threadIdx.y;
  const int k = blockIdx.x * blockDim.z + threadIdx.z;
  if (k >= K || n >= N) return;
  const int kn = k * N + n;
  const int Wc = W >> 1;                  // cells per row

  const int s = slice_of(s_idx, k, S);
  const float y = clamp_coord(__ldg(ys + kn), H);
  const float x = clamp_coord(__ldg(xs + kn), W);
  const int y0 = (int)floorf(y);
  const int y1 = min(y0 + 1, H - 1);
  const float fy = y - (float)y0;
  const int x0 = (int)floorf(x);
  const int a0 = x0 >> 1;                 // cell holding column x0
  const int a1 = min(a0 + 1, Wc - 1);     // next cell (weight 0 if clamped)
  const bool odd = (x0 & 1) != 0;
  const float w_first = odd ? tri(2.f * a0 + 1.f - x) : tri(2.f * a0 - x);
  const float w_second = odd ? tri(2.f * (a0 + 1) - x)
                             : tri(2.f * a0 + 1.f - x);
  // Halves within a row, counted 2a + (0 even, 1 odd): even x0 reads both
  // halves of cell a0; odd x0 the odd half of a0 and the even half of a1.
  const int h_first = 2 * a0 + (odd ? 1 : 0);
  const int h_second = odd ? 2 * a1 : 2 * a0 + 1;

  const int64_t C = 4 * L;                // channels per half
  const int q0 = (s * H + y0) * Wc * 2;   // first half of rows y0 and y1
  const int q1 = (s * H + y1) * Wc * 2;
  const float4 f0 = load_tap4(maps + (int64_t)(q0 + h_first) * C, j);
  const float4 s0 = load_tap4(maps + (int64_t)(q0 + h_second) * C, j);
  const float4 f1 = load_tap4(maps + (int64_t)(q1 + h_first) * C, j);
  const float4 s1 = load_tap4(maps + (int64_t)(q1 + h_second) * C, j);
  const float gy = 1.f - fy;
  float4 o;
  o.x = (w_first * f0.x + w_second * s0.x) * gy
      + (w_first * f1.x + w_second * s1.x) * fy;
  o.y = (w_first * f0.y + w_second * s0.y) * gy
      + (w_first * f1.y + w_second * s1.y) * fy;
  o.z = (w_first * f0.z + w_second * s0.z) * gy
      + (w_first * f1.z + w_second * s1.z) * fy;
  o.w = (w_first * f0.w + w_second * s0.w) * gy
      + (w_first * f1.w + w_second * s1.w) * fy;
  out[(int64_t)kn * L + j] = o;
}

template <typename T, typename Idx>
int launch_packed_vec(const void* maps, const void* s_idx, const void* ys,
                      const void* xs, void* out, int S, int H, int W, int C,
                      int K, int N, void* stream) {
  if (K <= 0 || N <= 0 || C <= 0) return (int)cudaSuccess;
  VecShape v;
  if (W % 2 != 0 || !vec_shape(C, K, N, &v)) {
    return (int)cudaErrorInvalidValue;
  }
  sample_patches_packed_vec_kernel<T, Idx><<<v.grid, v.block, 0,
                                             (cudaStream_t)stream>>>(
      (const T*)maps, (const Idx*)s_idx, (const float*)ys,
      (const float*)xs, (float4*)out, S, H, W, K, N);
  return (int)cudaGetLastError();
}

// An empty one-block kernel: its launch-to-end time on a stream is the floor
// under any launch of the kernels above.
__global__ void launch_floor_kernel() {}

}  // namespace

// Entry points: sara_sample_patches[_packed][_vec]_{f32,bf16}[_i64]
// (general or vector variant, K1 or K2, f32 or bf16 maps, int32 or int64
// s_idx), all with one signature.
#define SARA_SAMPLER_ENTRY(name, launcher, T, Idx)                           \
  extern "C" int name(const void* maps, const void* s_idx, const void* ys,   \
                      const void* xs, void* out, int S, int H, int W, int C, \
                      int K, int N, void* stream) {                          \
    return launcher<T, Idx>(maps, s_idx, ys, xs, out, S, H, W, C, K, N,      \
                            stream);                                         \
  }

SARA_SAMPLER_ENTRY(sara_sample_patches_f32, launch, float, int32_t)
SARA_SAMPLER_ENTRY(sara_sample_patches_bf16, launch, __nv_bfloat16, int32_t)
SARA_SAMPLER_ENTRY(sara_sample_patches_f32_i64, launch, float, int64_t)
SARA_SAMPLER_ENTRY(sara_sample_patches_bf16_i64, launch, __nv_bfloat16,
                   int64_t)
SARA_SAMPLER_ENTRY(sara_sample_patches_vec_f32, launch_vec, float, int32_t)
SARA_SAMPLER_ENTRY(sara_sample_patches_vec_bf16, launch_vec, __nv_bfloat16,
                   int32_t)
SARA_SAMPLER_ENTRY(sara_sample_patches_vec_f32_i64, launch_vec, float,
                   int64_t)
SARA_SAMPLER_ENTRY(sara_sample_patches_vec_bf16_i64, launch_vec,
                   __nv_bfloat16, int64_t)
SARA_SAMPLER_ENTRY(sara_sample_patches_packed_f32, launch_packed, float,
                   int32_t)
SARA_SAMPLER_ENTRY(sara_sample_patches_packed_bf16, launch_packed,
                   __nv_bfloat16, int32_t)
SARA_SAMPLER_ENTRY(sara_sample_patches_packed_f32_i64, launch_packed, float,
                   int64_t)
SARA_SAMPLER_ENTRY(sara_sample_patches_packed_bf16_i64, launch_packed,
                   __nv_bfloat16, int64_t)
SARA_SAMPLER_ENTRY(sara_sample_patches_packed_vec_f32, launch_packed_vec,
                   float, int32_t)
SARA_SAMPLER_ENTRY(sara_sample_patches_packed_vec_bf16, launch_packed_vec,
                   __nv_bfloat16, int32_t)
SARA_SAMPLER_ENTRY(sara_sample_patches_packed_vec_f32_i64, launch_packed_vec,
                   float, int64_t)
SARA_SAMPLER_ENTRY(sara_sample_patches_packed_vec_bf16_i64, launch_packed_vec,
                   __nv_bfloat16, int64_t)

#undef SARA_SAMPLER_ENTRY

extern "C" int sara_launch_floor(void* stream) {
  launch_floor_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
