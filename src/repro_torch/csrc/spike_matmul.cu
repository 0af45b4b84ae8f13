// Kernel B6: the masked spike product out = s @ (w * c), written by hand for
// Hopper (sm_90a). Entry point: repro_spike_matmul (plain C, loaded with
// ctypes by repro_torch/kernels/spike_matmul.py).
//
// Replaces repro/kernels/spike_matmul.py::_kernel (entry spike_matmul, bridge
// ops.spike_matmul): the connection mask is applied per element on the chip
// (w * c in the operand dtype, then f32) and the product accumulates in f32.
// s is f32 or bf16; w and c are both f32 or both bf16; out is f32.
//
// What bounds it on this card: the bytes of w and c, read once,
// 2 * K * N * sizeof(w) (134 MB at K = N = 4096 in f32, about 40 us at
// 3.35 TB/s), against 2 * B * K * N flops: a few per byte at the batch sizes
// it serves (the classifier's 45 and 80 rows, the fabric's 8).
//
// Design (a simple first version; wgmma, TMA and a split over K across
// blocks come with a redesign):
// - A block of 16 warps owns 32 output columns (one per lane) and kRows = 8
//   batch rows (fewer on the last block row). Grid (ceil(N/32), ceil(B/8)):
//   128 blocks at N = 4096, about one per SM, where B1's 128-column blocks
//   give 32.
// - The 16 warps split K inside the block: warp j walks rows j, j+16, ... of
//   each staged chunk, so the block reads 16 consecutive 128-byte row
//   segments of w (and of c) at a time. Each thread issues its loads for 16
//   rows before it uses any (volatile ld.global.nc: the compiler otherwise
//   sinks each load next to its use and leaves one or two in flight), which
//   keeps about 64 KiB in flight per SM. The chunk's spike columns are staged
//   in shared memory as f32 and read as broadcasts.
// - Each warp keeps kRows partial sums per column in f32 registers; at the end
//   the sixteen partials meet in shared memory (over the spike staging
//   buffer) and are added in warp order.
// - Ragged edges (N % 32, B % kRows, any K) are bounds-checked: no padding.
// - On 0/1 spikes times u8-grid weights every partial sum is an integer below
//   2^24, so the result is exact in any summation order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockN = 32;    // output columns per block, one per lane
constexpr int kChunkK = 1024;  // spike columns staged in shared memory per pass
constexpr int kUnroll = 16;    // weight rows per thread loaded before they are used
constexpr int kRows = 8;       // batch rows per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// A read-only streaming load the compiler may not move past the next one.
__device__ __forceinline__ float load_stream(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ __nv_bfloat16 load_stream(const __nv_bfloat16* p) {
  unsigned short v;
  asm volatile("ld.global.nc.u16 %0, [%1];" : "=h"(v) : "l"(p));
  return __ushort_as_bfloat16(v);
}

// w * c in the operand dtype, then f32 (the reference's
// (w * c.astype(w.dtype)).astype(f32)). The f32 product of two bf16 values is
// exact, so rounding it once to bf16 is the correctly rounded bf16 product.
__device__ __forceinline__ float masked(float w, float c) { return __fmul_rn(w, c); }
__device__ __forceinline__ float masked(__nv_bfloat16 w, __nv_bfloat16 c) {
  return __bfloat162float(__float2bfloat16_rn(__fmul_rn(__bfloat162float(w), __bfloat162float(c))));
}

template <typename TS, typename TW>
__global__ void __launch_bounds__(kThreads)
    spike_matmul_kernel(const TS* __restrict__ s, const TW* __restrict__ w,
                        const TW* __restrict__ c, float* __restrict__ out, int B, int K, int N) {
  // The staged spikes (kRows x kChunkK), then the warps' partial sums.
  static_assert(kWarps * kBlockN <= kChunkK, "the partials reuse the spike buffer");
  __shared__ float sh_s[kRows][kChunkK];
  float(*sh_part)[kBlockN] = reinterpret_cast<float(*)[kBlockN]>(&sh_s[0][0]);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * kBlockN + lane;
  const int b0 = blockIdx.y * kRows;
  const int nb = min(kRows, B - b0);
  const bool live = n < N;
  const TS* s_rows = s + static_cast<long long>(b0) * K;

  float acc[kRows];
#pragma unroll
  for (int b = 0; b < kRows; ++b) acc[b] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kChunkK) {
    const int kc = min(kChunkK, K - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < kRows * kChunkK; i += kThreads) {
      const int b = i / kChunkK;
      const int k = i - b * kChunkK;
      sh_s[b][k] = (b < nb && k < kc) ? to_f32(s_rows[static_cast<long long>(b) * K + k0 + k])
                                      : 0.0f;
    }
    __syncthreads();
    if (!live) continue;
    // This warp's rows of the chunk: warp, warp + 8, ... < kc.
    int k = warp;
    for (; k + kWarps * (kUnroll - 1) < kc; k += kWarps * kUnroll) {
      TW wv[kUnroll], cv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long off = static_cast<long long>(k0 + k + kWarps * u) * N + n;
        wv[u] = load_stream(w + off);
        cv[u] = load_stream(c + off);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float wc = masked(wv[u], cv[u]);
#pragma unroll
        for (int b = 0; b < kRows; ++b)
          acc[b] = __fadd_rn(acc[b], __fmul_rn(sh_s[b][k + kWarps * u], wc));
      }
    }
    for (; k < kc; k += kWarps) {
      const long long off = static_cast<long long>(k0 + k) * N + n;
      const float wc = masked(load_stream(w + off), load_stream(c + off));
#pragma unroll
      for (int b = 0; b < kRows; ++b) acc[b] = __fadd_rn(acc[b], __fmul_rn(sh_s[b][k], wc));
    }
  }

  __syncthreads();  // every warp is done with the staged spikes
#pragma unroll
  for (int b = 0; b < kRows; ++b) sh_part[warp * kRows + b][lane] = acc[b];
  __syncthreads();
  // One thread per output of the block: kRows * 32 <= 512 threads.
  const int b = threadIdx.x / kBlockN;
  const int col = blockIdx.x * kBlockN + lane;
  if (b < nb && col < N) {
    float sum = sh_part[b][lane];
#pragma unroll
    for (int j = 1; j < kWarps; ++j) sum = __fadd_rn(sum, sh_part[j * kRows + b][lane]);
    out[static_cast<long long>(b0 + b) * N + col] = sum;
  }
}

template <typename TS, typename TW>
cudaError_t launch(const void* s, const void* w, const void* c, void* out, int B, int K, int N,
                   cudaStream_t stream) {
  const dim3 grid((N + kBlockN - 1) / kBlockN, (B + kRows - 1) / kRows);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  spike_matmul_kernel<TS, TW><<<grid, kThreads, 0, stream>>>(
      static_cast<const TS*>(s), static_cast<const TW*>(w), static_cast<const TW*>(c),
      static_cast<float*>(out), B, K, N);
  return cudaGetLastError();
}

}  // namespace

// s (B, K), w and c (K, N), out (B, N) f32, all contiguous row-major.
// s_bf16 / w_bf16 pick bf16 over f32 for s and for both w and c. Returns the
// cudaError_t of the launch (0 on success). Never synchronises and allocates
// nothing: the caller owns every buffer.
extern "C" int repro_spike_matmul(const void* s, const void* w, const void* c, void* out, int B,
                                  int K, int N, int s_bf16, int w_bf16, void* stream) {
  if (B < 1 || K < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (!s_bf16 && !w_bf16)
    err = launch<float, float>(s, w, c, out, B, K, N, st);
  else if (!s_bf16)
    err = launch<float, __nv_bfloat16>(s, w, c, out, B, K, N, st);
  else if (!w_bf16)
    err = launch<__nv_bfloat16, float>(s, w, c, out, B, K, N, st);
  else
    err = launch<__nv_bfloat16, __nv_bfloat16>(s, w, c, out, B, K, N, st);
  return static_cast<int>(err);
}
