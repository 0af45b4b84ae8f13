// Kernel B1: masked synaptic product + LIF step, written by hand for Hopper
// (sm_90a). Entry point: repro_lif_step (plain C, loaded with ctypes by
// repro_torch/kernels/lif_step.py).
//
// Replaces repro/kernels/lif_step.py::_fused_kernel (entry fused_lif_step):
//   acc = s @ (w * c)   (mask applied per element, f32 accumulation)
//   then the shared LIF epilogue (lif_epilogue.cuh) -> v', r', y'.
//
// Two options serve the event backend's dense arm (event_dispatch.cu): c may
// be null, when w is the premasked W*C, and a device gate (run_if) makes every
// block return at once unless *run_if is set, so the caller can launch B1 and
// the event kernel each tick and let the device pick the one that writes.
//
// What bounds it on this card: the weight bytes. Every tick streams w and c
// once, 2 * K * N * 4 bytes per slot (128 MiB at K = N = 4096, about 40 us at
// 3.35 TB/s), against B * K * N multiply-adds, a few per byte at serving batch.
// The spikes, state and rows are a few hundred KiB.
//
// Design (a simple first version; wgmma, TMA and a split over K come later):
// - A block owns one slot, up to BB <= 8 batch rows and 128 output columns,
//   one column per thread. Grid (ceil(N/128), ceil(B/BB), S). The slot axis
//   replaces the reference's vmap; shared weights pass a slot stride of 0.
// - A loop over K inside the block replaces the TPU's sequential K grid axis:
//   the block stages a chunk of its spike rows in shared memory, then each
//   thread streams w[k, n] and c[k, n], coalesced across the warp because
//   (K, N) is row-major. Sixteen rows of loads are issued before they are
//   used, to keep enough bytes in flight to approach the memory rate.
// - The sum stays in f32 registers and the epilogue runs in registers. The
//   ragged edges (N % 128, B % BB, K % 256) are bounds-checked: no padding.
// - On the u8 weight grid with 0/1 spikes every partial sum is an integer
//   below 2^24, so the result is exact in any summation order.
#include <cuda_runtime.h>

#include "lif_epilogue.cuh"

namespace {

using repro_torch::LifRows;

constexpr int kBlockN = 128;  // output columns per block, one per thread
constexpr int kChunkK = 256;  // spike columns staged in shared memory per pass
constexpr int kUnroll = 16;   // weight rows loaded before they are used

struct LifStepArgs {
  const float* s;  // (S, B, K) arriving spikes
  long long s_slot;
  const float* w;  // (S | 1, K, N)
  long long w_slot;
  const float* c;  // (S | 1, K, N) connection mask, or null: w is premasked
  long long c_slot;
  const float* v;      // (S, B, N)
  const int* r;        // (S, B, N)
  const float* drive;  // (S, B, N) or null
  LifRows rows;        // (S | 1, N) each
  long long row_slot;
  float* v_out;
  int* r_out;
  float* y_out;
  const unsigned char* run_if;  // 0-d device flag, or null: always run
  int B, K, N, mode;
};

template <int BB, bool kMasked>
__global__ void __launch_bounds__(kBlockN) lif_step_kernel(LifStepArgs a) {
  if (a.run_if != nullptr && !*a.run_if) return;  // the other arm writes this tick
  __shared__ float sh_s[BB][kChunkK];
  const int n = blockIdx.x * kBlockN + threadIdx.x;
  const int b0 = blockIdx.y * BB;
  const long long slot = blockIdx.z;
  const int nb = min(BB, a.B - b0);
  const bool live = n < a.N;
  const float* s = a.s + slot * a.s_slot + static_cast<long long>(b0) * a.K;
  const float* w = a.w + slot * a.w_slot + n;
  const float* c = kMasked ? a.c + slot * a.c_slot + n : nullptr;

  float acc[BB];
#pragma unroll
  for (int b = 0; b < BB; ++b) acc[b] = 0.0f;

  for (int k0 = 0; k0 < a.K; k0 += kChunkK) {
    const int kc = min(kChunkK, a.K - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < BB * kChunkK; i += kBlockN) {
      const int b = i / kChunkK;
      const int k = i - b * kChunkK;
      sh_s[b][k] = (b < nb && k < kc) ? s[static_cast<long long>(b) * a.K + k0 + k] : 0.0f;
    }
    __syncthreads();
    if (!live) continue;
    int k = 0;
    for (; k + kUnroll <= kc; k += kUnroll) {
      float wv[kUnroll], cv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long off = static_cast<long long>(k0 + k + u) * a.N;
        wv[u] = __ldg(w + off);
        cv[u] = kMasked ? __ldg(c + off) : 1.0f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float wc = kMasked ? __fmul_rn(wv[u], cv[u]) : wv[u];
#pragma unroll
        for (int b = 0; b < BB; ++b)
          acc[b] = __fadd_rn(acc[b], __fmul_rn(sh_s[b][k + u], wc));
      }
    }
    for (; k < kc; ++k) {
      const long long off = static_cast<long long>(k0 + k) * a.N;
      const float wc = kMasked ? __fmul_rn(__ldg(w + off), __ldg(c + off)) : __ldg(w + off);
#pragma unroll
      for (int b = 0; b < BB; ++b) acc[b] = __fadd_rn(acc[b], __fmul_rn(sh_s[b][k], wc));
    }
  }
  if (!live) return;

  const long long ro = slot * a.row_slot;
  const LifRows p{a.rows.v_th + ro, a.rows.leak + ro, a.rows.r_ref + ro,
                  a.rows.gain + ro, a.rows.i_bias + ro, a.rows.v_reset + ro};
#pragma unroll
  for (int b = 0; b < BB; ++b) {
    if (b >= nb) break;
    const long long idx = (slot * a.B + b0 + b) * static_cast<long long>(a.N) + n;
    const float syn = a.drive ? __fadd_rn(acc[b], a.drive[idx]) : acc[b];
    float v_new, y;
    int r_new;
    repro_torch::lif_epilogue(a.mode, syn, a.v[idx], a.r[idx], p, n, &v_new, &r_new, &y);
    a.v_out[idx] = v_new;
    a.r_out[idx] = r_new;
    a.y_out[idx] = y;
  }
}

template <int BB>
cudaError_t launch(const LifStepArgs& a, int S, cudaStream_t stream) {
  const dim3 grid((a.N + kBlockN - 1) / kBlockN, (a.B + BB - 1) / BB, S);
  if (a.c != nullptr)
    lif_step_kernel<BB, true><<<grid, kBlockN, 0, stream>>>(a);
  else
    lif_step_kernel<BB, false><<<grid, kBlockN, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Never synchronises and
// allocates nothing: the caller owns every buffer.
extern "C" int repro_lif_step(
    const void* s, long long s_slot, const void* w, long long w_slot, const void* c,
    long long c_slot, const void* v, const void* r, const void* drive, const void* v_th,
    const void* leak, const void* r_ref, const void* gain, const void* i_bias,
    const void* v_reset, long long row_slot, void* v_out, void* r_out, void* y_out,
    const void* run_if, int S, int B, int K, int N, int mode, void* stream) {
  if (S < 1 || B < 1 || N < 1 || K < 0 || S > 65535 || (mode != 0 && mode != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  LifStepArgs a;
  a.s = static_cast<const float*>(s);
  a.s_slot = s_slot;
  a.w = static_cast<const float*>(w);
  a.w_slot = w_slot;
  a.c = static_cast<const float*>(c);
  a.c_slot = c_slot;
  a.v = static_cast<const float*>(v);
  a.r = static_cast<const int*>(r);
  a.drive = static_cast<const float*>(drive);
  a.rows = LifRows{static_cast<const float*>(v_th), static_cast<const float*>(leak),
                   static_cast<const int*>(r_ref), static_cast<const float*>(gain),
                   static_cast<const float*>(i_bias), static_cast<const float*>(v_reset)};
  a.row_slot = row_slot;
  a.v_out = static_cast<float*>(v_out);
  a.r_out = static_cast<int*>(r_out);
  a.y_out = static_cast<float*>(y_out);
  a.run_if = static_cast<const unsigned char*>(run_if);
  a.B = B;
  a.K = K;
  a.N = N;
  a.mode = mode;
  const auto st = static_cast<cudaStream_t>(stream);
  const int rows = B < 8 ? B : 8;
  cudaError_t err;
  if (rows <= 1)
    err = launch<1>(a, S, st);
  else if (rows <= 2)
    err = launch<2>(a, S, st);
  else if (rows <= 4)
    err = launch<4>(a, S, st);
  else
    err = launch<8>(a, S, st);
  return static_cast<int>(err);
}
