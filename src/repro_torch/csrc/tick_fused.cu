// Kernel B2: the whole network tick in one launch, written by hand for Hopper
// (sm_90a). Entry point: repro_tick_fused (plain C, loaded with ctypes by
// repro_torch/kernels/tick_fused.py).
//
// Replaces repro/kernels/tick_fused.py::_tick_kernel (entry fused_tick):
//   read ring slot tick % D -> masked product (premasked W*C when frozen, w and
//   c when not; with per-synapse delays every ring slot, each synapse reading
//   slot (tick - (d - 1)) % D) -> LIF epilogue (lif_epilogue.cuh) -> write y'
//   into ring slot (tick + 1) % D.
//
// What bounds it on this card: the weight bytes. On the frozen serving path
// each tick reads the premasked W*C once per slot, K * N * 4 bytes (64 MiB at
// K = N = 4096, about 20 us at 3.35 TB/s); the spikes, state, ring and rows are
// a few hundred KiB. Streaming w and c separately doubles it, and per-synapse
// delays add the (K, N) int32 delay matrix.
//
// Design (a simple first version; wgmma, TMA and a split over K come later):
// - A block owns one slot, up to BB <= 8 batch rows and 128 output columns,
//   one column per thread. Grid (ceil(N/128), ceil(B/BB), S); shared weights
//   pass a slot stride of 0, so one network is S = 1 with no copies.
// - The ring pointers [tick % D, (tick + 1) % D] are read from a device int32
//   pair (the TPU kernel's scalar prefetch): the tick loop never syncs with
//   the host and changing the tick never rebuilds anything.
// - A loop over K inside the block replaces the TPU's sequential K grid axis:
//   the block stages its spike history for a chunk of K in shared memory (one
//   ring slot, or all D slots with per-synapse delays; rows padded by one float
//   to spread banks), then each thread streams wc[k, n], coalesced across the
//   warp, sixteen rows of loads in flight before use.
// - f32 sums in registers, epilogue in registers, ragged edges bounds-checked
//   (the reference pads instead, with r = 1 and v_th = FLT_MAX / 2).
//
// Ring write, and why it is race-free (blocks run in no order):
// - No per-synapse delays, D > 1 (ring_in == null): blocks read only slot
//   tick % D and write only slot (tick + 1) % D, which differ, so y' is written
//   into the ring in place.
// - Per-synapse delays (ring_in != null): every block reads every slot, slot
//   (tick + 1) % D included, so the kernel writes a separate ring_out (the
//   other D - 1 slots copied through, y' into the write slot). The engine
//   ping-pongs two ring buffers.
// - D = 1: the read operand is the previous y itself; y' goes to a fresh
//   buffer (never aliasing it, since other blocks read it through their whole
//   K loop) and the ring is not written, as in the reference.
#include <cuda_runtime.h>

#include "lif_epilogue.cuh"

namespace {

using repro_torch::LifRows;

constexpr int kBlockN = 128;       // output columns per block, one per thread
constexpr int kMaxChunkK = 256;    // history columns staged per pass
constexpr int kSmemFloats = 12288; // 48 KiB: the default dynamic shared memory
constexpr int kUnroll = 16;        // weight rows loaded before they are used

struct TickArgs {
  const int* slots;      // (2,) device: [tick % D, (tick + 1) % D]
  const float* read;     // history (S, B, n_read, K), or y (S, B, K) with n_read = 1
  long long read_slot;
  long long read_row;
  int n_read;
  const float* w;        // (S | 1, K, N): premasked W*C when c is null
  long long w_slot;
  const float* c;        // (S | 1, K, N) or null
  long long c_slot;
  const int* delays;     // (S | 1, K, N) in [1, n_read], or null
  long long delays_slot;
  const float* v;        // (S, B, N)
  const int* r;
  const float* drive;    // (S, B, N) or null
  LifRows rows;          // (S | 1, N) each
  long long row_slot;
  float* v_out;
  int* r_out;
  float* y_out;
  const float* ring_in;  // (S, B, n_ring, N) copy-through source, or null
  float* ring_out;       // (S, B, n_ring, N) write target, or null
  long long ring_slot;
  int n_ring;
  int B, K, N, mode, kc;
};

template <int BB, bool HAS_C, bool DELAYS>
__device__ __forceinline__ void accumulate(float (&acc)[BB], const float* sh, int kcs,
                                           int n_stage, int k, float wv, float cv, int dv,
                                           int rs, int n_read) {
  float wc = wv;
  if constexpr (HAS_C) wc = __fmul_rn(wv, cv);
  int j = 0;
  if constexpr (DELAYS) {
    // Delay d in [1, n_read] reads ring slot (rs - (d - 1)) mod n_read; a delay
    // outside that range routes nothing, as the reference's one-hot planes do.
    const bool ok = dv >= 1 && dv <= n_read;
    wc = ok ? wc : __fmul_rn(wc, 0.0f);
    j = ok ? (rs - dv + 1 + n_read) % n_read : 0;
  }
#pragma unroll
  for (int b = 0; b < BB; ++b)
    acc[b] = __fadd_rn(acc[b], __fmul_rn(sh[(b * n_stage + j) * kcs + k], wc));
}

template <int BB, bool HAS_C, bool DELAYS>
__global__ void __launch_bounds__(kBlockN) tick_fused_kernel(TickArgs a) {
  extern __shared__ float sh[];  // [BB][n_stage][kc + 1]
  const int n = blockIdx.x * kBlockN + threadIdx.x;
  const int b0 = blockIdx.y * BB;
  const long long slot = blockIdx.z;
  const int nb = min(BB, a.B - b0);
  const bool live = n < a.N;
  const int rs = a.slots[0];
  const int n_stage = DELAYS ? a.n_read : 1;
  const int kcs = a.kc + 1;
  const float* hist = a.read + slot * a.read_slot + static_cast<long long>(b0) * a.read_row;
  const float* w = a.w + slot * a.w_slot + n;
  const float* c = HAS_C ? a.c + slot * a.c_slot + n : nullptr;
  const int* dl = DELAYS ? a.delays + slot * a.delays_slot + n : nullptr;

  float acc[BB];
#pragma unroll
  for (int b = 0; b < BB; ++b) acc[b] = 0.0f;

  for (int k0 = 0; k0 < a.K; k0 += a.kc) {
    const int kc = min(a.kc, a.K - k0);
    const int per_row = n_stage * kc;
    __syncthreads();
    for (int i = threadIdx.x; i < BB * per_row; i += kBlockN) {
      const int b = i / per_row;
      const int rem = i - b * per_row;
      const int j = rem / kc;
      const int k = rem - j * kc;
      const int ring_slot = DELAYS ? j : rs;
      sh[(b * n_stage + j) * kcs + k] =
          b < nb ? hist[static_cast<long long>(b) * a.read_row +
                        static_cast<long long>(ring_slot) * a.K + k0 + k]
                 : 0.0f;
    }
    __syncthreads();
    if (!live) continue;
    int k = 0;
    for (; k + kUnroll <= kc; k += kUnroll) {
      float wv[kUnroll], cv[kUnroll];
      int dv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long off = static_cast<long long>(k0 + k + u) * a.N;
        wv[u] = __ldg(w + off);
        cv[u] = 1.0f;
        dv[u] = 1;
        if constexpr (HAS_C) cv[u] = __ldg(c + off);
        if constexpr (DELAYS) dv[u] = __ldg(dl + off);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        accumulate<BB, HAS_C, DELAYS>(acc, sh, kcs, n_stage, k + u, wv[u], cv[u], dv[u], rs,
                                      a.n_read);
    }
    for (; k < kc; ++k) {
      const long long off = static_cast<long long>(k0 + k) * a.N;
      const float cv = HAS_C ? __ldg(c + off) : 1.0f;
      const int dv = DELAYS ? __ldg(dl + off) : 1;
      accumulate<BB, HAS_C, DELAYS>(acc, sh, kcs, n_stage, k, __ldg(w + off), cv, dv, rs,
                                    a.n_read);
    }
  }
  if (!live) return;

  const int ws = a.slots[1];
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
    if (a.ring_out != nullptr) {
      const long long base = slot * a.ring_slot +
                             static_cast<long long>(b0 + b) * a.n_ring * a.N + n;
      if (a.ring_in != nullptr) {
        for (int j = 0; j < a.n_ring; ++j)
          a.ring_out[base + static_cast<long long>(j) * a.N] =
              j == ws ? y : a.ring_in[base + static_cast<long long>(j) * a.N];
      } else {
        a.ring_out[base + static_cast<long long>(ws) * a.N] = y;
      }
    }
  }
}

template <int BB>
cudaError_t launch(const TickArgs& a, int S, size_t smem, cudaStream_t stream) {
  const dim3 grid((a.N + kBlockN - 1) / kBlockN, (a.B + BB - 1) / BB, S);
  const bool has_c = a.c != nullptr;
  const bool delays = a.delays != nullptr;
  if (has_c && delays)
    tick_fused_kernel<BB, true, true><<<grid, kBlockN, smem, stream>>>(a);
  else if (has_c)
    tick_fused_kernel<BB, true, false><<<grid, kBlockN, smem, stream>>>(a);
  else if (delays)
    tick_fused_kernel<BB, false, true><<<grid, kBlockN, smem, stream>>>(a);
  else
    tick_fused_kernel<BB, false, false><<<grid, kBlockN, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Never synchronises and
// allocates nothing: the caller owns every buffer.
extern "C" int repro_tick_fused(
    const void* slots, const void* read, long long read_slot, long long read_row, int n_read,
    const void* w, long long w_slot, const void* c, long long c_slot, const void* delays,
    long long delays_slot, const void* v, const void* r, const void* drive, const void* v_th,
    const void* leak, const void* r_ref, const void* gain, const void* i_bias,
    const void* v_reset, long long row_slot, void* v_out, void* r_out, void* y_out,
    const void* ring_in, void* ring_out, long long ring_slot, int n_ring, int S, int B, int K,
    int N, int mode, void* stream) {
  if (S < 1 || B < 1 || N < 1 || K < 0 || n_read < 1 || S > 65535 ||
      (mode != 0 && mode != 1) || (ring_out != nullptr && n_ring < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int bb = B >= 8 ? 8 : (B > 4 ? 8 : (B > 2 ? 4 : (B > 1 ? 2 : 1)));
  const int n_stage = delays != nullptr ? n_read : 1;
  int kc = kSmemFloats / (bb * n_stage) - 1;
  if (kc > kMaxChunkK) kc = kMaxChunkK;
  if (kc < 1) return static_cast<int>(cudaErrorInvalidValue);  // ring too deep to stage

  TickArgs a;
  a.slots = static_cast<const int*>(slots);
  a.read = static_cast<const float*>(read);
  a.read_slot = read_slot;
  a.read_row = read_row;
  a.n_read = n_read;
  a.w = static_cast<const float*>(w);
  a.w_slot = w_slot;
  a.c = static_cast<const float*>(c);
  a.c_slot = c_slot;
  a.delays = static_cast<const int*>(delays);
  a.delays_slot = delays_slot;
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
  a.ring_in = static_cast<const float*>(ring_in);
  a.ring_out = static_cast<float*>(ring_out);
  a.ring_slot = ring_slot;
  a.n_ring = n_ring;
  a.B = B;
  a.K = K;
  a.N = N;
  a.mode = mode;
  a.kc = kc;
  const size_t smem = static_cast<size_t>(bb) * n_stage * (kc + 1) * sizeof(float);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bb == 1)
    err = launch<1>(a, S, smem, st);
  else if (bb == 2)
    err = launch<2>(a, S, smem, st);
  else if (bb == 4)
    err = launch<4>(a, S, smem, st);
  else
    err = launch<8>(a, S, smem, st);
  return static_cast<int>(err);
}
