// Kernels B3 and B4: event-driven dispatch (spike-list gather + LIF step),
// written by hand for Hopper (sm_90a). Entry point: repro_event_dispatch
// (plain C, loaded with ctypes by repro_torch/kernels/event_dispatch.py).
//
// Replaces repro/kernels/event_dispatch.py:
//   B3 _event_db_kernel (entry event_lif_dispatch_db): per batch row, walk
//      only the counts[b] live slots of the spike list; the sentinel tail is
//      never read.
//   B4 _event_kernel (entry event_lif_dispatch): walk all k slots; a
//      sentinel slot points at the all-zero row K of w and adds 0.
// Both: acc = sum over the walked slots j, in ascending order, of row
// idx[b, j] of W*C; then the shared LIF epilogue (lif_epilogue.cuh).
//
// What bounds it on this card: the gathered weight bytes. A row of spike
// list reads sum(counts) * N * 4 bytes of W*C (B3) or B * k * N * 4 (B4),
// against one add per byte read; at snn-event FULL (K = N = 4096, 16 rows,
// about 5 % of neurons spiking) that is about 50 MiB per tick, against the
// 64 MiB the dense product streams for every tick whatever the activity.
//
// Design (a simple first version; cp.async double buffering, which the TPU
// kernel's two-slot DMA does, comes later):
// - A block owns one batch row of one slot and 128 output columns, one column
//   per thread. Grid (ceil(N/128), B, S). The TPU kernel's sequential k grid
//   axis (B4) and its fori_loop over the live slots (B3) become one loop
//   inside the block.
// - The block stages a chunk of its row's spike ids in shared memory, then
//   each thread reads the 128-wide, coalesced slice of each listed row of
//   W*C. Sixteen rows are loaded before they are added, to keep bytes in
//   flight; they are added in slot order, one __fadd_rn each, which is the
//   plain twin's order, so the result is bitwise the twin's on any input.
// - A device gate (skip, one flag per slot or one for all) lets the caller
//   launch this kernel and the dense kernel B1 every tick and decide on the
//   device, per network, which one writes: when a slot's flag is set every
//   block of that slot returns before reading anything. This replaces the
//   reference's lax.cond on the overflow / adaptive-knee predicate (taken per
//   network under its vmap) with no host round trip.
// - The ragged edge N % 128 is bounds-checked, and a row id outside w is
//   read as nothing: no padding, no sentinel reads past the matrix.
#include <cuda_runtime.h>

#include "lif_epilogue.cuh"

namespace {

using repro_torch::LifRows;

constexpr int kBlockN = 128;  // output columns per block, one per thread
constexpr int kChunk = 512;   // spike ids staged in shared memory per pass
constexpr int kUnroll = 16;   // weight rows loaded before they are added

struct EventArgs {
  const int* idx;     // (S, B, k) spike ids, ascending, sentinel-padded
  const int* counts;  // (S, B) live slots per row, or null: walk all k (B4)
  int k;
  const float* w;  // (S | 1, Kw, N) W*C (B4: row Kw - 1 is the zero sentinel)
  long long w_slot;
  int Kw;
  const float* v;      // (S, B, N)
  const int* r;        // (S, B, N)
  const float* drive;  // (S, B, N) or null
  LifRows rows;        // (S | 1, N) each
  long long row_slot;
  float* v_out;
  int* r_out;
  float* y_out;
  const unsigned char* skip;  // (S | 1,) device flags, or null
  long long skip_slot;        // 1 per slot, 0 one flag for every slot
  int B, N, mode;
};

template <bool kLive>
__global__ void __launch_bounds__(kBlockN) event_dispatch_kernel(EventArgs a) {
  // The dense arm writes this slot's tick.
  if (a.skip != nullptr && a.skip[blockIdx.z * a.skip_slot]) return;
  __shared__ int sh_idx[kChunk];
  const int n = blockIdx.x * kBlockN + threadIdx.x;
  const int b = blockIdx.y;
  const long long slot = blockIdx.z;
  const long long row = slot * a.B + b;
  const bool live = n < a.N;
  const int* ids = a.idx + row * a.k;
  int m = a.k;
  if (kLive) m = min(max(a.counts[row], 0), a.k);
  const float* w = a.w + slot * a.w_slot + n;

  float acc = 0.0f;
  for (int j0 = 0; j0 < m; j0 += kChunk) {
    const int jc = min(kChunk, m - j0);
    __syncthreads();
    for (int i = threadIdx.x; i < jc; i += kBlockN) sh_idx[i] = ids[j0 + i];
    __syncthreads();
    if (!live) continue;
    int j = 0;
    for (; j + kUnroll <= jc; j += kUnroll) {
      float wv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int id = sh_idx[j + u];
        wv[u] = (static_cast<unsigned>(id) < static_cast<unsigned>(a.Kw))
                    ? __ldg(w + static_cast<long long>(id) * a.N)
                    : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (static_cast<unsigned>(sh_idx[j + u]) < static_cast<unsigned>(a.Kw))
          acc = __fadd_rn(acc, wv[u]);
      }
    }
    for (; j < jc; ++j) {
      const int id = sh_idx[j];
      if (static_cast<unsigned>(id) < static_cast<unsigned>(a.Kw))
        acc = __fadd_rn(acc, __ldg(w + static_cast<long long>(id) * a.N));
    }
  }
  if (!live) return;

  const long long ro = slot * a.row_slot;
  const LifRows p{a.rows.v_th + ro, a.rows.leak + ro, a.rows.r_ref + ro,
                  a.rows.gain + ro, a.rows.i_bias + ro, a.rows.v_reset + ro};
  const long long at = row * a.N + n;
  const float syn = a.drive ? __fadd_rn(acc, a.drive[at]) : acc;
  float v_new, y;
  int r_new;
  repro_torch::lif_epilogue(a.mode, syn, a.v[at], a.r[at], p, n, &v_new, &r_new, &y);
  a.v_out[at] = v_new;
  a.r_out[at] = r_new;
  a.y_out[at] = y;
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Never synchronises and
// allocates nothing: the caller owns every buffer. counts == null walks all k
// slots (kernel B4); otherwise only the live prefix of each row (kernel B3).
extern "C" int repro_event_dispatch(
    const void* idx, const void* counts, int k, const void* w, long long w_slot, int Kw,
    const void* v, const void* r, const void* drive, const void* v_th, const void* leak,
    const void* r_ref, const void* gain, const void* i_bias, const void* v_reset,
    long long row_slot, void* v_out, void* r_out, void* y_out, const void* skip,
    long long skip_slot, int S, int B, int N, int mode, void* stream) {
  if (S < 1 || B < 1 || N < 1 || k < 0 || Kw < 1 || S > 65535 || B > 65535 ||
      (mode != 0 && mode != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  EventArgs a;
  a.idx = static_cast<const int*>(idx);
  a.counts = static_cast<const int*>(counts);
  a.k = k;
  a.w = static_cast<const float*>(w);
  a.w_slot = w_slot;
  a.Kw = Kw;
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
  a.skip = static_cast<const unsigned char*>(skip);
  a.skip_slot = skip_slot;
  a.B = B;
  a.N = N;
  a.mode = mode;
  const dim3 grid((N + kBlockN - 1) / kBlockN, B, S);
  const auto st = static_cast<cudaStream_t>(stream);
  if (a.counts != nullptr)
    event_dispatch_kernel<true><<<grid, kBlockN, 0, st>>>(a);
  else
    event_dispatch_kernel<false><<<grid, kBlockN, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
