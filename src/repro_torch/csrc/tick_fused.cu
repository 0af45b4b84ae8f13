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
// Design: the ring pointers [tick % D, (tick + 1) % D] are read from a
// device int32 pair (the TPU kernel's scalar prefetch), so the tick loop never
// syncs with the host and changing the tick rebuilds nothing. The product is
// masked_product.cuh's: the block's spike history for each K tile (one ring
// plane, or all D planes with per-synapse delays) rides in the same
// asynchronous stage as the weight tile, and K is split across a cluster
// where the grid is thin. The cluster's rank-0 block then runs the epilogue
// (lif_epilogue.cuh) and writes v', r', y' and the ring, one thread per (row,
// column) of the tile. Grid (ceil(N / 128) * ks, ceil(B / BB), S); shared
// weights pass a slot stride of 0, so one network is S = 1 with no copies.
// Ragged edges are bounds-checked (the reference pads instead, with r = 1 and
// v_th = FLT_MAX / 2). The plan comes from kernels/_plan.py.
//
// Ring write, and why it is race-free (blocks run in no order; within a
// cluster only rank 0 writes anything, after every block of the cluster has
// read all it reads; the other blocks only read, and read the same operands
// as the unsplit kernel did, so the rules below are unchanged by the split):
// - No per-synapse delays, D > 1 (ring_in == null): blocks read only slot
//   tick % D and write only slot (tick + 1) % D, which differ, so y' is written
//   into the ring in place.
// - Per-synapse delays (ring_in != null): every block reads every slot, slot
//   (tick + 1) % D included, so the kernel writes a separate ring_out (the
//   other D - 1 slots copied through, y' into the write slot). The engine
//   ping-pongs two ring buffers.
// - D = 1: the read operand is the previous y itself; y' goes to a fresh
//   buffer (never aliasing it, since other clusters read it through their
//   whole K range) and the ring is not written, as in the reference.
#include <cuda_runtime.h>

#include "lif_epilogue.cuh"
#include "masked_product.cuh"

namespace {

using repro_torch::LifRows;
namespace mp = repro_torch::mp;

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
  int B, K, N, mode;
  mp::Plan plan;
};

template <int BB, bool HAS_C, bool DELAYS>
__global__ void __launch_bounds__(mp::kThreads, 1) tick_fused_kernel(TickArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  int tile, k_begin, k_end;
  mp::block_range(a.plan, a.K, &tile, &k_begin, &k_end);
  const int n0 = tile * mp::kBlockN;
  const int b0 = blockIdx.y * BB;
  const long long slot = blockIdx.z;
  const int rs = a.slots[0];

  mp::Operand op;
  op.s = a.read + slot * a.read_slot + static_cast<long long>(b0) * a.read_row +
         (DELAYS ? 0 : static_cast<long long>(rs) * a.K);
  op.s_row = a.read_row;
  op.s_plane = a.K;
  op.n_planes = DELAYS ? a.n_read : 1;
  op.nb = min(BB, a.B - b0);
  op.w = a.w + slot * a.w_slot + n0;
  op.c = HAS_C ? a.c + slot * a.c_slot + n0 : nullptr;
  op.d = DELAYS ? a.delays + slot * a.delays_slot + n0 : nullptr;
  op.N = a.N;
  op.ncols = min(mp::kBlockN, a.N - n0);
  op.k_begin = k_begin;
  op.k_end = k_end;
  op.rs = rs;
  if (!mp::masked_product<BB, HAS_C, DELAYS>(op, a.plan, smem)) return;

  const float* acc = mp::sums(smem);
  const int ws = a.slots[1];
  const long long ro = slot * a.row_slot;
  const LifRows p{a.rows.v_th + ro, a.rows.leak + ro, a.rows.r_ref + ro,
                  a.rows.gain + ro, a.rows.i_bias + ro, a.rows.v_reset + ro};
  for (int i = threadIdx.x; i < op.nb * mp::kBlockN; i += mp::kThreads) {
    const int b = i / mp::kBlockN;
    const int col = i - b * mp::kBlockN;
    if (col >= op.ncols) continue;
    const int n = n0 + col;
    const long long idx = (slot * a.B + b0 + b) * static_cast<long long>(a.N) + n;
    const float syn = a.drive ? __fadd_rn(acc[i], a.drive[idx]) : acc[i];
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
cudaError_t launch(const TickArgs& a, int S, cudaStream_t stream) {
  const dim3 grid((a.N + mp::kBlockN - 1) / mp::kBlockN * a.plan.ks, (a.B + BB - 1) / BB, S);
  const bool has_c = a.c != nullptr;
  const bool delays = a.delays != nullptr;
  if (has_c && delays)
    return mp::launch<tick_fused_kernel<BB, true, true>>(grid, a.plan, stream, a);
  if (has_c) return mp::launch<tick_fused_kernel<BB, true, false>>(grid, a.plan, stream, a);
  if (delays) return mp::launch<tick_fused_kernel<BB, false, true>>(grid, a.plan, stream, a);
  return mp::launch<tick_fused_kernel<BB, false, false>>(grid, a.plan, stream, a);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success); cudaErrorInvalidValue
// for a shape or plan it cannot take (kernels/_plan.py shrinks the stages to
// fit a deep ring and raises where even one cannot be staged). Never
// synchronises and allocates nothing: the caller owns every buffer. The last
// six ints are the plan (Plan.args); the fill follows from the operands'
// alignment.
extern "C" int repro_tick_fused(
    const void* slots, const void* read, long long read_slot, long long read_row, int n_read,
    const void* w, long long w_slot, const void* c, long long c_slot, const void* delays,
    long long delays_slot, const void* v, const void* r, const void* drive, const void* v_th,
    const void* leak, const void* r_ref, const void* gain, const void* i_bias,
    const void* v_reset, long long row_slot, void* v_out, void* r_out, void* y_out,
    const void* ring_in, void* ring_out, long long ring_slot, int n_ring, int S, int B, int K,
    int N, int mode, int bb, int kt, int stages, int ks, int k_chunk, int smem,
    void* stream) {
  if (S < 1 || B < 1 || N < 1 || K < 0 || n_read < 1 || S > 65535 ||
      (mode != 0 && mode != 1) || (ring_out != nullptr && n_ring < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  mp::Plan plan{bb, kt, stages, ks, k_chunk, smem, false};
  const bool rows_aligned =
      mp::aligned16(read) && mp::aligned16(w) && (c == nullptr || mp::aligned16(c)) &&
      (delays == nullptr || mp::aligned16(delays)) && read_slot % 4 == 0 &&
      read_row % 4 == 0 && w_slot % 4 == 0 && c_slot % 4 == 0 && delays_slot % 4 == 0;
  const int planes = 1 + (c != nullptr ? 1 : 0) + (delays != nullptr ? 1 : 0);
  const int n_planes = delays != nullptr ? n_read : 1;
  if (!mp::plan_ok(plan, B, K, planes, n_planes))
    return static_cast<int>(cudaErrorInvalidValue);
  plan.async = mp::async_fill(plan, K, N, rows_aligned);

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
  a.plan = plan;
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (bb) {
    case 1: err = launch<1>(a, S, st); break;
    case 2: err = launch<2>(a, S, st); break;
    case 4: err = launch<4>(a, S, st); break;
    case 8: err = launch<8>(a, S, st); break;
    case 16: err = launch<16>(a, S, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
