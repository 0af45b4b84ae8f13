// Kernel B1: masked synaptic product + LIF step, written by hand for Hopper
// (sm_90a). Entry point: repro_lif_step (plain C, loaded with ctypes by
// repro_torch/kernels/lif_step.py).
//
// Replaces repro/kernels/lif_step.py::_fused_kernel (entry fused_lif_step):
//   acc = s @ (w * c)   (mask applied per element, f32 accumulation)
//   then the shared LIF epilogue (lif_epilogue.cuh) -> v', r', y'.
//
// Two options serve the event backend's dense arm (event_dispatch.cu): c may
// be null, when w is the premasked W*C, and a device gate (run_if, one flag
// per slot, or one for all) makes every block of a slot return at once unless
// the slot's flag is set, so the caller can launch B1 and the event kernel
// each tick and let the device pick, per network, the one that writes.
//
// What bounds it on this card: the weight bytes. Every tick streams w and c
// once, 2 * K * N * 4 bytes per slot (128 MiB at K = N = 4096, about 40 us at
// 3.35 TB/s), against B * K * N multiply-adds, a few per byte at serving batch.
// The spikes, state and rows are a few hundred KiB.
//
// Design: the product is masked_product.cuh's (asynchronous copies into
// a shared-memory ring, K split across a cluster where the grid is thin),
// then the epilogue in the cluster's rank-0 block, one thread per (row,
// column) of the tile. Grid (ceil(N / 128) * ks, ceil(B / BB), S), clusters of
// ks blocks along x; the slot axis replaces the reference's vmap, and shared
// weights pass a slot stride of 0. The plan comes from kernels/_plan.py.
//
// The gate is read before anything else: the flag is written by an earlier
// launch on the stream and never changes during this one. Clusters run along
// x, so every block of a K-split cluster belongs to one slot (blockIdx.z) and
// reads the same flag, run_if[slot * run_if_slot]: all of them take the same
// branch and return together before any cluster barrier, and a closed gate
// writes nothing of its slot.
#include <cuda_runtime.h>

#include "lif_epilogue.cuh"
#include "masked_product.cuh"

namespace {

using repro_torch::LifRows;
namespace mp = repro_torch::mp;

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
  const unsigned char* run_if;  // (S | 1,) device flags, or null: always run
  long long run_if_slot;        // 1 per slot, 0 one flag for every slot
  int B, K, N, mode;
  mp::Plan plan;
};

template <int BB, bool kMasked>
__global__ void __launch_bounds__(mp::kThreads, 1) lif_step_kernel(LifStepArgs a) {
  // The other arm writes this slot's tick.
  if (a.run_if != nullptr && !a.run_if[blockIdx.z * a.run_if_slot]) return;
  extern __shared__ __align__(128) unsigned char smem[];
  int tile, k_begin, k_end;
  mp::block_range(a.plan, a.K, &tile, &k_begin, &k_end);
  const int n0 = tile * mp::kBlockN;
  const int b0 = blockIdx.y * BB;
  const long long slot = blockIdx.z;

  mp::Operand op;
  op.s = a.s + slot * a.s_slot + static_cast<long long>(b0) * a.K;
  op.s_row = a.K;
  op.s_plane = 0;
  op.n_planes = 1;
  op.nb = min(BB, a.B - b0);
  op.w = a.w + slot * a.w_slot + n0;
  op.c = kMasked ? a.c + slot * a.c_slot + n0 : nullptr;
  op.d = nullptr;
  op.N = a.N;
  op.ncols = min(mp::kBlockN, a.N - n0);
  op.k_begin = k_begin;
  op.k_end = k_end;
  op.rs = 0;
  if (!mp::masked_product<BB, kMasked, false>(op, a.plan, smem)) return;

  const float* acc = mp::sums(smem);
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
  }
}

template <int BB>
cudaError_t launch(const LifStepArgs& a, int S, cudaStream_t stream) {
  const dim3 grid((a.N + mp::kBlockN - 1) / mp::kBlockN * a.plan.ks, (a.B + BB - 1) / BB, S);
  if (a.c != nullptr) return mp::launch<lif_step_kernel<BB, true>>(grid, a.plan, stream, a);
  return mp::launch<lif_step_kernel<BB, false>>(grid, a.plan, stream, a);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success); cudaErrorInvalidValue
// for a shape or plan it cannot take. Never synchronises and allocates
// nothing: the caller owns every buffer. The last six ints are the plan
// (kernels/_plan.py Plan.args); the fill follows from the operands' alignment.
extern "C" int repro_lif_step(
    const void* s, long long s_slot, const void* w, long long w_slot, const void* c,
    long long c_slot, const void* v, const void* r, const void* drive, const void* v_th,
    const void* leak, const void* r_ref, const void* gain, const void* i_bias,
    const void* v_reset, long long row_slot, void* v_out, void* r_out, void* y_out,
    const void* run_if, long long run_if_slot, int S, int B, int K, int N, int mode, int bb,
    int kt, int stages,
    int ks, int k_chunk, int smem, void* stream) {
  if (S < 1 || B < 1 || N < 1 || K < 0 || S > 65535 || (mode != 0 && mode != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  mp::Plan plan{bb, kt, stages, ks, k_chunk, smem, false};
  const bool rows_aligned = mp::aligned16(s) && mp::aligned16(w) &&
                            (c == nullptr || mp::aligned16(c)) && s_slot % 4 == 0 &&
                            w_slot % 4 == 0 && c_slot % 4 == 0;
  if (!mp::plan_ok(plan, B, K, c != nullptr ? 2 : 1, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  plan.async = mp::async_fill(plan, K, N, rows_aligned);
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
  a.run_if_slot = run_if_slot;
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
