// The telemetry kernel: one tick of TickTelemetry folded into its
// accumulators, written by hand for Hopper (sm_90a). Entry point:
// repro_telemetry (plain C, loaded with ctypes by
// repro_torch/kernels/telemetry.py).
//
// Replaces no TPU kernel: the reference does this step with one XLA variadic
// reduce in repro/obs/telemetry.py (TickTelemetry.accumulate), "a single
// kernel per tick instead of four". This is that kernel. For every row of the
// post-tick state (y, v, r as (rows, n)) it updates, in place:
//   ticks    += 1
//   spikes   += sum_n y
//   v_sum    += (sum_n v) / n
//   v_max     = max(v_max, max_n v)
//   ref_sum  += (count_n r > 0) / n
//   overflow += over[g]                     (event backend; else nothing)
//   policy   += take_dense[g] & !over[g]    (the adaptive knee; else nothing)
//   dw_l1    += sum_p dw[g', p, 0],  dw_sq += sum_p dw[g', p, 1]
// where g and g' are the row's network (a slot, or one for all rows) and dw
// holds kernel B5's per-block partials of |w' - w| and (w' - w)^2 (or the
// plain plasticity pass's one partial per network). The flags are device
// bools written by earlier launches, so the tick loop never syncs with the
// host.
//
// What bounds it on this card: launches. At 8 slots x 4096 neurons it reads
// 384 KiB (y, v, r) and a few hundred bytes of accumulators and partials,
// about 0.1 us of memory time against a few microseconds of launch. So the
// design is the simplest that does all of it in one launch: one block of 1024
// threads per row (8 blocks at the served shape, so each thread keeps several
// loads in flight rather than a long chain), each thread striding over the
// neurons, then a fixed-order tree (warp shuffles, then the warps in order),
// so two launches give the same bits.
// Every row of a network sums the same partials in the same order, so they
// all add the same total. Each division is a correctly rounded __fdiv_rn, as
// the plain twin's division by a tensor is. The nine accumulators are the
// rows of one (9, rows) int32 buffer (the float ones reinterpreted), so the
// host passes one pointer.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;  // a row of 4096 in 4 strides: few blocks, many loads in flight
constexpr int kWarps = kThreads / 32;

struct TelemetryArgs {
  const void* y;   // (rows, n) f32, or int32 (the int datapath)
  const void* v;   // (rows, n) f32, or int32
  const int* r;    // (rows, n)
  int rows, n;
  const unsigned char* over;        // per network, or null
  int over_rows;                    // rows per flag (rows: one flag for all)
  const unsigned char* take_dense;  // per network, or null
  int dense_rows;
  const float* dw;                  // (G, P, 2) partials, or null
  int dw_rows, dw_parts;            // rows per group, P
  int* ticks;  // the accumulators: rows of one (9, rows) buffer
  float* spikes;
  float* v_sum;
  float* v_max;
  float* ref_sum;
  int* overflow;
  int* policy;
  float* dw_l1;
  float* dw_sq;
};

__device__ __forceinline__ float as_float(const void* p, long long i, bool is_int) {
  return is_int ? static_cast<float>(static_cast<const int*>(p)[i])
                : static_cast<const float*>(p)[i];
}

// Butterfly sums and max over the warp: every lane ends with the same value.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ int warp_count(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <bool kIntY, bool kIntV>
__global__ void __launch_bounds__(kThreads) telemetry_kernel(TelemetryArgs a) {
  __shared__ float red[5][kWarps];
  __shared__ int cnt[kWarps];
  const int row = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long base = static_cast<long long>(row) * a.n;
  float sy = 0.0f, sv = 0.0f, mv = -INFINITY, l1 = 0.0f, sq = 0.0f;
  int cr = 0;
  for (int i = threadIdx.x; i < a.n; i += kThreads) {
    sy = __fadd_rn(sy, as_float(a.y, base + i, kIntY));
    const float vi = as_float(a.v, base + i, kIntV);
    sv = __fadd_rn(sv, vi);
    mv = fmaxf(mv, vi);
    cr += a.r[base + i] > 0;
  }
  if (a.dw != nullptr) {
    const float* part = a.dw + static_cast<long long>(row / a.dw_rows) * a.dw_parts * 2;
    for (int p = threadIdx.x; p < a.dw_parts; p += kThreads) {
      l1 = __fadd_rn(l1, part[2 * p]);
      sq = __fadd_rn(sq, part[2 * p + 1]);
    }
  }
  sy = warp_sum(sy);
  sv = warp_sum(sv);
  mv = warp_max(mv);
  l1 = warp_sum(l1);
  sq = warp_sum(sq);
  cr = warp_count(cr);
  if (lane == 0) {
    red[0][warp] = sy;
    red[1][warp] = sv;
    red[2][warp] = mv;
    red[3][warp] = l1;
    red[4][warp] = sq;
    cnt[warp] = cr;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  sy = red[0][0];
  sv = red[1][0];
  mv = red[2][0];
  l1 = red[3][0];
  sq = red[4][0];
  cr = cnt[0];
  for (int w = 1; w < kWarps; ++w) {
    sy = __fadd_rn(sy, red[0][w]);
    sv = __fadd_rn(sv, red[1][w]);
    mv = fmaxf(mv, red[2][w]);
    l1 = __fadd_rn(l1, red[3][w]);
    sq = __fadd_rn(sq, red[4][w]);
    cr += cnt[w];
  }
  const float n = static_cast<float>(a.n);
  a.ticks[row] += 1;
  a.spikes[row] = __fadd_rn(a.spikes[row], sy);
  a.v_sum[row] = __fadd_rn(a.v_sum[row], __fdiv_rn(sv, n));
  a.v_max[row] = fmaxf(a.v_max[row], mv);
  a.ref_sum[row] = __fadd_rn(a.ref_sum[row], __fdiv_rn(static_cast<float>(cr), n));
  const bool over = a.over != nullptr && a.over[row / a.over_rows] != 0;
  if (a.over != nullptr) a.overflow[row] += over ? 1 : 0;
  if (a.take_dense != nullptr) a.policy[row] += (a.take_dense[row / a.dense_rows] != 0 && !over);
  if (a.dw != nullptr) {
    a.dw_l1[row] = __fadd_rn(a.dw_l1[row], l1);
    a.dw_sq[row] = __fadd_rn(a.dw_sq[row], sq);
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success), cudaErrorInvalidValue
// for a shape it cannot take. Never synchronises and allocates nothing: the
// caller owns every buffer. over_rows, dense_rows and dw_rows give how many
// consecutive rows share one flag or one group of partials (rows for a single
// one); each must divide rows. acc is the (9, rows) buffer of ticks, spikes,
// v_sum, v_max, ref_sum, overflow, policy_dense, dw_l1 and dw_sq.
extern "C" int repro_telemetry(const void* y, int y_int, const void* v, int v_int,
                               const void* r, int rows, int n, const void* over,
                               int over_rows, const void* take_dense, int dense_rows,
                               const void* dw, int dw_rows, int dw_parts, void* acc,
                               void* stream) {
  const auto divides = [rows](const void* p, int k) {
    return p == nullptr || (k >= 1 && rows % k == 0);
  };
  if (rows < 1 || n < 1 || !divides(over, over_rows) || !divides(take_dense, dense_rows) ||
      !divides(dw, dw_rows) || (dw != nullptr && dw_parts < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  TelemetryArgs a;
  a.y = y;
  a.v = v;
  a.r = static_cast<const int*>(r);
  a.rows = rows;
  a.n = n;
  a.over = static_cast<const unsigned char*>(over);
  a.over_rows = over_rows;
  a.take_dense = static_cast<const unsigned char*>(take_dense);
  a.dense_rows = dense_rows;
  a.dw = static_cast<const float*>(dw);
  a.dw_rows = dw_rows;
  a.dw_parts = dw_parts;
  int* const field = static_cast<int*>(acc);
  const auto f32 = [&](int i) { return reinterpret_cast<float*>(field + i * rows); };
  a.ticks = field;
  a.spikes = f32(1);
  a.v_sum = f32(2);
  a.v_max = f32(3);
  a.ref_sum = f32(4);
  a.overflow = field + 5 * rows;
  a.policy = field + 6 * rows;
  a.dw_l1 = f32(7);
  a.dw_sq = f32(8);
  const auto st = static_cast<cudaStream_t>(stream);
  if (y_int && v_int)
    telemetry_kernel<true, true><<<rows, kThreads, 0, st>>>(a);
  else if (y_int)
    telemetry_kernel<true, false><<<rows, kThreads, 0, st>>>(a);
  else if (v_int)
    telemetry_kernel<false, true><<<rows, kThreads, 0, st>>>(a);
  else
    telemetry_kernel<false, false><<<rows, kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
