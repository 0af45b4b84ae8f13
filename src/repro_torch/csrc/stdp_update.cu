// Kernel B5: one learning tick of pair STDP / R-STDP, written by hand for
// Hopper (sm_90a). Entry point: repro_stdp_update (plain C, loaded with ctypes
// by repro_torch/kernels/stdp_update.py).
//
// Replaces repro/kernels/stdp_update.py::_stdp_kernel (entry fused_stdp_step):
//   x_pre'  = decay_pre  * x_pre  + s_pre            (B, K)
//   x_post' = decay_post * x_post + s_post           (B, N)
//   dw      = (a_plus * sum_b x_pre'[b,k] s_post[b,n]
//              - a_minus * sum_b s_pre[b,k] x_post'[b,n]) * c[k,n]
//   rstdp:  elig' = decay_elig * elig + dw;  upd = (lr_reward * reward) * elig'
//   stdp:   upd = dw (elig is left untouched: not read, not written)
//   w'      = c > 0 ? clip(w + upd, w_min, w_max) : w   (c == 0: bit-identical)
// with the engine's learn_until gate folded in: where tick >= learn_until[slot]
// nothing changes (w, elig and both traces keep their values).
//
// What bounds it on this card: bytes. In a slot whose gate is open the plastic
// mask c (K x N f32) is read; where c > 0, w is read and written; for R-STDP
// elig is read and written everywhere. At K = N = 4096 that is 3 x 64 MiB for a
// fully plastic STDP slot and 5 x 64 MiB for R-STDP; a slot whose gate is closed
// (a frozen tenant's slot in a served learning wave) reads no matrix. The
// traces and spikes are a few KiB. The outer products are 2 * B multiply-adds
// per synapse: far below the f32 rate.
//
// Design (a simple first version):
// - A block owns one slot, 16 rows (k) and 128 columns (n), one column per
//   thread. Grid (ceil(N/128), ceil(K/16), S); a shared mask passes a slot
//   stride of 0, so one network is S = 1 with no copies.
// - No cross-block reduction: the block loops over all B batch rows itself
//   (the TPU kernel's sequential B grid axis and its VMEM accumulator), staging
//   8 rows of the decayed traces and spikes in shared memory at a time, and
//   sums LTP and LTD for its 16 x 128 synapses in registers, in batch order.
//   At B = 1 each sum is a single exact product, so the result equals the
//   plain twin's bitwise.
// - The trace outputs go to buffers other than the inputs: every block
//   recomputes x_pre' for its rows and x_post' for its columns from the input
//   traces, so an in-place write would race. Blocks of column tile 0 write
//   x_pre', blocks of row tile 0 write x_post': each element once.
// - w and elig are updated in place: each element is read and written by the
//   same thread, and the tick kernel that read w earlier ran before this one in
//   stream order.
// - The reward (the TPU kernel's SMEM scalar), the tick counter and the
//   learn_until bound are read from device memory, so the tick loop never syncs
//   with the host. A block whose gate is closed copies the traces through and
//   returns without reading c.
// - The mask is loaded first; w is loaded only where c > 0.
// - Every operation is an explicit round-to-nearest intrinsic in the reference's
//   association order (and the file is compiled with --fmad=false), so nothing
//   is contracted into an FMA the twin does not do.
#include <cuda_runtime.h>

namespace {

constexpr int kBlockN = 128;  // columns per block, one per thread
constexpr int kTileK = 16;    // rows per block, summed in registers
constexpr int kChunkB = 8;    // batch rows staged in shared memory per pass

struct StdpArgs {
  const float* s_pre;          // (S, B, K)
  const float* x_pre;          // (S, B, K)
  const float* s_post;         // (S, B, N)
  const float* x_post;         // (S, B, N)
  float* w;                    // (S | 1, K, N), in place
  long long w_slot;
  const float* c;              // (S | 1, K, N)
  long long c_slot;
  float* elig;                 // (S | 1, K, N), in place (rstdp only)
  long long elig_slot;
  const float* reward;         // (S | 1,) or null (stdp)
  long long reward_slot;
  const int* tick;             // () tick counter, or null (gate always open)
  const int* learn_until;      // (S | 1,) or null
  long long until_slot;
  float* x_pre_out;            // (S, B, K)
  float* x_post_out;           // (S, B, N)
  int B, K, N, rstdp;
  float a_plus, a_minus, decay_pre, decay_post, decay_elig, lr_reward, w_min, w_max;
};

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__global__ void __launch_bounds__(kBlockN) stdp_update_kernel(StdpArgs a) {
  __shared__ float sh_xpre[kChunkB][kTileK];
  __shared__ float sh_spre[kChunkB][kTileK];
  __shared__ float sh_xpost[kChunkB][kBlockN];
  __shared__ float sh_spost[kChunkB][kBlockN];

  const int tid = threadIdx.x;
  const int n = blockIdx.x * kBlockN + tid;
  const int k0 = blockIdx.y * kTileK;
  const long long slot = blockIdx.z;
  const bool live = n < a.N;
  const bool write_pre = blockIdx.x == 0;   // x_pre' rows [k0, k0 + kTileK)
  const bool write_post = blockIdx.y == 0;  // x_post' column n
  const long long pre0 = slot * a.B * static_cast<long long>(a.K);
  const long long post0 = slot * a.B * static_cast<long long>(a.N);
  const bool open =
      a.learn_until == nullptr || *a.tick < a.learn_until[slot * a.until_slot];

  if (!open) {
    // Gate closed: the traces keep their values, w and elig are not touched.
    if (write_pre) {
      for (int i = tid; i < a.B * kTileK; i += kBlockN) {
        const int b = i / kTileK;
        const int k = k0 + i % kTileK;
        if (k < a.K) {
          const long long idx = pre0 + static_cast<long long>(b) * a.K + k;
          a.x_pre_out[idx] = a.x_pre[idx];
        }
      }
    }
    if (write_post && live) {
      for (int b = 0; b < a.B; ++b) {
        const long long idx = post0 + static_cast<long long>(b) * a.N + n;
        a.x_post_out[idx] = a.x_post[idx];
      }
    }
    return;
  }

  float ltp[kTileK], ltd[kTileK];
#pragma unroll
  for (int kk = 0; kk < kTileK; ++kk) ltp[kk] = ltd[kk] = 0.0f;

  for (int b0 = 0; b0 < a.B; b0 += kChunkB) {
    const int nb = min(kChunkB, a.B - b0);
    __syncthreads();
    for (int i = tid; i < nb * kTileK; i += kBlockN) {
      const int bb = i / kTileK;
      const int kk = i % kTileK;
      const int k = k0 + kk;
      float xs = 0.0f, ss = 0.0f;
      if (k < a.K) {
        const long long idx = pre0 + static_cast<long long>(b0 + bb) * a.K + k;
        ss = a.s_pre[idx];
        xs = __fadd_rn(__fmul_rn(a.decay_pre, a.x_pre[idx]), ss);
        if (write_pre) a.x_pre_out[idx] = xs;
      }
      sh_xpre[bb][kk] = xs;
      sh_spre[bb][kk] = ss;
    }
    for (int bb = 0; bb < nb; ++bb) {
      float xs = 0.0f, ss = 0.0f;
      if (live) {
        const long long idx = post0 + static_cast<long long>(b0 + bb) * a.N + n;
        ss = a.s_post[idx];
        xs = __fadd_rn(__fmul_rn(a.decay_post, a.x_post[idx]), ss);
        if (write_post) a.x_post_out[idx] = xs;
      }
      sh_xpost[bb][tid] = xs;
      sh_spost[bb][tid] = ss;
    }
    __syncthreads();
    for (int bb = 0; bb < nb; ++bb) {
      const float xpo = sh_xpost[bb][tid];
      const float spo = sh_spost[bb][tid];
#pragma unroll
      for (int kk = 0; kk < kTileK; ++kk) {
        ltp[kk] = __fadd_rn(ltp[kk], __fmul_rn(sh_xpre[bb][kk], spo));
        ltd[kk] = __fadd_rn(ltd[kk], __fmul_rn(sh_spre[bb][kk], xpo));
      }
    }
  }
  if (!live) return;

  const long long col = static_cast<long long>(k0) * a.N + n;
  const float* c = a.c + slot * a.c_slot + col;
  float* w = a.w + slot * a.w_slot + col;
  float* elig = a.elig + slot * a.elig_slot + col;
  const int rows = min(kTileK, a.K - k0);

  // Loads first (all independent, so they are in flight together), then the
  // update; w only where the mask lets the synapse learn.
  float cv[kTileK], wv[kTileK], ev[kTileK];
#pragma unroll
  for (int kk = 0; kk < kTileK; ++kk) {
    const long long off = static_cast<long long>(kk) * a.N;
    cv[kk] = kk < rows ? __ldg(c + off) : 0.0f;
    wv[kk] = cv[kk] > 0.0f ? w[off] : 0.0f;
    ev[kk] = (a.rstdp && kk < rows) ? elig[off] : 0.0f;
  }
  const float gain = a.rstdp ? __fmul_rn(a.lr_reward, a.reward[slot * a.reward_slot]) : 0.0f;
#pragma unroll
  for (int kk = 0; kk < kTileK; ++kk) {
    if (kk >= rows) break;
    const long long off = static_cast<long long>(kk) * a.N;
    const float dw =
        __fmul_rn(__fsub_rn(__fmul_rn(a.a_plus, ltp[kk]), __fmul_rn(a.a_minus, ltd[kk])), cv[kk]);
    float upd = dw;
    if (a.rstdp) {
      const float e_new = __fadd_rn(__fmul_rn(a.decay_elig, ev[kk]), dw);
      elig[off] = e_new;
      upd = __fmul_rn(gain, e_new);
    }
    if (cv[kk] > 0.0f) w[off] = clip(__fadd_rn(wv[kk], upd), a.w_min, a.w_max);
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Never synchronises and
// allocates nothing: the caller owns every buffer.
extern "C" int repro_stdp_update(
    const void* s_pre, const void* x_pre, const void* s_post, const void* x_post, void* w,
    long long w_slot, const void* c, long long c_slot, void* elig, long long elig_slot,
    const void* reward, long long reward_slot, const void* tick, const void* learn_until,
    long long until_slot, void* x_pre_out, void* x_post_out, int S, int B, int K, int N,
    int rstdp, float a_plus, float a_minus, float decay_pre, float decay_post,
    float decay_elig, float lr_reward, float w_min, float w_max, void* stream) {
  if (S < 1 || B < 1 || K < 1 || N < 1 || S > 65535 || (K + kTileK - 1) / kTileK > 65535 ||
      (rstdp != 0 && (reward == nullptr || elig == nullptr)) ||
      ((tick == nullptr) != (learn_until == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  StdpArgs a;
  a.s_pre = static_cast<const float*>(s_pre);
  a.x_pre = static_cast<const float*>(x_pre);
  a.s_post = static_cast<const float*>(s_post);
  a.x_post = static_cast<const float*>(x_post);
  a.w = static_cast<float*>(w);
  a.w_slot = w_slot;
  a.c = static_cast<const float*>(c);
  a.c_slot = c_slot;
  a.elig = static_cast<float*>(elig);
  a.elig_slot = elig_slot;
  a.reward = static_cast<const float*>(reward);
  a.reward_slot = reward_slot;
  a.tick = static_cast<const int*>(tick);
  a.learn_until = static_cast<const int*>(learn_until);
  a.until_slot = until_slot;
  a.x_pre_out = static_cast<float*>(x_pre_out);
  a.x_post_out = static_cast<float*>(x_post_out);
  a.B = B;
  a.K = K;
  a.N = N;
  a.rstdp = rstdp;
  a.a_plus = a_plus;
  a.a_minus = a_minus;
  a.decay_pre = decay_pre;
  a.decay_post = decay_post;
  a.decay_elig = decay_elig;
  a.lr_reward = lr_reward;
  a.w_min = w_min;
  a.w_max = w_max;
  const dim3 grid((N + kBlockN - 1) / kBlockN, (K + kTileK - 1) / kTileK, S);
  stdp_update_kernel<<<grid, kBlockN, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
