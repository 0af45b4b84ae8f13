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
// Design (kernels/_stream.py stdp_plan):
// - A persistent grid of two blocks per SM walks (slot, tile) units: a tile
//   is 32 rows x 128 columns, each of 8 warps owning 4 rows and each lane 4
//   columns. Every block walks the slots in order and takes tiles p,
//   p + blocks, ... of each open slot, so one open slot is spread over the
//   whole card; a closed slot costs one branch per block, and the blocks copy
//   its traces through between them. This replaces a grid of one block per
//   tile, in which the blocks of closed slots (7 of 8 on a served learning
//   wave) still launched, read the gate and returned.
// - The c -> w dependency is off the critical path: each thread streams its
//   own 16-byte chunks of c (and elig) into a shared-memory ring kStages - 1
//   tiles ahead, and, once a tile's c chunk has landed, loads the chunk of w
//   behind it into registers one tile ahead, only where some c > 0 in it.
//   Sparse masks do not read w where nothing learns, and dense masks keep
//   both streams in flight; w waits in registers, so the ring holds c alone
//   (and elig) and two blocks fit an SM. A thread only ever reads the chunks
//   it copied itself, so the ring needs no barrier: cp.async.wait_group
//   orders it.
// - Traces: a tile's x_pre' rows and x_post' columns are computed once per
//   tile, up to 8 batch rows at a time, into shared memory; LTP and LTD sum
//   in batch order in registers (4 x 4 synapses per thread). Tiles of column
//   tile 0 write x_pre', tiles of row tile 0 write x_post': each once. At
//   B = 1 each sum is a single exact product, so the result equals the plain
//   twin's bitwise.
// - w and elig are updated in place: each element is read and written by the
//   same thread (a chunk of w is written back only where some c > 0 in it,
//   its c == 0 elements with the bits it read), and the tick kernel that read
//   w earlier ran before this one in stream order. The trace outputs go to
//   other buffers than the inputs.
// - The reward (the TPU kernel's SMEM scalar), the tick counter and the
//   learn_until bound are read from device memory, so the tick loop never syncs
//   with the host.
// - Rows that do not start on 16-byte boundaries (N % 4 != 0, unaligned
//   views) take the element fill: bounds-checked loads straight from device
//   memory, w only where c > 0, no ring.
// - Every operation is an explicit round-to-nearest intrinsic in the reference's
//   association order (and the file is compiled with --fmad=false), so nothing
//   is contracted into an FMA the twin does not do.
// - Optional dw statistics for the tick telemetry (kStats, a template flag:
//   without a statistics buffer the instantiations the served path ran before
//   are compiled and launched unchanged). With the buffer each thread sums
//   |w' - w| and (w' - w)^2 over the synapses it committed, in registers, where
//   old and new weight already sit: the committed delta, after the learn_until
//   gate and the clip, 0 where c == 0. When a block's walk leaves a slot it
//   reduces the sums in a fixed order (warp butterflies, then the warps in
//   order) and writes one partial per (slot, block), zero for every slot it
//   never visited: no atomics, so two launches give the same bits. The
//   telemetry kernel adds the partials of a slot in block order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileN = 128;          // columns per tile, 4 per lane
constexpr int kRowsPerWarp = 4;
constexpr int kTileK = kWarps * kRowsPerWarp;  // 32 rows per tile
constexpr int kChunkB = 8;           // batch rows of traces staged per pass
constexpr int kStages = 3;           // ring stages: c (and elig) two tiles ahead
constexpr int kPlaneFloats = kTileK * kTileN;
constexpr int kMaxSmem = 232448;

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
  float* stats;                // (S, blocks, 2) partials of |dw|, dw^2 (kStats only)
  int S, B, K, N, rstdp;
  int tiles_n, tiles;          // column tiles, tiles per slot
  float a_plus, a_minus, decay_pre, decay_post, decay_elig, lr_reward, w_min, w_max;
};

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ bool gate_open(const StdpArgs& a, int slot) {
  return a.learn_until == nullptr || *a.tick < a.learn_until[slot * a.until_slot];
}

// A block's place in its walk: (slot, tile), slot == S when it is done.
struct Cursor {
  int slot, t;
};

// Move c to the first unit at or after it that the block takes: tile
// blockIdx.x + i * gridDim.x of an open slot.
__device__ __forceinline__ void settle(Cursor& c, const StdpArgs& a) {
  while (c.slot < a.S) {
    if (c.t < a.tiles && gate_open(a, c.slot)) return;
    ++c.slot;
    c.t = blockIdx.x;
  }
}
__device__ __forceinline__ void advance(Cursor& c, const StdpArgs& a) {
  c.t += gridDim.x;
  if (c.t < a.tiles) return;  // the same slot, whose gate is open
  ++c.slot;
  c.t = blockIdx.x;
  settle(c, a);
}

// 16 bytes from global to shared (L2 only); src_bytes 0 reads nothing and
// zero-fills the destination.
__device__ __forceinline__ void copy16(void* dst, const void* src, int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
// All but this thread's Newest copy groups have landed.
template <int Newest>
__device__ __forceinline__ void wait_all_but() {
  asm volatile("cp.async.wait_group %0;" ::"n"(Newest) : "memory");
}
// 16 bytes from global memory into registers, cached in L2 only, issued where
// it stands (volatile: not sunk next to its use, one tile later).
__device__ __forceinline__ float4 load16(const float* p) {
  float4 v;
  asm volatile("ld.global.cg.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

struct Tile {
  int slot, k0, n0, kt, nt;
  __device__ Tile(const Cursor& c, const StdpArgs& a) {
    slot = c.slot;
    kt = c.t / a.tiles_n;
    nt = c.t - kt * a.tiles_n;
    k0 = kt * kTileK;
    n0 = nt * kTileN;
  }
};

// Plane p (0: c, 1: elig) of stage i of the ring: [kTileK][kTileN] floats.
template <bool kRstdp>
__device__ __forceinline__ float* plane(float* ring, int i, int p) {
  return ring + (i * (kRstdp ? 2 : 1) + p) * kPlaneFloats;
}

// This thread's chunks of tile u's c (and elig) into stage i.
template <bool kRstdp>
__device__ __forceinline__ void issue_c(const StdpArgs& a, const Cursor& u, float* ring, int i,
                                        int warp, int lane) {
  const Tile t(u, a);
  const int n = t.n0 + lane * 4;
  if (n >= a.N) return;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = warp * kRowsPerWarp + r;
    const int k = t.k0 + row;
    if (k >= a.K) break;
    const long long g = static_cast<long long>(k) * a.N + n;
    copy16(plane<kRstdp>(ring, i, 0) + row * kTileN + lane * 4, a.c + t.slot * a.c_slot + g);
    if (kRstdp)
      copy16(plane<kRstdp>(ring, i, 1) + row * kTileN + lane * 4,
             a.elig + t.slot * a.elig_slot + g);
  }
}

// This thread's chunks of tile u's w into registers, each only where its c
// chunk (landed in stage i) lets some synapse learn, or every chunk (kAll:
// the block's first tile, loaded at once rather than a round trip later).
template <bool kRstdp, bool kAll = false>
__device__ __forceinline__ void load_w(const StdpArgs& a, const Cursor& u, float* ring, int i,
                                       int warp, int lane, float4 (&w)[kRowsPerWarp]) {
  const Tile t(u, a);
  const int n = t.n0 + lane * 4;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    w[r] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const int row = warp * kRowsPerWarp + r;
    const int k = t.k0 + row;
    if (n >= a.N || k >= a.K) continue;
    const float4 cv = kAll ? make_float4(1.0f, 1.0f, 1.0f, 1.0f)
                           : *reinterpret_cast<const float4*>(plane<kRstdp>(ring, i, 0) +
                                                              row * kTileN + lane * 4);
    if (cv.x > 0.0f || cv.y > 0.0f || cv.z > 0.0f || cv.w > 0.0f)
      w[r] = load16(a.w + t.slot * a.w_slot + static_cast<long long>(k) * a.N + n);
  }
}

// The staged traces of one tile: up to kChunkB batch rows of x_pre' and
// s_pre for its rows and of x_post' and s_post for its columns.
struct Traces {
  float xpre[kChunkB][kTileK], spre[kChunkB][kTileK];
  __align__(16) float xpost[kChunkB][kTileN];
  __align__(16) float spost[kChunkB][kTileN];
};

// Trace item i of batch row b0 + bb (i < kTileK: a row of the tile, else a
// column): its address in the input and output traces, or -1 past the
// matrix.
__device__ __forceinline__ long long trace_index(const StdpArgs& a, const Tile& t, int b, int i,
                                                 bool* pre) {
  *pre = i < kTileK;
  if (*pre) {
    const int k = t.k0 + i;
    return k < a.K ? (static_cast<long long>(t.slot) * a.B + b) * a.K + k : -1;
  }
  const int n = t.n0 + i - kTileK;
  return n < a.N ? (static_cast<long long>(t.slot) * a.B + b) * a.N + n : -1;
}

// One trace item, decayed into shared memory (and written out by the tiles
// of column tile 0 for x_pre', of row tile 0 for x_post'). x, s: its inputs.
__device__ __forceinline__ void stage_item(const StdpArgs& a, const Tile& t, Traces& sh, int bb,
                                           int i, long long idx, bool pre, float x, float s) {
  float xs = 0.0f, ss = 0.0f;
  if (idx >= 0) {
    ss = s;
    xs = __fadd_rn(__fmul_rn(pre ? a.decay_pre : a.decay_post, x), ss);
    if (pre && t.nt == 0) a.x_pre_out[idx] = xs;
    if (!pre && t.kt == 0) a.x_post_out[idx] = xs;
  }
  if (pre) {
    sh.xpre[bb][i] = xs;
    sh.spre[bb][i] = ss;
  } else {
    sh.xpost[bb][i - kTileK] = xs;
    sh.spost[bb][i - kTileK] = ss;
  }
}

// Add staged batch rows [first, end) to this thread's 4 x 4 LTP and LTD
// sums, in batch order.
__device__ __forceinline__ void add_rows(const Traces& sh, int first, int end,
                                         float (&ltp)[kRowsPerWarp][4],
                                         float (&ltd)[kRowsPerWarp][4], int warp, int lane) {
  for (int bb = first; bb < end; ++bb) {
    const float4 xpo = *reinterpret_cast<const float4*>(&sh.xpost[bb][lane * 4]);
    const float4 spo = *reinterpret_cast<const float4*>(&sh.spost[bb][lane * 4]);
    const float xpo4[4] = {xpo.x, xpo.y, xpo.z, xpo.w};
    const float spo4[4] = {spo.x, spo.y, spo.z, spo.w};
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float xpr = sh.xpre[bb][warp * kRowsPerWarp + r];
      const float spr = sh.spre[bb][warp * kRowsPerWarp + r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ltp[r][j] = __fadd_rn(ltp[r][j], __fmul_rn(xpr, spo4[j]));
        ltd[r][j] = __fadd_rn(ltd[r][j], __fmul_rn(spr, xpo4[j]));
      }
    }
  }
}

__device__ __forceinline__ void zero_sums(float (&ltp)[kRowsPerWarp][4],
                                          float (&ltd)[kRowsPerWarp][4]) {
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) ltp[r][j] = ltd[r][j] = 0.0f;
}

// The tile's LTP and LTD sums for this thread's 4 x 4 synapses, in batch
// order, from traces staged kChunkB batch rows at a time, read when staged.
__device__ __forceinline__ void tile_sums(const StdpArgs& a, const Tile& t, Traces& sh,
                                          float (&ltp)[kRowsPerWarp][4],
                                          float (&ltd)[kRowsPerWarp][4], int warp, int lane) {
  zero_sums(ltp, ltd);
  for (int b0 = 0; b0 < a.B; b0 += kChunkB) {
    const int nb = min(kChunkB, a.B - b0);
    __syncthreads();  // the previous pass is done with the staged traces
    for (int i = threadIdx.x; i < nb * (kTileK + kTileN); i += kThreads) {
      const int bb = i / (kTileK + kTileN);
      const int item = i - bb * (kTileK + kTileN);
      bool pre;
      const long long idx = trace_index(a, t, b0 + bb, item, &pre);
      float x = 0.0f, sv = 0.0f;
      if (idx >= 0) {
        x = pre ? a.x_pre[idx] : a.x_post[idx];
        sv = pre ? a.s_pre[idx] : a.s_post[idx];
      }
      stage_item(a, t, sh, bb, item, idx, pre, x, sv);
    }
    __syncthreads();
    add_rows(sh, 0, nb, ltp, ltd, warp, lane);
  }
}

// One batch row (B == 1): each of the first kTileK + kTileN threads holds one
// trace item of a tile, fetched a tile ahead (fetch_item), staged here into
// staging row `row`, which alternates between tiles: the barrier of the tile
// between two uses of a row orders the reads of the first before the writes
// of the second, so one barrier per tile does.
__device__ __forceinline__ void fetch_item(const StdpArgs& a, const Cursor& u, float* x,
                                           float* sv) {
  *x = *sv = 0.0f;
  if (u.slot >= a.S || threadIdx.x >= kTileK + kTileN) return;
  bool pre;
  const long long idx = trace_index(a, Tile(u, a), 0, threadIdx.x, &pre);
  if (idx < 0) return;
  *x = pre ? a.x_pre[idx] : a.x_post[idx];
  *sv = pre ? a.s_pre[idx] : a.s_post[idx];
}
__device__ __forceinline__ void tile_sums_one_row(const StdpArgs& a, const Tile& t, Traces& sh,
                                                  int row, float x, float sv,
                                                  float (&ltp)[kRowsPerWarp][4],
                                                  float (&ltd)[kRowsPerWarp][4], int warp,
                                                  int lane) {
  zero_sums(ltp, ltd);
  if (threadIdx.x < kTileK + kTileN) {
    bool pre;
    const long long idx = trace_index(a, t, 0, threadIdx.x, &pre);
    stage_item(a, t, sh, row, threadIdx.x, idx, pre, x, sv);
  }
  __syncthreads();
  add_rows(sh, row, row + 1, ltp, ltd, warp, lane);
}

// One synapse's update: dw, the eligibility (rstdp) and the new weight.
struct Synapse {
  float w, e;
};
__device__ __forceinline__ Synapse update(const StdpArgs& a, float gain, float ltp, float ltd,
                                          float c, float w, float e) {
  const float dw = __fmul_rn(__fsub_rn(__fmul_rn(a.a_plus, ltp), __fmul_rn(a.a_minus, ltd)), c);
  float upd = dw;
  float e_new = e;
  if (a.rstdp) {
    e_new = __fadd_rn(__fmul_rn(a.decay_elig, e), dw);
    upd = __fmul_rn(gain, e_new);
  }
  return {c > 0.0f ? clip(__fadd_rn(w, upd), a.w_min, a.w_max) : w, e_new};
}

// A thread's running |dw| and dw^2 sums over the synapses it committed in the
// current slot (kStats).
struct DwSums {
  float l1 = 0.0f, sq = 0.0f;
  __device__ __forceinline__ void add(float w_new, float w_old) {
    const float d = __fsub_rn(w_new, w_old);
    l1 = __fadd_rn(l1, fabsf(d));
    sq = __fadd_rn(sq, __fmul_rn(d, d));
  }
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// The block leaves `slot` (every thread calls this together): write the
// block's partial of `slot` and zeros for the slots in [*written, slot) it
// never visited, then start the next slot's sums from zero. slot == S writes
// the zeros of the rest.
__device__ void flush_stats(const StdpArgs& a, DwSums& sums, int slot, int* written) {
  __shared__ float red[2][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float l1 = warp_sum(sums.l1), sq = warp_sum(sums.sq);
  if (lane == 0) {
    red[0][warp] = l1;
    red[1][warp] = sq;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float2* out = reinterpret_cast<float2*>(a.stats);
    for (int s = *written; s < slot; ++s)
      out[static_cast<long long>(s) * gridDim.x + blockIdx.x] = make_float2(0.0f, 0.0f);
    if (slot < a.S) {
      float t1 = red[0][0], t2 = red[1][0];
      for (int w = 1; w < kWarps; ++w) {
        t1 = __fadd_rn(t1, red[0][w]);
        t2 = __fadd_rn(t2, red[1][w]);
      }
      out[static_cast<long long>(slot) * gridDim.x + blockIdx.x] = make_float2(t1, t2);
    }
  }
  *written = slot + 1;
  sums = DwSums();
  __syncthreads();  // red is free for the next slot's flush
}

__device__ __forceinline__ float slot_gain(const StdpArgs& a, int slot) {
  return a.rstdp ? __fmul_rn(a.lr_reward, a.reward[slot * a.reward_slot]) : 0.0f;
}

// Closed slots: their traces keep their values, copied through by every
// block's share of threads; w and elig are not touched.
__device__ void copy_closed(const StdpArgs& a) {
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  for (int slot = 0; slot < a.S; ++slot) {
    if (gate_open(a, slot)) continue;
    const long long pre0 = static_cast<long long>(slot) * a.B * a.K;
    const long long post0 = static_cast<long long>(slot) * a.B * a.N;
    for (long long i = first; i < static_cast<long long>(a.B) * a.K; i += step)
      a.x_pre_out[pre0 + i] = a.x_pre[pre0 + i];
    for (long long i = first; i < static_cast<long long>(a.B) * a.N; i += step)
      a.x_post_out[post0 + i] = a.x_post[post0 + i];
  }
}

// The cp.async fill: c (and elig) kStages - 1 tiles ahead in the ring, w one
// tile ahead in registers.
template <bool kRstdp, bool kStats>
__global__ void __launch_bounds__(kThreads, 2) stdp_update_kernel(StdpArgs a) {
  extern __shared__ __align__(16) float ring[];
  __shared__ Traces sh;
  constexpr int kAhead = kStages - 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  copy_closed(a);

  Cursor cur{0, static_cast<int>(blockIdx.x)};
  settle(cur, a);
  Cursor cc = cur, cw = cur;
  // Prologue: c of the first kAhead tiles, and w of the first whole.
  for (int i = 0; i < kAhead; ++i) {
    if (cc.slot < a.S) {
      issue_c<kRstdp>(a, cc, ring, i, warp, lane);
      advance(cc, a);
    }
    commit();
  }
  float4 w_cur[kRowsPerWarp], w_next[kRowsPerWarp];
  if (cw.slot < a.S) {
    load_w<kRstdp, true>(a, cw, ring, 0, warp, lane, w_cur);
    advance(cw, a);
  }
  // B == 1: this thread's trace item of the current tile, fetched a tile
  // ahead so that its load is not in the way.
  float tx, ts;
  fetch_item(a, cur, &tx, &ts);

  float ltp[kRowsPerWarp][4], ltd[kRowsPerWarp][4];
  DwSums sums;
  int written = 0;
  for (int i = 0; cur.slot < a.S; ++i) {
    // Pending, oldest first: c of tiles i + 1 .. i + kAhead - 1; now i + kAhead.
    if (cc.slot < a.S) {
      issue_c<kRstdp>(a, cc, ring, (i + kAhead) % kStages, warp, lane);
      advance(cc, a);
    }
    commit();
    wait_all_but<kAhead - 1>();  // c of tile i + 1 has landed
    const Cursor next = cw;      // tile i + 1
    if (cw.slot < a.S) {
      load_w<kRstdp>(a, cw, ring, (i + 1) % kStages, warp, lane, w_next);
      advance(cw, a);
    }

    const Tile t(cur, a);
    if (a.B == 1) {
      tile_sums_one_row(a, t, sh, i & 1, tx, ts, ltp, ltd, warp, lane);
      fetch_item(a, next, &tx, &ts);
    } else {
      tile_sums(a, t, sh, ltp, ltd, warp, lane);
    }
    const int n = t.n0 + lane * 4;
    if (n < a.N) {
      const float gain = slot_gain(a, t.slot);
      const int st = i % kStages;
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int row = warp * kRowsPerWarp + r;
        const int k = t.k0 + row;
        if (k >= a.K) break;
        const int off = row * kTileN + lane * 4;
        const float4 c4 = *reinterpret_cast<const float4*>(plane<kRstdp>(ring, st, 0) + off);
        float4 e4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (kRstdp) e4 = *reinterpret_cast<const float4*>(plane<kRstdp>(ring, st, 1) + off);
        const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
        const float wv[4] = {w_cur[r].x, w_cur[r].y, w_cur[r].z, w_cur[r].w};
        const float ev[4] = {e4.x, e4.y, e4.z, e4.w};
        float wn[4], en[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const Synapse syn = update(a, gain, ltp[r][j], ltd[r][j], cv[j], wv[j], ev[j]);
          wn[j] = syn.w;
          en[j] = syn.e;
          if (kStats) sums.add(syn.w, wv[j]);
        }
        const long long g = static_cast<long long>(k) * a.N + n;
        if (kRstdp)
          *reinterpret_cast<float4*>(a.elig + t.slot * a.elig_slot + g) =
              make_float4(en[0], en[1], en[2], en[3]);
        if (cv[0] > 0.0f || cv[1] > 0.0f || cv[2] > 0.0f || cv[3] > 0.0f)
          *reinterpret_cast<float4*>(a.w + t.slot * a.w_slot + g) =
              make_float4(wn[0], wn[1], wn[2], wn[3]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) w_cur[r] = w_next[r];
    advance(cur, a);
    if (kStats && cur.slot != t.slot) flush_stats(a, sums, t.slot, &written);
  }
  if (kStats) flush_stats(a, sums, a.S, &written);
  asm volatile("cp.async.wait_all;" ::: "memory");
}

template <bool kRstdp, bool kStats>
cudaError_t launch_ring(const StdpArgs& a, int blocks, int smem, cudaStream_t stream) {
  static int opted = 0;  // per instantiation
  auto kernel = stdp_update_kernel<kRstdp, kStats>;
  if (smem < kStages * (kRstdp ? 2 : 1) * kPlaneFloats * 4) return cudaErrorInvalidValue;
  if (smem > opted) {  // the static traces count against the default 48 KiB too
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted = smem;
  }
  kernel<<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The element fill: any N and alignment, loads straight from device memory.
template <bool kStats>
__global__ void __launch_bounds__(kThreads, 2) stdp_update_element_kernel(StdpArgs a) {
  __shared__ Traces sh;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  copy_closed(a);
  float ltp[kRowsPerWarp][4], ltd[kRowsPerWarp][4];
  DwSums sums;
  int written = 0;
  Cursor cur{0, static_cast<int>(blockIdx.x)};
  for (settle(cur, a); cur.slot < a.S;) {
    const Tile t(cur, a);
    tile_sums(a, t, sh, ltp, ltd, warp, lane);
    const float gain = slot_gain(a, t.slot);
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int k = t.k0 + warp * kRowsPerWarp + r;
      if (k >= a.K) break;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = t.n0 + lane * 4 + j;
        if (n >= a.N) break;
        const long long g = static_cast<long long>(k) * a.N + n;
        const float cv = __ldg(a.c + t.slot * a.c_slot + g);
        float* w = a.w + t.slot * a.w_slot + g;
        float* e = a.elig + t.slot * a.elig_slot + g;
        const float w_old = cv > 0.0f ? *w : 0.0f;
        const Synapse syn = update(a, gain, ltp[r][j], ltd[r][j], cv, w_old,
                                   a.rstdp ? *e : 0.0f);
        if (a.rstdp) *e = syn.e;
        if (cv > 0.0f) *w = syn.w;
        if (kStats) sums.add(syn.w, w_old);
      }
    }
    advance(cur, a);
    if (kStats && cur.slot != t.slot) flush_stats(a, sums, t.slot, &written);
  }
  if (kStats) flush_stats(a, sums, a.S, &written);
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// The last three ints are the plan (kernels/_stream.py StdpPlan.args): blocks,
// stages and the ring's dynamic shared memory; the fill follows from the
// operands' alignment. stats, when not null, receives the (S, blocks, 2) dw
// partials (the kStats instantiations); null launches the plain ones. Returns the cudaError_t of the launch (0 on success),
// cudaErrorInvalidValue for a shape or plan it cannot take. Never
// synchronises and allocates nothing: the caller owns every buffer.
extern "C" int repro_stdp_update(
    const void* s_pre, const void* x_pre, const void* s_post, const void* x_post, void* w,
    long long w_slot, const void* c, long long c_slot, void* elig, long long elig_slot,
    const void* reward, long long reward_slot, const void* tick, const void* learn_until,
    long long until_slot, void* x_pre_out, void* x_post_out, void* stats, int S, int B,
    int K, int N,
    int rstdp, float a_plus, float a_minus, float decay_pre, float decay_post,
    float decay_elig, float lr_reward, float w_min, float w_max, int blocks, int stages,
    int smem, void* stream) {
  if (S < 1 || B < 1 || K < 1 || N < 1 || blocks < 1 || smem < 0 || smem > kMaxSmem ||
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
  a.stats = static_cast<float*>(stats);
  a.S = S;
  a.B = B;
  a.K = K;
  a.N = N;
  a.rstdp = rstdp;
  a.tiles_n = (N + kTileN - 1) / kTileN;
  const long long tiles = static_cast<long long>((K + kTileK - 1) / kTileK) * a.tiles_n;
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  a.tiles = static_cast<int>(tiles);
  a.a_plus = a_plus;
  a.a_minus = a_minus;
  a.decay_pre = decay_pre;
  a.decay_post = decay_post;
  a.decay_elig = decay_elig;
  a.lr_reward = lr_reward;
  a.w_min = w_min;
  a.w_max = w_max;
  // The fill (kernels/_stream.py b5_fill): cp.async when every 4-column chunk
  // starts on a 16-byte boundary.
  const bool async = N % 4 == 0 && aligned16(w) && aligned16(c) && w_slot % 4 == 0 &&
                     c_slot % 4 == 0 &&
                     (rstdp == 0 || (aligned16(elig) && elig_slot % 4 == 0));
  const auto st = static_cast<cudaStream_t>(stream);
  if (!async) {
    if (stats != nullptr)
      stdp_update_element_kernel<true><<<blocks, kThreads, 0, st>>>(a);
    else
      stdp_update_element_kernel<false><<<blocks, kThreads, 0, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  if (stages != kStages) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (stats != nullptr)
    err = rstdp ? launch_ring<true, true>(a, blocks, smem, st)
                : launch_ring<false, true>(a, blocks, smem, st);
  else
    err = rstdp ? launch_ring<true, false>(a, blocks, smem, st)
                : launch_ring<false, false>(a, blocks, smem, st);
  return static_cast<int>(err);
}
