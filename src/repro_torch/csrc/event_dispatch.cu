// Kernels B3 and B4: event-driven dispatch (spike-list gather + LIF step),
// written by hand for Hopper (sm_90a). Entry point: repro_event_dispatch
// (plain C, loaded with ctypes by repro_torch/kernels/event_dispatch.py).
//
// Replaces repro/kernels/event_dispatch.py:
//   B3 _event_db_kernel (entry event_lif_dispatch_db): per batch row, walk
//      only the counts[b] live slots of the spike list; the sentinel tail is
//      never read.
//   B4 _event_kernel (entry event_lif_dispatch): walk all k slots; a
//      sentinel slot points at the all-zero row K of w.
// Both: acc = sum over the walked slots j, in ascending order, of row
// idx[b, j] of W*C, one __fadd_rn per slot; then the shared LIF epilogue
// (lif_epilogue.cuh). A row id outside w adds nothing.
//
// What bounds them on this card: the gathered weight bytes. Each distinct
// row of W*C that some batch row lists must be read once, N * 4 bytes, with
// one add per byte read for every batch row that lists it; at snn-event FULL
// (K = N = 4096, 16 rows, about 5 % of neurons spiking) that is about 2,300
// distinct rows, 36 MiB, against the 64 MiB the dense product streams for
// every tick whatever the activity.
//
// B3 (event_dispatch_db_kernel), the first design: a block owns one batch
// row of one slot and 128 output columns, one column per thread, grid
// (ceil(N/128), B, S). It stages a chunk of its row's ids in shared memory,
// then each thread loads the 128-wide, coalesced slice of sixteen listed rows
// before it adds them in slot order. A row that several batch rows list is
// read once per batch row.
//
// B4 (event_dispatch_kernel), redesigned so that one read of each distinct
// row serves every batch row of a group (plan: kernels/_event_plan.py):
// - A block owns one slot, a group of up to 16 batch rows (one warp each)
//   and a column tile of 32 columns (one per lane): at snn-event FULL 128
//   blocks of 16 warps, each streaming 128-byte segments. Grid
//   (ceil(N / 32), ceil(B / rows), S).
// - The epilogue's operands (v, r, drive and the six per-neuron rows of the
//   block's columns) are copied into shared memory at the start, behind the
//   first pass's ids, so the LIF step at the end waits on nothing.
// - Per pass of up to `chunk` list slots, each warp copies its row's ids
//   into shared memory (all in flight at once), then reads fifteen a lane in
//   a row: whether they ascend, and each run of one id (compacted in place:
//   its id and first slot). The ids of the first window of row ids are
//   marked in a bitmap as they come; a block scan of the words' popcounts
//   gives the ascending union of the group's ids and each id's rank in it.
//   The sentinel row K, the largest id, is last.
// - The union's rows stream through a double buffer of two stages of
//   `stage_rows` rows (448, 56 KiB, from the planner) by every thread's
//   cp.async copies (16 bytes, or 4 where a row segment is not 16-byte
//   aligned): one stage lands while the other is added. Each stage costs a
//   barrier and a refill, so the planner makes them as large as the shared
//   memory allows. Hopper's TMA has no row gather, and the rows are short.
// - While the first stage lands, each warp ranks its runs, marks those of
//   more than one slot and finds where its runs in each stage end. Then it
//   adds each stage's runs in slot order, one __fadd_rn per slot: the twin's
//   order, so the result is bitwise the twin's on any weights. Runs of one
//   slot are read 8 at a time before they are added (about five
//   instructions a run); a run of more slots (the sentinel tail, a
//   repeated id) adds its value once, then once per further slot where it is
//   not zero: a sum that starts at +0 is never -0, and adding +0 or -0 to it
//   leaves every bit as it was, so the k - counts[b] sentinel slots cost
//   one add and one test.
// - A row whose ids do not ascend in a pass (ops.spike_list never makes one,
//   but the wrapper is public) adds that pass's slots one by one from
//   device memory, in slot order, in the same launch.
// - The ragged edges (N % 32, B % rows, ids outside w, more ids than one
//   window or more slots than one pass) are bounds-checked or walked in
//   turn: no padding copies.
// What is left on the card: at snn-event FULL the stream runs near the
// memory rate; the lists, the union and the epilogue, which no stream
// overlaps, take most of the rest.
//
// Both kernels: a device gate (skip, one flag per slot or one for all) lets
// the caller launch this kernel and the dense kernel B1 every tick and
// decide on the device, per network, which one writes: when a slot's flag is
// set every block of that slot returns before reading anything. This
// replaces the reference's lax.cond on the overflow / adaptive-knee predicate
// (taken per network under its vmap) with no host round trip.
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lif_epilogue.cuh"

namespace {

using repro_torch::LifRows;

constexpr int kBlockN = 128;  // B3: output columns per block, one per thread
constexpr int kChunk = 512;   // B3: spike ids staged in shared memory per pass
constexpr int kUnroll = 16;   // B3: weight rows loaded before they are added

constexpr int kWarp = 32;
constexpr int kMaxRows = 16;      // B4: batch rows per block, one warp each
constexpr int kStages = 2;        // B4: the ring, a double buffer
constexpr int kScanInts = kWarp + 1;  // B4: the block scan's warp sums and the union's size
constexpr int kAhead = 8;         // B4: staged values a lane reads before it adds them
constexpr int kSeg = 15;          // B4: list slots a lane reads in a row (odd: no bank conflict)
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may opt into

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

// B4's launch plan (kernels/_event_plan.py EventPlan.args).
struct GatherPlan {
  int rows;        // batch rows per block, one warp each
  int chunk;       // list slots per pass
  int window;      // row ids per bitmap window, a multiple of 32
  int stage_rows;  // union rows per stage
  int vec;         // 1: 16-byte copies fill the ring, 0: 4-byte ones
  int smem;        // dynamic shared memory per block, bytes
};

// The shared memory the plan's layout takes (_event_plan.smem_bytes).
long long gather_smem(const GatherPlan& p) {
  const long long ring = 4LL * kStages * p.stage_rows * kWarp;
  const long long lists = static_cast<long long>(p.rows) * p.chunk;
  const long long uni = lists < p.window ? lists : p.window;
  const long long uni_words = (uni + kWarp - 1) / kWarp;
  const long long multi_words = (p.chunk + kWarp) / kWarp;
  return ring + 4 * (3 * lists + p.rows * (2 + multi_words + uni_words) +
                     2 * (p.window / kWarp) + uni + kScanInts +
                     (6 + 3LL * p.rows) * kWarp);
}

// Per-neuron row `which` of LifRows (v_th, leak, r_ref, gain, i_bias, v_reset),
// as 4-byte words.
__device__ __forceinline__ const float* neuron_row(const EventArgs& a, int which) {
  switch (which) {
    case 0: return a.rows.v_th;
    case 1: return a.rows.leak;
    case 2: return reinterpret_cast<const float*>(a.rows.r_ref);
    case 3: return a.rows.gain;
    case 4: return a.rows.i_bias;
    default: return a.rows.v_reset;
  }
}

// B4's epilogue operands, staged in shared memory at the start: the block's
// columns of the six per-neuron rows, and of v, r and drive per batch row.
struct Staged {
  float* rows[6];  // v_th, leak, r_ref (int bits), gain, i_bias, v_reset: [tile_n]
  float* v;        // [rows][tile_n]
  int* r;          // [rows][tile_n]
  float* drive;    // [rows][tile_n]
};

__global__ void __launch_bounds__(kBlockN) event_dispatch_db_kernel(EventArgs a) {
  // The dense arm writes this slot's tick.
  if (a.skip != nullptr && a.skip[blockIdx.z * a.skip_slot]) return;
  __shared__ int sh_idx[kChunk];
  const int n = blockIdx.x * kBlockN + threadIdx.x;
  const int b = blockIdx.y;
  const long long slot = blockIdx.z;
  const long long row = slot * a.B + b;
  const bool live = n < a.N;
  const int* ids = a.idx + row * a.k;
  const int m = min(max(a.counts[row], 0), a.k);
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

// --- B4 ---------------------------------------------------------------------

// Global to shared, asynchronously: 16 bytes (L2 only), or 4.
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
// All but this thread's `kPending` newest copy groups have landed.
template <int kPending>
__device__ __forceinline__ void wait_all_but() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// The slots after the first of a run of one id: its staged value added
// `more` times more, skipped where the value is zero (the sentinel tail).
__device__ __forceinline__ float add_more(float acc, float v, int more) {
  if (v == 0.0f) return acc;
#pragma unroll 1
  for (int i = 0; i < more; ++i) acc = __fadd_rn(acc, v);
  return acc;
}

// The first set bit at or after `from` (below `end`), or `end`.
__device__ __forceinline__ int next_set(const unsigned* bits, int from, int end) {
  for (int i = from; i < end; i = (i & ~(kWarp - 1)) + kWarp) {
    const unsigned word = bits[i >> 5] & (~0u << (i & (kWarp - 1)));
    if (word) return min(end, (i & ~(kWarp - 1)) + __ffs(word) - 1);
  }
  return end;
}

// One block an SM (the plan's shared memory takes the SM), so up to 128
// registers a thread.
template <bool kVec>
__global__ void __launch_bounds__(kWarp * kMaxRows, 1)
    event_dispatch_kernel(EventArgs a, GatherPlan p) {
  if (a.skip != nullptr && a.skip[blockIdx.z * a.skip_slot]) return;
  constexpr int kTileN = kWarp, kRowBytes = kTileN * 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = p.rows, kc = p.chunk, R = p.stage_rows, T = blockDim.x;
  const int uni_cap = min(p.window, G * kc), uni_words = (uni_cap + kWarp - 1) / kWarp;
  const int multi_words = (kc + kWarp) / kWarp;
  float* ring = reinterpret_cast<float*>(smem);
  int* sh_ids = reinterpret_cast<int*>(ring + kStages * R * kTileN);         // [G][kc]
  int* sh_starts = sh_ids + G * kc;                                           // [G][kc + 1]
  int* sh_runs = sh_starts + G * (kc + 1);                                    // [G][kc]
  unsigned* sh_multi = reinterpret_cast<unsigned*>(sh_runs + G * kc);        // [G][multi_words]
  int* sh_qend = reinterpret_cast<int*>(sh_multi + G * multi_words);         // [G][uni_words + 1]
  unsigned* sh_bits = reinterpret_cast<unsigned*>(sh_qend + G * (uni_words + 1));  // [window/32]
  int* sh_base = reinterpret_cast<int*>(sh_bits + p.window / kWarp);         // [window / 32]
  int* sh_union = sh_base + p.window / kWarp;                                 // [uni_cap]
  int* sh_scan = sh_union + uni_cap;                                          // [32 + 1]
  float* sh_epi = reinterpret_cast<float*>(sh_scan + kScanInts);  // [(6 + 3 G) * kTileN]

  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x / kWarp;
  const int b = blockIdx.y * G + warp;
  const bool row_ok = b < a.B;
  const long long slot = blockIdx.z;
  const long long row = slot * a.B + b;
  const int n0 = blockIdx.x * kTileN;  // the block's first column
  const int col = n0 + lane;           // this lane's column
  const float* w = a.w + slot * a.w_slot;
  const int window0 = min(a.Kw, p.window);  // the end of the first window of ids
  // This warp's slots of the pass: ids; where each run of one id starts; per
  // run its union rank; which runs take more than one slot; per stage, where
  // its runs in that stage end.
  int* ids = sh_ids + warp * kc;
  int* starts = sh_starts + warp * (kc + 1);
  int* runs = sh_runs + warp * kc;
  unsigned* multi = sh_multi + warp * multi_words;
  int* qend = sh_qend + warp * (uni_words + 1);
  const unsigned char* ring_lane = reinterpret_cast<const unsigned char*>(ring + lane);

  float acc = 0.0f;

  // The first pass's ids, then the epilogue's operands (read at the end):
  // two copy groups, the ids waited for first.
  if (row_ok) {
    const int* first_ids = a.idx + row * a.k;
    for (int j = lane; j < min(kc, a.k); j += kWarp) copy4(ids + j, first_ids + j);
  }
  commit();
  Staged st;
#pragma unroll
  for (int i = 0; i < 6; ++i) st.rows[i] = sh_epi + i * kTileN;
  st.v = sh_epi + 6 * kTileN;
  st.r = reinterpret_cast<int*>(st.v + G * kTileN);
  st.drive = reinterpret_cast<float*>(st.r + G * kTileN);
  for (int i = threadIdx.x; i < 6 * kTileN; i += T) {
    const int which = i / kTileN, c = i % kTileN;
    if (n0 + c < a.N)
      copy4(st.rows[0] + i, neuron_row(a, which) + slot * a.row_slot + n0 + c);
  }
  if (row_ok && col < a.N) {
    const long long at = row * a.N + col;
    copy4(st.v + warp * kTileN + lane, a.v + at);
    copy4(st.r + warp * kTileN + lane, a.r + at);
    if (a.drive) copy4(st.drive + warp * kTileN + lane, a.drive + at);
  }
  commit();

  for (int j0 = 0; j0 < a.k; j0 += kc) {
    const int m = min(kc, a.k - j0);
    // A later pass's ids, all copies in flight at once, while the first
    // window's bitmap is cleared.
    const int* src = a.idx + row * a.k + j0;
    if (row_ok && j0 > 0)
      for (int j = lane; j < m; j += kWarp) copy4(ids + j, src + j);
    commit();
    for (int i = threadIdx.x; i < (window0 + kWarp - 1) / kWarp; i += T) sh_bits[i] = 0u;
    __syncthreads();  // the previous pass is done with the lists; the bitmap is clear
    // kSeg ids a lane, in a row: whether they ascend, and each run's id
    // (compacted in place) and first slot, marking the first window's ids in
    // the bitmap.
    int nr = 0;
    bool sorted = true;
    if (row_ok) {
      if (j0 == 0)
        wait_all_but<2>();  // the first pass: not the epilogue's operands
      else
        wait_all_but<0>();
      __syncwarp();
      int prev = 0;
      for (int t = 0; t < m; t += kSeg * kWarp) {
        const int j0l = t + lane * kSeg;  // this lane's first slot
        int id[kSeg];
#pragma unroll
        for (int e = 0; e < kSeg; ++e) id[e] = j0l + e < m ? ids[j0l + e] : 0;
        int before = __shfl_up_sync(~0u, id[kSeg - 1], 1);
        if (lane == 0) before = prev;
        unsigned first = 0;
        bool down = false;
        int runs_here = 0;
#pragma unroll
        for (int e = 0; e < kSeg; ++e) {
          const int j = j0l + e;
          const bool in = j < m, f = in && (j == 0 || id[e] != before);
          down = down || (in && j > 0 && id[e] < before);
          first |= static_cast<unsigned>(f) << e;
          runs_here += f;
          before = id[e];
        }
        sorted = sorted && !__any_sync(~0u, down);
        int incl = runs_here;
#pragma unroll
        for (int d = 1; d < kWarp; d <<= 1) {
          const int got = __shfl_up_sync(~0u, incl, d);
          if (lane >= d) incl += got;
        }
        __syncwarp();  // every lane has read its ids: the runs are written in place
        int at = nr + incl - runs_here;
#pragma unroll
        for (int e = 0; e < kSeg; ++e) {
          if (!(first >> e & 1u)) continue;
          ids[at] = id[e];
          starts[at++] = j0l + e;
          if (static_cast<unsigned>(id[e]) < static_cast<unsigned>(window0))
            atomicOr(&sh_bits[id[e] >> 5], 1u << (id[e] & 31));
        }
        nr += __shfl_sync(~0u, incl, kWarp - 1);
        prev = __shfl_sync(~0u, id[kSeg - 1], kWarp - 1);
      }
      if (lane == 0) starts[nr] = m;
    }
    if (!row_ok || !sorted) nr = 0;  // nothing of this warp is added from the ring
    __syncwarp();
    int q = 0;  // this warp's next run: past those of ids below w
    while (q < nr && ids[q] < 0) ++q;

    for (int lo = 0; lo < a.Kw; lo += p.window) {
      const int hi = min(a.Kw, lo + p.window);
      const int words = (hi - lo + kWarp - 1) / kWarp;
      if (lo > 0) {  // mark this window's ids; the runs before q lie below it
        for (int i = threadIdx.x; i < words; i += T) sh_bits[i] = 0u;
        __syncthreads();
        for (int r = q + lane; r < nr; r += kWarp) {
          const int id = ids[r];
          if (id >= hi) break;
          atomicOr(&sh_bits[(id - lo) >> 5], 1u << ((id - lo) & 31));
        }
      }
      __syncthreads();
      // The union: each thread's run of words, offset by a block scan of
      // the words' popcounts, then the ids of its set bits in order.
      const int per = (words + T - 1) / T;
      const int w0 = min(words, static_cast<int>(threadIdx.x) * per), w1 = min(words, w0 + per);
      int mine = 0;
      for (int i = w0; i < w1; ++i) mine += __popc(sh_bits[i]);
      int incl = mine;
#pragma unroll
      for (int d = 1; d < kWarp; d <<= 1) {
        const int got = __shfl_up_sync(~0u, incl, d);
        if (lane >= d) incl += got;
      }
      if (lane == kWarp - 1) sh_scan[warp] = incl;
      __syncthreads();
      if (warp == 0) {
        int tot = lane < G ? sh_scan[lane] : 0;
#pragma unroll
        for (int d = 1; d < kWarp; d <<= 1) {
          const int got = __shfl_up_sync(~0u, tot, d);
          if (lane >= d) tot += got;
        }
        sh_scan[lane] = tot;  // inclusive, over the warps
      }
      __syncthreads();
      int at = (warp > 0 ? sh_scan[warp - 1] : 0) + incl - mine;
      const int U = sh_scan[G - 1];
      for (int i = w0; i < w1; ++i) {
        unsigned bits = sh_bits[i];
        sh_base[i] = at;
        while (bits) {
          sh_union[at++] = lo + i * kWarp + __ffs(bits) - 1;
          bits &= bits - 1u;
        }
      }
      __syncthreads();

      // Stage s holds union rows [s R, s R + R) of this block's columns, in
      // ring slot s % 2. Pass s fills stage s + 1, then (from s = 0) adds
      // stage s.
      const int n_stages = (U + R - 1) / R;
      int next_multi = nr;
      for (int s = -1; s < n_stages; ++s) {
        if (s >= 0) {
          wait_all_but<0>();
          __syncthreads();  // stage s landed for every thread; stage s - 1 is free
        }
        const int t = s + 1;
        if (t < n_stages) {
          const int r0 = t * R, n_rows = min(R, U - r0);
          float* dst = ring + (t & 1) * R * kTileN;
          if (kVec) {
            constexpr int kParts = kTileN / 4;  // 16-byte parts of a row segment
            for (int i = threadIdx.x; i < n_rows * kParts; i += T) {
              const int r = i / kParts, part = i % kParts, n = n0 + part * 4;
              if (n < a.N)
                copy16(dst + r * kTileN + part * 4,
                       w + static_cast<long long>(sh_union[r0 + r]) * a.N + n);
            }
          } else {
            for (int i = threadIdx.x; i < n_rows * kTileN; i += T) {
              const int r = i / kTileN, c = i % kTileN, n = n0 + c;
              if (n < a.N)
                copy4(dst + r * kTileN + c,
                      w + static_cast<long long>(sh_union[r0 + r]) * a.N + n);
            }
          }
        }
        commit();
        if (s == -1) {  // the first stage is in flight: meanwhile,
          // This warp's runs in the window: their ranks (INT_MAX past it),
          // which take more than one slot, and the end of its runs in each stage.
          for (int i = lane; i < multi_words; i += kWarp) multi[i] = 0u;
          __syncwarp();
          for (int r = q + lane; r < nr; r += kWarp) {
            const int id = ids[r];
            int rank = INT_MAX;
            if (id < hi) {
              const int o = id - lo;
              rank = sh_base[o >> 5] + __popc(sh_bits[o >> 5] & ((1u << (o & 31)) - 1u));
              if (starts[r + 1] - starts[r] > 1) atomicOr(&multi[r >> 5], 1u << (r & (kWarp - 1)));
            }
            runs[r] = rank;
          }
          __syncwarp();
          for (int st = lane; st < n_stages; st += kWarp) {
            const int end = min(U, (st + 1) * R);
            int lo_r = q, hi_r = nr;  // the first run at or past rank `end`
            while (lo_r < hi_r) {
              const int mid = (lo_r + hi_r) >> 1;
              if (runs[mid] < end) lo_r = mid + 1; else hi_r = mid;
            }
            qend[st] = lo_r;
          }
          __syncwarp();
          next_multi = next_set(multi, q, nr);
        }
        if (s < 0) continue;
        // This warp's runs in the stage, in slot order: the runs of one
        // slot kAhead at a time (their staged values read before any is
        // added), each run of more slots on its own.
        // The row of rank r lies at stage + r * kRowBytes.
        const unsigned char* stage = ring_lane + ((s & 1) - s) * R * kRowBytes;
        const auto staged = [&](int run) {
          return *reinterpret_cast<const float*>(stage + runs[run] * kRowBytes);
        };
        const int q_end = qend[s];
        while (q < q_end) {
          const int stop = min(q_end, next_multi);
          for (; q + kAhead <= stop; q += kAhead) {
            float v[kAhead];
#pragma unroll
            for (int u = 0; u < kAhead; ++u) v[u] = staged(q + u);
#pragma unroll
            for (int u = 0; u < kAhead; ++u) acc = __fadd_rn(acc, v[u]);
          }
          for (; q < stop; ++q) acc = __fadd_rn(acc, staged(q));
          if (q < q_end) {  // q == next_multi
            const float v = staged(q);
            acc = add_more(__fadd_rn(acc, v), v, starts[q + 1] - starts[q] - 1);
            next_multi = next_set(multi, ++q, nr);
          }
        }
      }
      asm volatile("cp.async.wait_all;" ::: "memory");
      __syncthreads();  // the window's bitmap, union and ring are free
    }

    // A row whose ids do not ascend: this pass's slots one by one, in order.
    if (row_ok && !sorted && col < a.N) {
      for (int j = 0; j < m; ++j) {
        const int id = __ldg(src + j);
        if (static_cast<unsigned>(id) < static_cast<unsigned>(a.Kw))
          acc = __fadd_rn(acc, __ldg(w + static_cast<long long>(id) * a.N + col));
      }
    }
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();  // the staged epilogue operands
  if (!row_ok || col >= a.N) return;
  const LifRows lif{st.rows[0], st.rows[1], reinterpret_cast<const int*>(st.rows[2]),
                    st.rows[3], st.rows[4], st.rows[5]};
  const long long at = row * a.N + col;
  const int e = warp * kTileN + lane;
  const float syn = a.drive ? __fadd_rn(acc, st.drive[e]) : acc;
  float v_new, y;
  int r_new;
  repro_torch::lif_epilogue(a.mode, syn, st.v[e], st.r[e], lif, lane, &v_new, &r_new, &y);
  a.v_out[at] = v_new;
  a.r_out[at] = r_new;
  a.y_out[at] = y;
}

template <bool kVec>
cudaError_t launch_gather(const EventArgs& a, const GatherPlan& p, int S, cudaStream_t st) {
  static int opted = 0;  // per instantiation
  auto kernel = event_dispatch_kernel<kVec>;
  if (p.smem > opted) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return err;
    opted = p.smem;
  }
  const dim3 grid((a.N + kWarp - 1) / kWarp, (a.B + p.rows - 1) / p.rows, S);
  kernel<<<grid, p.rows * kWarp, p.smem, st>>>(a, p);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Never synchronises and
// allocates nothing: the caller owns every buffer. counts == null walks all k
// slots (kernel B4, on the launch plan rows .. smem, which is checked here);
// otherwise only the live prefix of each row (kernel B3, which takes no plan).
extern "C" int repro_event_dispatch(
    const void* idx, const void* counts, int k, const void* w, long long w_slot, int Kw,
    const void* v, const void* r, const void* drive, const void* v_th, const void* leak,
    const void* r_ref, const void* gain, const void* i_bias, const void* v_reset,
    long long row_slot, void* v_out, void* r_out, void* y_out, const void* skip,
    long long skip_slot, int S, int B, int N, int mode, int rows, int chunk, int window,
    int stage_rows, int vec, int smem, void* stream) {
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
  const auto st = static_cast<cudaStream_t>(stream);
  if (a.counts != nullptr) {
    const dim3 grid((N + kBlockN - 1) / kBlockN, B, S);
    event_dispatch_db_kernel<<<grid, kBlockN, 0, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  const GatherPlan p{rows, chunk, window, stage_rows, vec, smem};
  // The fill (kernels/_event_plan.py b4_fill): 16-byte copies exactly when
  // every row segment starts on a 16-byte boundary.
  const bool aligned =
      N % 4 == 0 && w_slot % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (rows < 1 || rows > kMaxRows || chunk < 1 || window < kWarp || window % kWarp != 0 ||
      stage_rows < kWarp || vec != (aligned ? 1 : 0) || smem != gather_smem(p) ||
      smem > kMaxSmem || (B + rows - 1) / rows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(vec ? launch_gather<true>(a, p, S, st)
                              : launch_gather<false>(a, p, S, st));
}
