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
// it serves (the classifier's 45 and 80 rows, the fabric's 8). At one network
// of 8 rows N = 4096 gives only 32 column tiles of 128 for 132 SMs, so the
// design is about spreading the stream evenly:
//
// - A persistent stream-K split (kernels/_stream.py spike_matmul_plan). The
//   product is cut into units (row group of kRows rows, column tile of
//   kBlockN columns, K tile of kt rows; K tile fastest), and each of one block
//   per SM takes an equal contiguous run of units, so every SM streams the
//   same bytes and no wave tail leaves SMs idle.
// - A block sums each tile's run of K tiles in registers (8 warps split each
//   stage's rows; each lane owns 4 columns), adds its warps in warp order at
//   the end of the run, in the stage it has just read (a stage is at least
//   the 32 KiB of the warps' partial tiles), and writes a tile it covered
//   whole straight to out. A tile that two or more blocks share: each leaves
//   its partial tile in the f32 workspace (slot 0 for a block's first tile,
//   slot 1 for its last); the last block to arrive on the tile's counter adds
//   them in block order, which is K order, and resets the counter to 0, so
//   the counters need no memset and two launches are bitwise equal (no
//   atomics on the sums).
// - Weight tiles reach a ring of two 64 KiB shared-memory stages (64 rows of
//   w and c in f32, 128 in bf16), requested `stages` units ahead across the
//   run's tile boundaries, so a block's flush overlaps the next loads. One
//   thread fills a stage with three 2-D tensor-map tile copies (TMA: the
//   spike rows, the w and the c tile), completing on the stage's mbarrier by
//   byte count; rows and columns past the matrix arrive as zeros. On an H100
//   every thread's 16-byte cp.async copies (masked_product.cuh's fill)
//   measured within 2 % of it, slower at the main f32 shape; fewer, larger
//   stages won over more, smaller ones and over two blocks per SM (PERF.md
//   section 6). Consumers read 4 columns per lane (float4, or 4 bf16 in 8
//   bytes) and the staged spike values as broadcasts.
// - Rows that do not start on 16-byte boundaries (ragged widths, odd K,
//   unaligned views) take the element fill: one stage, loaded bounds-checked
//   and zero-filled by every thread. Where the units would not fill the card
//   the plan is the tile path: one block per output tile over all of K, no
//   workspace, no counters. At most kSmallWeights weights (predict_int's
//   45 x 4 x 3 and 80 x 64 x 10, where one launch is the whole cost) take the
//   small path: w * c and a block's spike rows staged whole in shared memory,
//   then one thread per output, K in order.
//
// Rounding: w * c in the operand dtype (masked()), then each term one
// __fmaf_rn(s, wc, acc) in K order within a warp's rows; the warp and block
// partial sums are added in fixed order. For 0/1 spikes (and for integer
// spikes times integer weights below 2^24, predict_int's) the product is
// exact, so the fused multiply-add rounds as acc + s * wc does; for any other
// s it rounds once where a multiply-then-add rounds twice. On 0/1 spikes
// times u8-grid weights every partial sum is an integer below 2^24, so the
// result is exact in any summation order and bitwise the twin's.
#include <cuda.h>
#include <cudaTypedefs.h>

#include <algorithm>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "masked_product.cuh"

namespace {

namespace mp = repro_torch::mp;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockN = 128;  // columns per tile, 4 per lane
constexpr int kRows = 8;      // batch rows per row group
constexpr int kMaxStages = 8;
constexpr int kBarrierBytes = 128;
constexpr int kMaxSmem = 232448;
constexpr int kPartBytes = kWarps * kRows * kBlockN * 4;  // the warps' partial tiles
constexpr int kSmallWeights = 8192;  // K * N at most, on the small path (32 KiB)
constexpr int kSmallSpikes = 4096;   // spike values a small-path block stages (16 KiB)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// w * c in the operand dtype, then f32 (the reference's
// (w * c.astype(w.dtype)).astype(f32)). The f32 product of two bf16 values is
// exact, so rounding it once to bf16 is the correctly rounded bf16 product.
__device__ __forceinline__ float masked(float w, float c) { return __fmul_rn(w, c); }
__device__ __forceinline__ float masked(__nv_bfloat16 w, __nv_bfloat16 c) {
  return __bfloat162float(__float2bfloat16_rn(__fmul_rn(__bfloat162float(w), __bfloat162float(c))));
}

// Four consecutive elements of a staged row, as f32 operands of masked().
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, __nv_bfloat16 (&v)[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&x.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&x.y);
  v[0] = lo.x;
  v[1] = lo.y;
  v[2] = hi.x;
  v[3] = hi.y;
}

struct Args {
  const void* s;        // (B, K) f32 or bf16
  const void* w;        // (K, N)
  const void* c;        // (K, N), w's dtype
  float* out;           // (B, N)
  float* ws;            // (blocks, 2, kRows, kBlockN) partial tiles, or null (tile path)
  int* counters;        // (tiles,) arrivals, all 0 between launches, or null
  int B, K, N;
  int kt, stages;
  int col_tiles, k_tiles;
  long long units;
  bool tma;             // stages filled by tensor-map tiles, else element by element
};

// Unit u -> (tile, K tile); tile -> (row group, column tile). A block
// divides once, for its first unit, and then steps (next()).
struct Unit {
  int tile, kk, g, j;
  __device__ Unit(long long u, const Args& a) {
    tile = static_cast<int>(u / a.k_tiles);
    kk = static_cast<int>(u - static_cast<long long>(tile) * a.k_tiles);
    g = tile / a.col_tiles;
    j = tile - g * a.col_tiles;
  }
  __device__ void next(const Args& a) {
    if (++kk < a.k_tiles) return;
    kk = 0;
    ++tile;
    if (++j < a.col_tiles) return;
    j = 0;
    ++g;
  }
};

__device__ __forceinline__ long long unit_begin(long long p, long long units, long long blocks) {
  return p * units / blocks;
}
// The block whose run holds unit u (runs are never empty: blocks <= units).
__device__ __forceinline__ long long unit_owner(long long u, long long units, long long blocks) {
  return ((u + 1) * blocks + units - 1) / units - 1;
}

template <typename TS, typename TW>
struct Stage {
  TS* s;  // [kRows][kt]
  TW* w;  // [kt][kBlockN]
  TW* c;  // [kt][kBlockN]
  __device__ Stage(unsigned char* base, int kt) {
    s = reinterpret_cast<TS*>(base);
    w = reinterpret_cast<TW*>(base + kRows * kt * sizeof(TS));
    c = w + kt * kBlockN;
  }
  __host__ __device__ static long long bytes(int kt) {
    return static_cast<long long>(kRows) * kt * sizeof(TS) + 2LL * kt * kBlockN * sizeof(TW);
  }
};

// Thread 0: one unit as three 2-D tensor-map tiles (the s rows of the row
// group, the w and c tiles; maps in that order), completing on the stage's
// barrier by their byte count. Rows and columns past the matrix arrive as
// zeros.
template <typename TS, typename TW>
__device__ __forceinline__ void request(const Args& a, const Unit& u, const Stage<TS, TW>& st,
                                        uint64_t* bar, const CUtensorMap* const (&maps)[3]) {
  if (threadIdx.x != 0) return;
  const uint32_t bytes = static_cast<uint32_t>(Stage<TS, TW>::bytes(a.kt));
  const int k0 = u.kk * a.kt;
  const int n0 = u.j * kBlockN;
  // The stage was last written by this block's generic stores (a flush) or
  // read by its loads: order them before the tensor copies that overwrite it.
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   mp::smem_u32(bar)),
               "r"(bytes)
               : "memory");
  auto load = [&](void* dst, const CUtensorMap* map, int x, int y) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%2, %3}], [%4];" ::"r"(mp::smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(mp::smem_u32(bar))
        : "memory");
  };
  load(st.s, maps[0], k0, u.g * kRows);
  load(st.w, maps[1], n0, k0);
  load(st.c, maps[2], n0, k0);
}

// Every thread: one unit loaded element by element, bounds-checked,
// zero-filled (the caller syncs before and after).
template <typename TS, typename TW>
__device__ __forceinline__ void fill(const Args& a, const Unit& u, const Stage<TS, TW>& st) {
  const int k0 = u.kk * a.kt;
  const int rows = min(a.kt, a.K - k0);
  const int n0 = u.j * kBlockN;
  const int ncols = min(kBlockN, a.N - n0);
  const TW* w = static_cast<const TW*>(a.w);
  const TW* c = static_cast<const TW*>(a.c);
  const TW zero = TW(0.0f);
  for (int i = threadIdx.x; i < a.kt * kBlockN; i += kThreads) {
    const int r = i / kBlockN;
    const int col = i - r * kBlockN;
    const bool ok = r < rows && col < ncols;
    const long long g = static_cast<long long>(k0 + r) * a.N + n0 + col;
    st.w[i] = ok ? w[g] : zero;
    st.c[i] = ok ? c[g] : zero;
  }
  const int b0 = u.g * kRows;
  const TS* s = static_cast<const TS*>(a.s);
  for (int i = threadIdx.x; i < kRows * a.kt; i += kThreads) {
    const int b = i / a.kt;
    const int k = i - b * a.kt;
    st.s[i] = (b0 + b < a.B && k < rows) ? s[static_cast<long long>(b0 + b) * a.K + k0 + k]
                                         : TS(0.0f);
  }
}

// This warp's rows of one staged unit (rows warp, warp + kWarps, ...).
template <typename TS, typename TW>
__device__ __forceinline__ void accumulate(float (&acc)[kRows][4], const Stage<TS, TW>& st,
                                           int kt, int rows, int warp, int lane) {
#pragma unroll 4
  for (int r = warp; r < rows; r += kWarps) {
    TW wv[4], cv[4];
    load4(st.w + r * kBlockN + lane * 4, wv);
    load4(st.c + r * kBlockN + lane * 4, cv);
    float wc[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) wc[i] = masked(wv[i], cv[i]);
#pragma unroll
    for (int b = 0; b < kRows; ++b) {
      const float sv = to_f32(st.s[b * kt + r]);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[b][i] = __fmaf_rn(sv, wc[i], acc[b][i]);
    }
  }
}

// The end of a tile's run in this block: the warps' sums in warp order, then
// the tile written whole, or left in the workspace, where the last block to
// arrive adds every block's partial tile in K order.
__device__ void flush(const Args& a, float (&acc)[kRows][4], float* part, const Unit& u,
                      int* last_flag) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long P = gridDim.x;
  const long long p = blockIdx.x;
#pragma unroll
  for (int b = 0; b < kRows; ++b) {
    *reinterpret_cast<float4*>(part + (warp * kRows + b) * kBlockN + lane * 4) =
        make_float4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]);
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[b][i] = 0.0f;
  }
  __syncthreads();
  const long long first = static_cast<long long>(u.tile) * a.k_tiles;
  const long long q0 = unit_owner(first, a.units, P);
  const long long q1 = unit_owner(first + a.k_tiles - 1, a.units, P);
  const int b0 = u.g * kRows;
  const int n0 = u.j * kBlockN;
  const int nb = min(kRows, a.B - b0);
  const int ncols = min(kBlockN, a.N - n0);
  constexpr int kTile = kRows * kBlockN;
  // A block's first tile goes to workspace slot 0, its last to slot 1.
  auto slot_of = [&](long long q) {
    return (q * 2 + (unit_begin(q, a.units, P) >= first ? 0 : 1)) * kTile;
  };
  const bool whole = q0 == q1;
  float* mine = whole ? nullptr : a.ws + slot_of(p);
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    float sum = part[i];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) sum = __fadd_rn(sum, part[w * kTile + i]);
    const int b = i / kBlockN;
    const int col = i - b * kBlockN;
    if (whole) {
      if (b < nb && col < ncols) a.out[static_cast<long long>(b0 + b) * a.N + n0 + col] = sum;
    } else {
      mine[i] = sum;
    }
  }
  if (!whole) {
    __threadfence();  // this block's partial tile is visible before it arrives
    __syncthreads();
    if (threadIdx.x == 0)
      *last_flag = atomicAdd(&a.counters[u.tile], 1) == static_cast<int>(q1 - q0);
    __syncthreads();
    if (*last_flag) {
      __threadfence();
      for (int i = threadIdx.x; i < kTile; i += kThreads) {
        const int b = i / kBlockN;
        const int col = i - b * kBlockN;
        if (b >= nb || col >= ncols) continue;
        float sum = __ldcg(a.ws + slot_of(q0) + i);
        for (long long q = q0 + 1; q <= q1; ++q) sum = __fadd_rn(sum, __ldcg(a.ws + slot_of(q) + i));
        a.out[static_cast<long long>(b0 + b) * a.N + n0 + col] = sum;
      }
      if (threadIdx.x == 0) a.counters[u.tile] = 0;  // ready for the next launch
    }
  }
  __syncthreads();  // part and last_flag are free again
}

template <typename TS, typename TW>
__global__ void __launch_bounds__(kThreads, 2)
    spike_matmul_kernel(Args a, const __grid_constant__ CUtensorMap tm_s,
                        const __grid_constant__ CUtensorMap tm_w,
                        const __grid_constant__ CUtensorMap tm_c) {
  // [barriers ... last_flag][stage 0][stage 1]...: no static shared memory, so
  // every stage starts on a 128-byte boundary, as the tensor copies need.
  extern __shared__ __align__(1024) unsigned char smem[];
  int* last_flag = reinterpret_cast<int*>(smem + kBarrierBytes) - 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  unsigned char* ring = smem + kBarrierBytes;
  const int stage_bytes = static_cast<int>(Stage<TS, TW>::bytes(a.kt));
  auto stage = [&](int i) { return Stage<TS, TW>(ring + i * stage_bytes, a.kt); };

  const long long u0 = unit_begin(blockIdx.x, a.units, gridDim.x);
  const int n = static_cast<int>(unit_begin(blockIdx.x + 1, a.units, gridDim.x) - u0);
  if (a.tma) {
    if (threadIdx.x == 0) {
      for (int i = 0; i < a.stages; ++i) mp::mbar_init(&full[i], 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
  }
  const CUtensorMap* maps[3] = {&tm_s, &tm_w, &tm_c};
  // `ahead` is the unit `stages` after `u`, the next one to request.
  Unit u(u0, a), ahead(u0, a);
  for (int t = 0; t < min(a.stages, n); ++t) {
    if (a.tma) request(a, ahead, stage(t), &full[t], maps);
    ahead.next(a);
  }

  float acc[kRows][4];
#pragma unroll
  for (int b = 0; b < kRows; ++b)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[b][i] = 0.0f;

  // Unit t sits in stage `slot`, whose barrier completes phase `phase`.
  int slot = 0;
  uint32_t phase = 0;
  for (int t = 0; t < n; ++t, u.next(a)) {
    const auto st = stage(slot);
    const int rows = min(a.kt, a.K - u.kk * a.kt);
    if (a.tma) {
      mp::mbar_wait(&full[slot], phase);
    } else {
      fill(a, u, st);
      __syncthreads();
    }
    accumulate(acc, st, a.kt, rows, warp, lane);
    __syncthreads();  // every warp is done with this stage
    // The run of a tile ends: the stage just read holds the warps' partial
    // sums until the flush is done, then takes its next tile.
    if (u.kk == a.k_tiles - 1 || t == n - 1)
      flush(a, acc, reinterpret_cast<float*>(ring + slot * stage_bytes), u, last_flag);
    if (a.tma && t + a.stages < n) {
      request(a, ahead, st, &full[slot], maps);
      ahead.next(a);
    }
    if (++slot == a.stages) {
      slot = 0;
      phase ^= 1;
    }
  }
}

// The small path (predict_int's products, where one launch is the whole
// cost): each block stages w * c whole (at most kSmallWeights values) and
// the spike rows its outputs read (at most kSmallSpikes values) in shared
// memory in one coalesced pass, then each thread sums one output over K in
// order.
template <typename TS, typename TW>
__global__ void __launch_bounds__(kThreads) spike_matmul_small_kernel(Args a) {
  __shared__ float wc[kSmallWeights];
  __shared__ float rows[kSmallSpikes];
  const TS* s = static_cast<const TS*>(a.s);
  const TW* w = static_cast<const TW*>(a.w);
  const TW* c = static_cast<const TW*>(a.c);
  const long long outputs = static_cast<long long>(a.B) * a.N;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads;
  const long long last = min(outputs, first + kThreads) - 1;
  const long long b0 = first / a.N;
  const int spikes = static_cast<int>(last / a.N - b0 + 1) * a.K;
  const int weights = a.K * a.N;
  for (int i = threadIdx.x; i < weights + spikes; i += kThreads) {
    if (i < weights)
      wc[i] = masked(w[i], c[i]);
    else
      rows[i - weights] = to_f32(s[b0 * a.K + i - weights]);
  }
  __syncthreads();
  const long long i = first + threadIdx.x;
  if (i >= outputs) return;
  const long long b = i / a.N;
  const int n = static_cast<int>(i - b * a.N);
  const float* row = rows + (b - b0) * a.K;
  float acc = 0.0f;
#pragma unroll 8
  for (int k = 0; k < a.K; ++k) acc = __fmaf_rn(row[k], wc[k * a.N + n], acc);
  a.out[i] = acc;
}

// cuTensorMapEncodeTiled, looked up once through the runtime's entry-point
// query (no link against libcuda).
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    cudaDriverEntryPointQueryResult found;
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A row-major (rows, cols) matrix as 2-D tiles of box_rows x box_cols.
template <typename T>
bool tensor_map(CUtensorMap* map, const void* base, long long rows, long long cols, int box_rows,
                int box_cols) {
  const auto encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const CUtensorMapDataType type =
      sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * sizeof(T)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename TS, typename TW>
cudaError_t launch(const Args& a, bool small, int blocks, int smem, cudaStream_t stream) {
  if (small) {
    spike_matmul_small_kernel<TS, TW><<<blocks, kThreads, 0, stream>>>(a);
    return cudaGetLastError();
  }
  CUtensorMap tm_s = {}, tm_w = {}, tm_c = {};
  if (a.tma &&
      !(tensor_map<TS>(&tm_s, a.s, a.B, a.K, kRows, a.kt) &&
        tensor_map<TW>(&tm_w, a.w, a.K, a.N, a.kt, kBlockN) &&
        tensor_map<TW>(&tm_c, a.c, a.K, a.N, a.kt, kBlockN)))
    return cudaErrorInvalidValue;
  static int opted = 0;  // per instantiation
  auto kernel = spike_matmul_kernel<TS, TW>;
  if (smem > opted) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted = smem;
  }
  kernel<<<blocks, kThreads, smem, stream>>>(a, tm_s, tm_w, tm_c);
  return cudaGetLastError();
}

}  // namespace

// s (B, K), w and c (K, N), out (B, N) f32, all contiguous row-major.
// s_bf16 / w_bf16 pick bf16 over f32 for s and for both w and c. The last four
// ints are the plan (kernels/_stream.py MatmulPlan.args): K rows per unit,
// stages, blocks and dynamic shared memory; the fill follows from the
// operands' alignment. ws (blocks x 2 x 8 x 128 f32) and counters (one int32
// per output tile, all 0) are needed unless blocks is the number of output
// tiles (the tile path). Returns the cudaError_t of the launch (0 on
// success), cudaErrorInvalidValue for a shape or plan it cannot take. Never
// synchronises and allocates nothing: the caller owns every buffer.
extern "C" int repro_spike_matmul(const void* s, const void* w, const void* c, void* out,
                                  void* ws, void* counters, int B, int K, int N, int s_bf16,
                                  int w_bf16, int kt, int stages, int blocks, int smem,
                                  void* stream) {
  if (B < 1 || K < 1 || N < 1 || kt < 8 || kt % 8 != 0 || stages < 1 ||
      stages > kMaxStages || blocks < 1 || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const int s_size = s_bf16 ? 2 : 4;
  const int w_size = w_bf16 ? 2 : 4;
  Args a;
  a.s = s;
  a.w = w;
  a.c = c;
  a.out = static_cast<float*>(out);
  a.ws = static_cast<float*>(ws);
  a.counters = static_cast<int*>(counters);
  a.B = B;
  a.K = K;
  a.N = N;
  a.kt = kt;
  a.col_tiles = (N + kBlockN - 1) / kBlockN;
  a.k_tiles = (K + kt - 1) / kt;
  const long long tiles = static_cast<long long>((B + kRows - 1) / kRows) * a.col_tiles;
  a.units = tiles * a.k_tiles;
  // The fill (kernels/_stream.py b6_fill): tensor-map tiles when every row
  // starts on a 16-byte boundary, else element by element.
  a.tma = mp::aligned16(s) && mp::aligned16(w) && mp::aligned16(c) &&
          (static_cast<long long>(K) * s_size) % 16 == 0 &&
          (static_cast<long long>(N) * w_size) % 16 == 0;
  a.stages = a.tma ? stages : 1;
  // The small path (kernels/_stream.py spike_matmul_plan): few enough weights,
  // and spike rows per block of kThreads outputs, to stage them all.
  const long long block_rows = std::min<long long>(B, (kThreads + N - 1) / N + 1);
  const bool small = static_cast<long long>(K) * N <= kSmallWeights &&
                     block_rows * K <= kSmallSpikes;
  const long long stage = static_cast<long long>(kRows) * kt * s_size + 2LL * kt * kBlockN * w_size;
  if (!small && (stage < kPartBytes || smem < kBarrierBytes + a.stages * stage ||
                 blocks > a.units || a.units > 0x7fffffff ||
                 (blocks != tiles && (ws == nullptr || counters == nullptr))))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (!s_bf16 && !w_bf16)
    err = launch<float, float>(a, small, blocks, smem, st);
  else if (!s_bf16)
    err = launch<float, __nv_bfloat16>(a, small, blocks, smem, st);
  else if (!w_bf16)
    err = launch<__nv_bfloat16, float>(a, small, blocks, smem, st);
  else
    err = launch<__nv_bfloat16, __nv_bfloat16>(a, small, blocks, smem, st);
  return static_cast<int>(err);
}
