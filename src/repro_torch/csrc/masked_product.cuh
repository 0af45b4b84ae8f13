// The masked synaptic product shared by kernels B1 (lif_step.cu) and B2
// (tick_fused.cu): for one slot, the partial sums of s @ (w * c) over a tile
// of up to BB batch rows and kBlockN output columns, in f32.
//
// Replaces the product loop of repro/kernels/lif_step.py::_fused_kernel and
// repro/kernels/tick_fused.py::_tick_kernel (the TPU's sequential K grid axis
// with its VMEM accumulator).
//
// Operand forms: premasked w (c == null); w and c streamed and masked per
// element with __fmul_rn(w, c); per-synapse delays (an int32 (K, N) plane),
// where synapse (k, n) reads ring plane (rs - (d - 1)) mod D of the staged
// spike history and a delay outside [1, D] routes nothing (the weight times
// 0.0, not a skip, as the reference's one-hot planes do).
//
// What bounds it on Hopper: the weight bytes. At most 16 batch rows meet each
// (K, N) f32 weight, 2-8 FLOP per byte, against the ~20 FLOP per byte at
// which the f32 CUDA cores would run out (67 TFLOP/s over 3.35 TB/s). So the
// design is about streaming device memory, not tensor cores (TF32 would
// also break the port's full-f32 contract):
//
// - Weight tiles by asynchronous copy into a shared-memory ring. A stage
//   holds kt weight rows x kBlockN columns of w (and of c and the delays),
//   plus the kt matching spike columns of the block's rows (all D ring
//   planes with per-synapse delays). Tiles are requested `stages - 1` ahead and
//   each stage completes on its own mbarrier, so no load passes through the
//   registers (where ptxas sank B6's loads next to their use). The fill is
//   every thread's 16-byte cp.async copies, each thread arriving on the
//   stage's barrier once its copies land (cp.async.mbarrier.arrive). Hopper's
//   cp.async.bulk (warp 0 issuing one copy per 512-byte row segment, the
//   barrier counting transaction bytes) was built and measured first, and was
//   the slower fill at every main-path shape on the H100 (PERF.md section 6):
//   one bulk request per 512-byte row is a fine grain for the copy engine; a
//   2-D tensor map (one request per tile) is what would lift it. The plan
//   (kernels/_plan.py) gives two stages (double buffering) of up to 40 KiB,
//   kt up to 64 rows: deeper stages and fewer of them were faster at the
//   main-path shapes (PERF.md section 6), and two blocks share an SM.
// - Consumers read the tile from shared memory: each lane owns 4 columns
//   (float4 reads), the spike value is a broadcast, and BB x 4 f32 sums stay
//   in registers. The four warps split each stage's rows, 4 at a time.
// - A cluster of ks <= 8 blocks splits K where the grid would be thinner
//   than one wave (one network of 8 or 16 rows: 32 column tiles). Each block
//   owns one contiguous K range. The warps' partial tiles are added in warp
//   order in shared memory; then the cluster's rank-0 block adds the peers'
//   tiles through distributed shared memory in rank order. No atomics: the
//   result is the same on every run.
// - Shapes whose rows do not start on 16-byte boundaries (ragged N, odd K,
//   unaligned views) take the element path inside the same kernel: every
//   thread loads the tile bounds-checked into one stage, zero-filled. The C
//   entry derives the path from the operands (async_fill), as the planner
//   does.
//
// Rounding: the mask is __fmul_rn(w, c), and each term is one
// __fmaf_rn(s, wc, acc). The product takes spikes: s is 0 or 1 (a
// precondition the wrappers state), so s * wc is exact and the fused
// multiply-add rounds exactly as __fadd_rn(acc, __fmul_rn(s, wc)) does, with
// half the floating-point instructions. At 8-16 rows the product is bound by
// them: on an H100 the multiply-then-add form measured 41 % slower at 16
// rows (PERF.md section 6). For any other s each term is rounded once
// instead of twice.
// On the u8 weight grid every partial sum is an integer below 2^24, so any
// split is bitwise equal to the plain twin; off the grid the warp and rank
// split changes the summation order (the learning checks' tolerance holds it).
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {
namespace mp {

namespace cg = cooperative_groups;

constexpr int kBlockN = 128;        // output columns per block, 4 per lane
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxStages = 8;
constexpr int kMaxSplit = 8;        // the portable cluster size
constexpr int kBarrierBytes = 128;  // the stages' mbarriers, ahead of the stages
constexpr int kMaxSmem = 232448;    // Hopper's per-block opt-in limit

// The launch plan chosen by kernels/_plan.py, as the C entries receive it,
// and the fill the C entry derives (async_fill).
struct Plan {
  int bb;       // batch rows per block (the kernel's BB)
  int kt;       // weight rows per stage, a multiple of 4
  int stages;   // shared-memory stages
  int ks;       // blocks of a cluster splitting K
  int k_chunk;  // K rows per cluster rank
  int smem;     // dynamic shared memory per block, bytes
  bool async;   // stages filled by cp.async (else element by element)
};

// One block's operands, already offset to its slot, rows and columns.
struct Operand {
  const float* s;     // spike history of row b0 at k = 0 (plane 0, or the read plane)
  long long s_row;    // elements between batch rows
  long long s_plane;  // elements between ring planes (per-synapse delays)
  int n_planes;       // ring planes staged: D with per-synapse delays, else 1
  int nb;             // live batch rows of the block, <= BB
  const float* w;     // (K, N) weights at column n0
  const float* c;     // (K, N) mask at column n0, or null
  const int* d;       // (K, N) delays at column n0, or null
  int N;              // row stride of w, c, d
  int ncols;          // live columns of the block, <= kBlockN
  int k_begin, k_end; // this block's range of K
  int rs;             // ring read slot (per-synapse delays)
};

__host__ __device__ constexpr long long stage_floats(int bb, int kt, int planes, int n_planes) {
  return static_cast<long long>(bb) * n_planes * kt + static_cast<long long>(planes) * kt * kBlockN;
}

// The shared memory a plan needs; the planner's smem_bytes.
__host__ __device__ constexpr long long smem_needed(int bb, int kt, int stages, int planes,
                                                    int n_planes) {
  return kBarrierBytes + (stages * stage_floats(bb, kt, planes, n_planes) * 4 >
                                  static_cast<long long>(kWarps) * bb * kBlockN * 4
                              ? stages * stage_floats(bb, kt, planes, n_planes) * 4
                              : static_cast<long long>(kWarps) * bb * kBlockN * 4);
}

// The fill of a launch: cp.async when every row it copies starts on a 16-byte
// boundary, else the element path (kernels/_plan.py plan's path, by the same
// rule). rows_aligned: every streamed operand's base 16-byte aligned and its
// slot and row strides multiples of 4 elements.
inline bool async_fill(const Plan& p, int K, int N, bool rows_aligned) {
  return rows_aligned && K % 4 == 0 && N % 4 == 0 && p.k_chunk % 4 == 0;
}

// Host check of a plan against the launch it is given: false means refuse.
inline bool plan_ok(const Plan& p, int B, int K, int planes, int n_planes) {
  if (p.bb < 1 || p.kt < 4 || p.kt % 4 != 0 || p.stages < 1 || p.stages > kMaxStages ||
      p.ks < 1 || p.ks > kMaxSplit || p.k_chunk < 1 ||
      static_cast<long long>(p.k_chunk) * p.ks < K || p.smem > kMaxSmem ||
      p.smem < smem_needed(p.bb, p.kt, p.stages, planes, n_planes))
    return false;
  return (B + p.bb - 1) / p.bb <= 65535;
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// --- Hopper primitives ------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait until the phase of parity `parity` of the barrier has completed. A
// copy that never lands (a fault in the pipeline) traps after 5 s, so the
// launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  uint64_t t0 = 0;
  for (;;) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = global_ns();
    } else if (global_ns() - t0 > 5000000000ull) {
      __trap();
    }
  }
}

// 16 bytes from global to shared, cached in L2 only (Ampere's cp.async).
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// The barrier receives one arrival from this thread once all of its earlier
// cp.async copies have landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// --- the product ------------------------------------------------------------

template <int BB, bool HAS_C, bool DELAYS>
struct Stage {
  static constexpr int kPlanes = 1 + (HAS_C ? 1 : 0) + (DELAYS ? 1 : 0);
  float* s;  // [BB][n_planes][kt]
  float* w;  // [kt][kBlockN]
  float* c;
  int* d;

  __device__ Stage(float* base, const Operand& op, int kt) {
    s = base;
    w = base + BB * op.n_planes * kt;
    c = w + kt * kBlockN;
    d = reinterpret_cast<int*>(c + (HAS_C ? kt * kBlockN : 0));
    if (!HAS_C) c = nullptr;
    if (!DELAYS) d = nullptr;
  }
};

// Every thread: its share of tile t's 16-byte copies, then one arrival on
// the stage's barrier when they have landed (the barrier counts kThreads).
template <int BB, bool HAS_C, bool DELAYS>
__device__ __forceinline__ void copy_tile_cp(const Operand& op,
                                             const Stage<BB, HAS_C, DELAYS>& st, uint64_t* bar,
                                             int kt, int kt0, int rows) {
  const int q = op.ncols >> 2;  // 16-byte chunks per weight row
  for (int i = threadIdx.x; i < rows * q; i += kThreads) {
    const int r = i / q;
    const int col = (i - r * q) * 4;
    const long long g = static_cast<long long>(kt0 + r) * op.N + col;
    copy16(st.w + r * kBlockN + col, op.w + g);
    if constexpr (HAS_C) copy16(st.c + r * kBlockN + col, op.c + g);
    if constexpr (DELAYS) copy16(st.d + r * kBlockN + col, op.d + g);
  }
  const int qs = rows >> 2;  // 16-byte chunks per spike row
  for (int i = threadIdx.x; i < op.nb * op.n_planes * qs; i += kThreads) {
    const int bj = i / qs;
    const int k = (i - bj * qs) * 4;
    const int b = bj / op.n_planes;
    const int j = bj - b * op.n_planes;
    copy16(st.s + bj * kt + k, op.s + b * op.s_row + j * op.s_plane + kt0 + k);
  }
  cp_async_arrive(bar);
}

// Every thread: tile t loaded element by element, bounds-checked, zero-filled.
template <int BB, bool HAS_C, bool DELAYS>
__device__ __forceinline__ void fill_tile(const Operand& op, const Stage<BB, HAS_C, DELAYS>& st,
                                          int kt, int kt0, int rows) {
  for (int i = threadIdx.x; i < kt * kBlockN; i += kThreads) {
    const int r = i / kBlockN;
    const int col = i - r * kBlockN;
    const bool ok = r < rows && col < op.ncols;
    const long long g = static_cast<long long>(kt0 + r) * op.N + col;
    st.w[i] = ok ? op.w[g] : 0.0f;
    if constexpr (HAS_C) st.c[i] = ok ? op.c[g] : 0.0f;
    if constexpr (DELAYS) st.d[i] = ok ? op.d[g] : 0;
  }
  for (int i = threadIdx.x; i < BB * op.n_planes * kt; i += kThreads) {
    const int bj = i / kt;
    const int k = i - bj * kt;
    const int b = bj / op.n_planes;
    const int j = bj - b * op.n_planes;
    st.s[i] = (b < op.nb && k < rows) ? op.s[b * op.s_row + j * op.s_plane + kt0 + k] : 0.0f;
  }
}

// This warp's rows of one staged tile (groups of 4 rows: warp, warp + 4, ...).
template <int BB, bool HAS_C, bool DELAYS>
__device__ __forceinline__ void accumulate_tile(float (&acc)[BB][4],
                                                const Stage<BB, HAS_C, DELAYS>& st,
                                                const Operand& op, int kt, int rows, int warp,
                                                int lane) {
  const int groups = (rows + 3) >> 2;
  for (int g = warp; g < groups; g += kWarps) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = g * 4 + u;
      const float4 wv = *reinterpret_cast<const float4*>(st.w + k * kBlockN + lane * 4);
      float wc[4] = {wv.x, wv.y, wv.z, wv.w};
      if constexpr (HAS_C) {
        const float4 cv = *reinterpret_cast<const float4*>(st.c + k * kBlockN + lane * 4);
        wc[0] = __fmul_rn(wc[0], cv.x);
        wc[1] = __fmul_rn(wc[1], cv.y);
        wc[2] = __fmul_rn(wc[2], cv.z);
        wc[3] = __fmul_rn(wc[3], cv.w);
      }
      if constexpr (DELAYS) {
        const int4 dv4 = *reinterpret_cast<const int4*>(st.d + k * kBlockN + lane * 4);
        const int dv[4] = {dv4.x, dv4.y, dv4.z, dv4.w};
        const int D = op.n_planes;
        int plane[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // Delay d in [1, D] reads plane (rs - (d - 1)) mod D; any other
          // delay routes nothing, as the reference's one-hot planes do.
          const bool ok = dv[i] >= 1 && dv[i] <= D;
          wc[i] = ok ? wc[i] : __fmul_rn(wc[i], 0.0f);
          plane[i] = ok ? (op.rs - dv[i] + 1 + D) % D : 0;
        }
#pragma unroll
        for (int b = 0; b < BB; ++b) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[b][i] = __fmaf_rn(st.s[(b * D + plane[i]) * kt + k], wc[i], acc[b][i]);
        }
      } else {
#pragma unroll
        for (int b = 0; b < BB; ++b) {
          const float sv = st.s[b * kt + k];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[b][i] = __fmaf_rn(sv, wc[i], acc[b][i]);
        }
      }
    }
  }
}

// The whole product of one block. Every thread of every block of the cluster
// calls it. Returns true in the cluster's rank-0 block, whose shared memory
// then holds the finished sums as sums(smem)[b * kBlockN + col]; the other
// blocks must not touch their shared memory afterwards.
template <int BB, bool HAS_C, bool DELAYS>
__device__ bool masked_product(const Operand& op, const Plan& p, unsigned char* smem) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  float* ring = reinterpret_cast<float*>(smem + kBarrierBytes);
  const long long stage_len =
      stage_floats(BB, p.kt, Stage<BB, HAS_C, DELAYS>::kPlanes, op.n_planes);
  const int n_tiles = op.k_end > op.k_begin ? (op.k_end - op.k_begin + p.kt - 1) / p.kt : 0;
  auto stage = [&](int t) {
    return Stage<BB, HAS_C, DELAYS>(ring + (t % p.stages) * stage_len, op, p.kt);
  };
  auto rows_of = [&](int t) { return min(p.kt, op.k_end - (op.k_begin + t * p.kt)); };

  // Tile t into its stage by every thread's cp.async.
  auto request = [&](int t) {
    copy_tile_cp(op, stage(t), &full[t % p.stages], p.kt, op.k_begin + t * p.kt, rows_of(t));
  };
  if (p.async) {
    if (threadIdx.x == 0) {
      for (int i = 0; i < p.stages; ++i) mbar_init(&full[i], kThreads);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    for (int t = 0; t < min(p.stages, n_tiles); ++t) request(t);
  }

  float acc[BB][4];
#pragma unroll
  for (int b = 0; b < BB; ++b)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[b][i] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    const auto st = stage(t);
    const int rows = rows_of(t);
    if (p.async) {
      mbar_wait(&full[t % p.stages], static_cast<uint32_t>((t / p.stages) & 1));
    } else {
      fill_tile(op, st, p.kt, op.k_begin + t * p.kt, rows);
      __syncthreads();
    }
    accumulate_tile(acc, st, op, p.kt, rows, warp, lane);
    __syncthreads();  // every warp is done with this stage
    if (p.async && t + p.stages < n_tiles) request(t + p.stages);
  }
  __syncthreads();  // no copy in flight, no reader left: the stages are free

  // The warps' partial tiles, added in warp order into warp 0's.
  float* part = ring;  // [kWarps][BB][kBlockN]
#pragma unroll
  for (int b = 0; b < BB; ++b)
    *reinterpret_cast<float4*>(part + (warp * BB + b) * kBlockN + lane * 4) =
        make_float4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]);
  __syncthreads();
  for (int i = threadIdx.x; i < BB * kBlockN; i += kThreads) {
    float sum = part[i];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) sum = __fadd_rn(sum, part[w * BB * kBlockN + i]);
    part[i] = sum;
  }
  if (p.ks == 1) {
    __syncthreads();
    return true;
  }
  // The cluster's tiles, added by rank 0 in rank order through distributed
  // shared memory; the second sync keeps the peers' memory alive until then.
  cg::cluster_group cluster = cg::this_cluster();
  const bool leader = cluster.block_rank() == 0;
  cluster.sync();
  if (leader) {
    for (int i = threadIdx.x; i < BB * kBlockN; i += kThreads) {
      float sum = part[i];
      for (int r = 1; r < p.ks; ++r) sum = __fadd_rn(sum, cluster.map_shared_rank(part, r)[i]);
      part[i] = sum;
    }
  }
  cluster.sync();
  return leader;
}

__device__ __forceinline__ const float* sums(const unsigned char* smem) {
  return reinterpret_cast<const float*>(smem + kBarrierBytes);
}

// This block's K range within its cluster, and its column tile.
__device__ __forceinline__ void block_range(const Plan& p, int K, int* tile, int* k_begin,
                                            int* k_end) {
  const int rank = static_cast<int>(blockIdx.x % p.ks);
  *tile = static_cast<int>(blockIdx.x / p.ks);
  const long long b = static_cast<long long>(rank) * p.k_chunk;
  *k_begin = static_cast<int>(b < K ? b : K);
  const long long e = b + p.k_chunk;
  *k_end = static_cast<int>(e < K ? e : K);
}

// Launch Kernel on a grid of clusters of p.ks blocks along x, with p.smem
// bytes of dynamic shared memory (opted into once per kernel).
template <auto Kernel, typename Args>
cudaError_t launch(dim3 grid, const Plan& p, cudaStream_t stream, const Args& args) {
  static int opted = 0;  // one per kernel
  if (p.smem > 48 * 1024 && p.smem > opted) {
    const cudaError_t err =
        cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return err;
    opted = p.smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(p.smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(p.ks);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, Kernel, args);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace mp
}  // namespace repro_torch
