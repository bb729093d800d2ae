// Fused vocab projection + exact top-k + logsumexp for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel imagetranslate_tpu/ops/topk_project.py
// (`_kernel` :143, `project_topk` :206). For each row m of h [M, E] it
// returns the k largest entries of logits[m] = h[m] . W^T + b (W is [V, E]
// row-major: a torch Linear weight or the tied embedding table), their vocab
// indices (lowest index first among equal values, the lax.top_k rule that the
// beam's tie semantics rely on) and logsumexp(logits[m]): fp32 sums over the
// whole of E, the fp32 bias added in fp32, columns >= V in neither. The
// [M, V] logits never reach shared or device memory.
//
// What bounds it: at the MT decode's shape (M = 256, E = 768, V = 32000,
// bf16) the weight read is 49 MB, 0.0148 ms at 3.35 TB/s, and the work 12.6
// GFLOP, 0.0127 ms at 989 TFLOP/s; at the caption decode's M = 768 the
// products (37.7 GFLOP, 0.0382 ms) bound it. So W has to come from device
// memory about once, and the products have to run on wgmma. On the card
// (PERF.md) loads and products alone come near that bound; what is left is
// the epilogue, which runs after a tile's products and before the next
// tile's, mostly the top-k lists' compares (a warp takes a branch where any
// of its lanes does).
//
// Design. Pass 1: a block owns a tile of BM = 128 rows and a contiguous
// range of vocab tiles of BN columns (256; 128 for k > 4, where the top-k
// lists need the registers; lists of 1, 4, 8 or 16 by k), and walks the
// range tile after tile, carrying
// its state in registers (the TPU kernel's sequential vocab grid axis). The
// plan (BN, tiles a range, ranges R) fills the 132 SMs about once; the row
// tile is the grid's fastest index, so the blocks that share a range run
// together and W comes from device memory once and from L2 after that.
//   - a producer warp streams (h, W) stages of 64 along E (one 128-byte
//     swizzle span) by TMA through a ring of mbarriers; the 2-D tensor maps
//     run over h as (E, M) and W as (E, V), both K-major as they lie, and
//     zero-fill ragged M, V and E;
//   - two consumer warpgroups of 64 rows run m64nBNk16 wgmma over E, then
//     take the tile's epilogue in registers: the bias (-inf past V), per
//     row an online (max, sum exp) over the thread's own columns, and a
//     private descending top-k list per row with indices. A score meets
//     the list's last value (and a whole tile meets it once through the
//     tile's maximum); only one that beats it is inserted. A thread visits
//     its columns in ascending order and inserts on strictly greater, so
//     the lower index keeps its place on a tie.
//   At the end of its range the quad of four threads that share a row
//   merges its lists (value descending, index ascending) and its (max,
//   sum); the block writes each row's top-k and (max, sum exp) of the range
//   to scratch [M, R, k] and [M, R, 2].
// Pass 2: a block per row merges the R sorted lists in k rounds, each taking
// the best head (value descending, index ascending: what an ascending merge
// that keeps the running entry on equal values gives); the lse folds the
// ranges' (max, sum) in a fixed order. No atomics: two launches give the
// same bits.
// K2b (the tensor-parallel decode, ops/topk_project.py:sharded_project_topk):
// each rank runs both passes over its V/n vocab rows; after the all_gather,
// itt_topk_merge runs pass 2 once more with the n shards as its ranges,
// reading the gathered [n, M, k] lists and [n, M] lses in place (strides,
// no transposed copy). The shards hold ascending vocab ranges, so the merge
// keeps lax.top_k's lowest-index rule across them.
//
// Plain C interface, loaded with ctypes (imagetranslate_tpu_torch/ops/_build.py).
// The TMA, mbarrier and wgmma helpers are in hopper.cuh.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BM = 128;           // rows a block: two consumer warpgroups of 64
constexpr int BK = 64;            // E a stage: one 128-byte swizzle span of bf16
constexpr int THREADS = 384;      // the producer warpgroup and two consumers
constexpr int SMS = 132;          // the plan fills an H100's SMs once
constexpr int MAX_K = 16;
constexpr int MERGE_THREADS = 128;  // pass 2 holds 2 ranges a thread: R <= 256
static_assert(SMS <= 2 * MERGE_THREADS, "the plan's R must fit pass 2");
constexpr int REMOVED = 0x7fffffff;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of a block, from a 1024-byte aligned base: h ring | W ring |
// mbarriers (full, then empty, a slot). KB: the length of a thread's top-k
// list (k <= KB).
template <int KB>
struct Cfg {
  // 64 rows x BN / 4 columns of fp32 accumulator a consumer thread: 128
  // registers at BN = 256. Beside two lists of 8 or 16 (value, index) pairs
  // and the epilogue's temporaries that spilled, so k > 4 takes BN = 128.
  static constexpr int BN = KB <= 4 ? 256 : 128;
  static constexpr uint32_t A_BYTES = BM * BK * 2;   // 16 KB
  static constexpr uint32_t B_BYTES = BN * BK * 2;   // 32 or 16 KB
  static constexpr int STAGES = 196608 / (A_BYTES + B_BYTES);  // 4 or 6: 192 KB
  static constexpr uint32_t OFF_B = STAGES * A_BYTES;
  static constexpr uint32_t OFF_BAR = OFF_B + STAGES * B_BYTES;
  static constexpr uint32_t SMEM = OFF_BAR + 2 * STAGES * 8 + 1024;  // + alignment
};

#define ACC128(i) ACC64(i), ACC64(i + 64)

// d[64, N] (+)= A[64, 16] . B[16, N], A and B K-major in shared memory
// (128 B swizzle); d = A . B when `accumulate` is 0. Lane l = 4 g + t of
// warp w holds d[4 j + e] = element (16 w + g + 8 (e / 2), 8 j + 2 t + e % 2).
__device__ __forceinline__ void wgmma_ss(float (&d)[128], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : ACC128(0)
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC64(0)
      : "l"(da), "l"(db), "r"(accumulate));
}

// a ranks before b: larger value, or equal value and lower index.
__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// Insert (x, col) into a descending list whose last value x beats; an equal
// value already there stays ahead (it has the lower index).
template <int KB>
__device__ __forceinline__ void insert(float (&lv)[KB], int (&li)[KB], float x, int col) {
#pragma unroll
  for (int q = KB - 1; q > 0; --q) {
    const bool up = x > lv[q - 1];  // x goes above q - 1: q takes its entry
    const bool here = x > lv[q];
    lv[q] = up ? lv[q - 1] : (here ? x : lv[q]);
    li[q] = up ? li[q - 1] : (here ? col : li[q]);
  }
  if (x > lv[0]) {
    lv[0] = x;
    li[0] = col;
  }
}

template <int KB>
__device__ __forceinline__ void pop_front(float (&lv)[KB], int (&li)[KB]) {
#pragma unroll
  for (int q = 0; q < KB - 1; ++q) {
    lv[q] = lv[q + 1];
    li[q] = li[q + 1];
  }
  lv[KB - 1] = -__int_as_float(0x7f800000);
  li[KB - 1] = REMOVED;
}

template <int KB>
__global__ void __launch_bounds__(THREADS, 1)
project_topk_ranges(const __grid_constant__ CUtensorMap hmap,
                    const __grid_constant__ CUtensorMap wmap, const float* __restrict__ bias,
                    float* __restrict__ part_val,  // [M, R, k]
                    int* __restrict__ part_idx,    // [M, R, k]
                    float* __restrict__ part_ms,   // [M, R, 2]
                    int M, int E, int V, int k, int per, int R) {
  using C = Cfg<KB>;
  constexpr int BN = C::BN;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar0 = base + C::OFF_BAR;
  auto bar_full = [&](int st) { return bar0 + 8 * st; };
  auto bar_empty = [&](int st) { return bar0 + 8 * (C::STAGES + st); };
  const int m0 = blockIdx.x * BM, range = blockIdx.y;
  const int t_lo = range * per;
  const int t_hi = min(t_lo + per, (V + BN - 1) / BN);
  const int nk = (E + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int st = 0; st < C::STAGES; ++st) {
      mbar_init(bar_full(st), 1);   // the producer's expect_tx
      mbar_init(bar_empty(st), 8);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer: one thread issues every load; the rest of the warpgroup
    // has nothing to do. setmaxnreg moves the registers to the consumers
    // (24 + 2 x 240 a lane of each SM sub-partition's 512).
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      int st = 0;
      uint32_t ph = 0;
      for (int tile = t_lo; tile < t_hi; ++tile) {
        // The tile's bias, on its way to L2 long before its epilogue reads it.
        for (int col = tile * BN; col < min(V, tile * BN + BN); col += 32)
          asm volatile("prefetch.global.L2 [%0];\n" ::"l"(bias + col));
        for (int ks = 0; ks < nk; ++ks) {
          mbar_wait(bar_empty(st), ph ^ 1);
          mbar_expect_tx(bar_full(st), C::A_BYTES + C::B_BYTES);
          tma_load2(base + st * C::A_BYTES, &hmap, bar_full(st), ks * BK, m0);
          tma_load2(base + C::OFF_B + st * C::B_BYTES, &wmap, bar_full(st), ks * BK, tile * BN);
          if (++st == C::STAGES) {
            st = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }

  // Consumers: warpgroup c owns rows 64 c .. 64 c + 63 of the tile; lane
  // 4 g + t of warp w holds rows 16 w + g and 16 w + g + 8.
  setmaxnreg_inc<240>();
  const int c = threadIdx.x / 128 - 1;
  const int warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const float NEG_INF = -__int_as_float(0x7f800000);

  float acc[BN / 2];
  float lv[2][KB];
  int li[2][KB];
  // Per row: the running max over the thread's columns, it times log2(e)
  // (the exponent's offset, rounded once), and sum exp(x - max).
  float m_run[2], ml_run[2], s_run[2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int q = 0; q < KB; ++q) {
      lv[r][q] = NEG_INF;
      li[r][q] = REMOVED;
    }
    m_run[r] = NEG_INF;
    ml_run[r] = NEG_INF;
    s_run[r] = 0.0f;
  }

  // Descriptors of a slot's first rows; a step adds its byte offset / 16 to
  // the address field (shared memory < 256 KB: no carry out of it).
  const uint64_t a_desc = gmma_desc(base + c * 64 * 128, 16, 1024, 1);
  const uint64_t b_desc = gmma_desc(base + C::OFF_B, 16, 1024, 1);
  int st = 0;
  uint32_t ph = 0;
  for (int tile = t_lo; tile < t_hi; ++tile) {
    for (int ks = 0; ks < nk; ++ks) {
      mbar_wait(bar_full(st), ph);
      wgmma_fence();
      const uint64_t da = a_desc + st * (C::A_BYTES / 16);
      const uint64_t db = b_desc + st * (C::B_BYTES / 16);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_ss(acc, da + 2 * kk, db + 2 * kk, ks > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(bar_empty(st));
      if (++st == C::STAGES) {
        st = 0;
        ph ^= 1;
      }
    }

    // The tile's logits: + bias, -inf past V.
    const int v0 = tile * BN;
    if (v0 + BN <= V) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + v0 + 8 * j + 2 * t));
        acc[4 * j] += bb.x;
        acc[4 * j + 1] += bb.y;
        acc[4 * j + 2] += bb.x;
        acc[4 * j + 3] += bb.y;
      }
    } else {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = v0 + 8 * j + 2 * t;
        const float b0 = col < V ? __ldg(bias + col) : NEG_INF;
        const float b1 = col + 1 < V ? __ldg(bias + col + 1) : NEG_INF;
        acc[4 * j] += b0;
        acc[4 * j + 1] += b1;
        acc[4 * j + 2] += b0;
        acc[4 * j + 3] += b1;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx[4] = {NEG_INF, NEG_INF, NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        mx[j & 3] = fmaxf(mx[j & 3], fmaxf(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]));
      const float tmax = fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]));
      if (tmax == NEG_INF) continue;  // none of the thread's columns is below V
      // exp(x - m) as 2^(x log2(e) - m log2(e)): one FFMA and one MUFU.EX2.
      const float m_new = fmaxf(m_run[r], tmax);
      const float ml = m_new * kLog2e;
      float sm[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        sm[j & 3] += ex2_ftz(fmaf(acc[4 * j + 2 * r], kLog2e, -ml)) +
                     ex2_ftz(fmaf(acc[4 * j + 2 * r + 1], kLog2e, -ml));
      s_run[r] = s_run[r] * ex2_ftz(ml_run[r] - ml) + ((sm[0] + sm[1]) + (sm[2] + sm[3]));
      m_run[r] = m_new;
      ml_run[r] = ml;
      // The top-k: the tile meets the list's last value once through its
      // maximum, and then each score meets it.
      if (tmax > lv[r][KB - 1]) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = acc[4 * j + 2 * r + e];
            if (x > lv[r][KB - 1]) insert(lv[r], li[r], x, v0 + 8 * j + 2 * t + e);
          }
      }
    }
  }

  // The quad's four lists and (max, sum) of a row, merged in a fixed order
  // (the butterfly gives every lane the same bits); lane t = 0 writes.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float m = m_run[r], s = s_run[r];
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, m, o);
      const float os = __shfl_xor_sync(0xffffffffu, s, o);
      const float mm = fmaxf(m, om);
      s = (s == 0.0f ? 0.0f : s * expf(m - mm)) + (os == 0.0f ? 0.0f : os * expf(om - mm));
      m = mm;
    }
    const int row = m0 + c * 64 + warp * 16 + g + 8 * r;
    const bool writes = row < M && t == 0;
    const size_t at = (size_t)row * R + range;
#pragma unroll
    for (int i = 0; i < KB; ++i) {
      if (i >= k) break;
      float bv = lv[r][0];
      int bi = li[r][0];
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        if (better(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (writes) {
        part_val[at * k + i] = bv;
        part_idx[at * k + i] = bi;
      }
      // Columns are the lanes' own, so a real winner is in one list; a
      // filler (-inf, REMOVED) pops from every list holding one, harmlessly.
      if (li[r][0] == bi && lv[r][0] == bv) pop_front(lv[r], li[r]);
    }
    if (writes) {
      part_ms[at * 2] = m;
      part_ms[at * 2 + 1] = s;
    }
  }
}

// Block reductions over MERGE_THREADS threads; `red` holds a value a warp.
__device__ __forceinline__ float block_max(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  return fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
}

__device__ __forceinline__ float block_sum(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  return (red[0] + red[1]) + (red[2] + red[3]);
}

// One block per row: the top-k of the row's R sorted lists, and its lse.
// Entry p of range r's list for row `row` lies at [row * row_stride + r *
// range_stride + p] of part_val / part_idx; the range's (max, sum exp) at
// [row * ms_row + r * ms_range] of part_max / part_sum (sum 1 where part_sum
// is null: the range's lse stands in as its max). Pass 2 of project_topk reads
// its scratch [M, R, k] and [M, R, 2]; itt_topk_merge reads the all_gather of
// n vocab shards' (val, idx) [n, M, k] and lse [n, M] in place.
// Thread i holds the heads of ranges i and i + MERGE_THREADS (R <= SMS <= 2
// MERGE_THREADS); k rounds each take the best head of the block (value
// descending, index ascending) and advance its list, which gives what an
// ascending merge that keeps the running entry on equal values gives.
__global__ void __launch_bounds__(MERGE_THREADS)
project_topk_merge(const float* __restrict__ part_val, const int* __restrict__ part_idx,
                   long long row_stride, long long range_stride,
                   const float* __restrict__ part_max, const float* __restrict__ part_sum,
                   long long ms_row, long long ms_range,
                   float* __restrict__ out_val,  // [M, k]
                   int* __restrict__ out_idx,    // [M, k]
                   float* __restrict__ out_lse,  // [M]
                   int k, int R) {
  constexpr int WARPS = MERGE_THREADS / 32;
  extern __shared__ __align__(16) unsigned char cand[];  // values [R k], indices [R k]
  __shared__ float red[WARPS], best_v[2][WARPS];
  __shared__ int best_i[2][WARPS];
  const long long row = blockIdx.x;
  const int n = R * k;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* sv = reinterpret_cast<float*>(cand);
  int* si = reinterpret_cast<int*>(sv + n);
  for (int i = threadIdx.x; i < n; i += MERGE_THREADS) {
    const long long at = row * row_stride + (i / k) * range_stride + i % k;
    sv[i] = part_val[at];
    si[i] = part_idx[at];
  }
  const float NEG_INF = -__int_as_float(0x7f800000);
  const float* mx = part_max + row * ms_row;
  float m = NEG_INF;
  for (int r = threadIdx.x; r < R; r += MERGE_THREADS) m = fmaxf(m, mx[r * ms_range]);
  m = block_max(m, red);  // its __syncthreads also put the candidates in place
  float s = 0.0f;
  for (int r = threadIdx.x; r < R; r += MERGE_THREADS) {
    const float sum = part_sum == nullptr ? 1.0f : part_sum[row * ms_row + r * ms_range];
    if (sum > 0.0f) s += sum * expf(mx[r * ms_range] - m);  // a range with no column < V adds nothing
  }
  s = block_sum(s, red);

  const int r0 = threadIdx.x, r1 = threadIdx.x + MERGE_THREADS;
  int p0 = 0, p1 = 0;  // the next entry of ranges r0 and r1
  for (int round = 0; round < k; ++round) {
    const bool has0 = r0 < R && p0 < k, has1 = r1 < R && p1 < k;
    const float v0 = has0 ? sv[r0 * k + p0] : NEG_INF;
    const int i0 = has0 ? si[r0 * k + p0] : REMOVED;
    const float v1 = has1 ? sv[r1 * k + p1] : NEG_INF;
    const int i1 = has1 ? si[r1 * k + p1] : REMOVED;
    float bv = v0;
    int bi = i0;
    if (better(v1, i1, bv, bi)) {
      bv = v1;
      bi = i1;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      best_v[round & 1][warp] = bv;
      best_i[round & 1][warp] = bi;
    }
    __syncthreads();
    bv = best_v[round & 1][0];
    bi = best_i[round & 1][0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w)
      if (better(best_v[round & 1][w], best_i[round & 1][w], bv, bi)) {
        bv = best_v[round & 1][w];
        bi = best_i[round & 1][w];
      }
    if (threadIdx.x == 0) {
      out_val[(size_t)row * k + round] = bv;
      out_idx[(size_t)row * k + round] = bi;
    }
    // Columns are the ranges' own, so the winner heads one list (V >= k:
    // the k winners are real columns, never the (-inf, REMOVED) filler).
    if (has0 && i0 == bi) ++p0;
    else if (has1 && i1 == bi) ++p1;
  }
  if (threadIdx.x == 0) out_lse[row] = m + logf(s);
}

// The work plan (ops/topk_project.py: work_plan, which the wrapper passes and
// this file checks): BN columns a vocab tile, `per` tiles a range, R ranges;
// range r covers tiles [r per, min((r + 1) per, tiles)), never empty.
void plan(int M, int V, int k, int* bn, int* per, int* ranges) {
  *bn = k <= 4 ? 256 : 128;
  const int tiles = (V + *bn - 1) / *bn;
  const int row_tiles = (M + BM - 1) / BM;
  int want = SMS / row_tiles;
  if (want < 1) want = 1;
  if (want > tiles) want = tiles;
  *per = (tiles + want - 1) / want;
  *ranges = (tiles + *per - 1) / *per;
}

// A map over the [rows, E] bf16 matrix at `ptr` as dims (E, rows), boxes of
// (64, box_rows) with the 128 B swizzle wgmma reads; out of bounds reads
// zeros.
int make_map(CUtensorMap* map, const void* ptr, int E, int rows, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)E, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)E * 2};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
                            dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int KB>
int launch(const void* h, const void* w, const void* bias, void* part_val, void* part_idx,
           void* part_ms, void* out_val, void* out_idx, void* out_lse, int M, int E, int V,
           int k, int per, int R, cudaStream_t stream) {
  using C = Cfg<KB>;
  CUtensorMap hmap, wmap;
  int err = make_map(&hmap, h, E, M, BM);
  if (err == 0) err = make_map(&wmap, w, E, V, C::BN);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(project_topk_ranges<KB>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((M + BM - 1) / BM, R);
  project_topk_ranges<KB><<<grid, THREADS, C::SMEM, stream>>>(
      hmap, wmap, static_cast<const float*>(bias), static_cast<float*>(part_val),
      static_cast<int*>(part_idx), static_cast<float*>(part_ms), M, E, V, k, per, R);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const float* ms = static_cast<const float*>(part_ms);
  project_topk_merge<<<M, MERGE_THREADS, (size_t)R * k * 8, stream>>>(
      static_cast<const float*>(part_val), static_cast<const int*>(part_idx), (long long)R * k, k,
      ms, ms + 1, 2LL * R, 2, static_cast<float*>(out_val), static_cast<int*>(out_idx),
      static_cast<float*>(out_lse), k, R);
  return (int)cudaGetLastError();
}

}  // namespace

// h [M, E], w [V, E] bf16, bias [V] fp32, contiguous and 16-byte aligned;
// scratch [M, R, k] (values, indices) and [M, R, 2] for the plan (bn, per,
// R), which must be work_plan's; a plan that does not match is refused.
extern "C" int itt_project_topk_bf16(const void* h, const void* w, const void* bias,
                                     void* part_val, void* part_idx, void* part_ms,
                                     void* out_val, void* out_idx, void* out_lse, int M, int E,
                                     int V, int k, int bn, int per, int R, void* stream) {
  if (M < 1 || E < 8 || E % 8 != 0 || V < k || k < 1 || k > MAX_K)
    return (int)cudaErrorInvalidValue;
  int want_bn, want_per, want_r;
  plan(M, V, k, &want_bn, &want_per, &want_r);
  if (bn != want_bn || per != want_per || R != want_r) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (k == 1)
    return launch<1>(h, w, bias, part_val, part_idx, part_ms, out_val, out_idx, out_lse, M, E,
                     V, k, per, R, st);
  if (k <= 4)
    return launch<4>(h, w, bias, part_val, part_idx, part_ms, out_val, out_idx, out_lse, M, E,
                     V, k, per, R, st);
  if (k <= 8)
    return launch<8>(h, w, bias, part_val, part_idx, part_ms, out_val, out_idx, out_lse, M, E,
                     V, k, per, R, st);
  return launch<16>(h, w, bias, part_val, part_idx, part_ms, out_val, out_idx, out_lse, M, E,
                    V, k, per, R, st);
}

// The merge of K2b (vocab-sharded project_topk; replaces the all_gather + top_k
// + logsumexp of imagetranslate_tpu/ops/topk_project.py:sharded_project_topk
// :305): the n shards of ascending vocab ranges are pass 2's ranges, read in
// the all_gather's layout. val, idx [n, M, k] (each list value descending,
// index ascending, indices already global), lse [n, M]; out [M, k], [M, k],
// [M]. The shards' (max, sum exp) are (lse, 1), so the lse is the logsumexp
// of the shard lses. Bound by its reads, n M (8 k + 4) bytes: microseconds.
extern "C" int itt_topk_merge(const void* val, const void* idx, const void* lse, void* out_val,
                              void* out_idx, void* out_lse, int M, int n, int k, void* stream) {
  if (M < 1 || n < 1 || n > 2 * MERGE_THREADS || k < 1 || k > MAX_K)
    return (int)cudaErrorInvalidValue;
  project_topk_merge<<<M, MERGE_THREADS, (size_t)n * k * 8,
                       reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(val), static_cast<const int*>(idx), k, (long long)M * k,
      static_cast<const float*>(lse), nullptr, 1, M, static_cast<float*>(out_val),
      static_cast<int*>(out_idx), static_cast<float*>(out_lse), k, n);
  return (int)cudaGetLastError();
}

extern "C" const char* itt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
