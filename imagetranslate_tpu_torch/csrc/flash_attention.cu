// Deterministic flash attention (forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of imagetranslate_tpu/ops/flash_attention.py
// (`_kernel` :47 behind `flash_attention` :97): softmax(Q K^T * scale + bias) V
// without dropout, with the online softmax over tiles of keys, so that the
// [T, S] scores never reach shared or device memory. Arithmetic as the TPU
// kernel's: q is scaled in fp32 and rounded to bf16; scores accumulate in fp32
// and take the fp32 bias; a running row maximum m (from -1e30) and denominator
// l; the fp32 accumulator is rescaled by exp(m_prev - m_cur); p = exp(s -
// m_cur) is rounded to bf16 un-normalised before the product with V; the
// division by l comes last. The bias is additive (-10000 at padded keys, never
// -inf), so a fully padded row gives finite, near-uniform weights.
//
// What bounds it: operations, twice over. At B=8, T=S=2048, H=12, D=64 the two
// products are 4 B H T S D = 103 GFLOP (0.104 ms at 989 TFLOP/s) over 101 MB of
// q, k, v and out (0.030 ms at 3.35 TB/s), and the B H T S = 403 M
// exponentials take about as long on the SFUs (16 a clock an SM). So the
// exponentials of one tile have to run while the tensor cores work on another.
// On the card the softmax side is the longer one (bias, max, exp, sum and the
// bf16 rounding of one tile take longer than its two products; PERF.md).
//
// Design. One block per (64 NC query rows, head, batch row), NC + 1
// warpgroups:
//   - a producer warp (warpgroup 0, registers lowered by setmaxnreg) loads the
//     query tile once and streams K and V tiles of TK = 128 keys through a ring
//     of STAGES slots by TMA, with full and empty mbarriers. The 4-D tensor
//     maps run over (D, H, T or S, B) of the [B, T, H, D] tensors as they lie,
//     so a ragged last tile is zero-filled by the hardware and never crosses
//     into the next batch row. Rows are 128 B (D = 64, 128: 128 B swizzle, D =
//     128 in two boxes along D) or 64 B (D = 32: 64 B swizzle). The bias slice
//     of a tile comes by 4-byte cp.async (its row stride need not be a
//     multiple of 16 bytes, which a tensor map needs) and completes on the
//     same full barrier;
//   - NC consumer warpgroups (3, or 2 at D = 128) own 64 query rows each
//     (wgmma's M). Each scales its query rows in shared memory once (every D
//     takes this one path; at D = 64 the scale 2^-3 would be exact in bf16
//     anyway, but for q below 2^-123), then runs both products on wgmma:
//     S = Q K^T (m64n128k16, Q and K K-major from shared memory) and O += P V
//     (m64nDk16, P from registers, V read MN-major through the transpose bit).
//   - Overlap: a warpgroup starts S of tile j and P V of tile j - 1 together
//     and waits for them; its softmax of tile j then waits for its turn
//     (named barriers 1 .. NC, round the warpgroups), so the softmaxes run one
//     after another, each with the SFUs to itself, and under each run the
//     other warpgroups' products.
// No atomics and a fixed order of keys: two launches give the same bits.
//
// Plain C interface, loaded with ctypes (imagetranslate_tpu_torch/ops/_build.py).
// The TMA, mbarrier and wgmma helpers are in hopper.cuh.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TK = 128;  // keys a tile (ops/flash_attention.py: BLOCK_K)

// Shared memory of a block, from a 1024-byte aligned base: Q | K ring | V ring
// | bias ring | mbarriers (Q's, then full and empty a slot).
template <int D>
struct Cfg {
  // Consumer warpgroups of 64 query rows each: three where their registers
  // allow (the softmax is the longer part of a tile, so more warps hide its
  // latencies), two at D = 128 (o takes 64 registers a thread).
  static constexpr int NC = D == 128 ? 2 : 3;
  static constexpr int TQ = 64 * NC;            // query rows a block
  static constexpr int THREADS = 128 * (NC + 1);  // and the producer warpgroup
  // setmaxnreg: producer * 128 + consumer * 128 NC <= 65536.
  static constexpr int PRODUCER_REGS = NC == 3 ? 24 : 40;
  static constexpr int CONSUMER_REGS = NC == 3 ? 160 : 232;
  static constexpr int DC = D < 64 ? D : 64;   // columns of a TMA box: one swizzle span
  static constexpr int RB = DC * 2;            // bytes of a box row
  static constexpr int CHUNKS = D / DC;        // boxes along D
  static constexpr int STAGES = 3;  // D = 128: 226.5 KB in all
  static constexpr uint32_t Q_BYTES = TQ * D * 2;
  static constexpr uint32_t KV_BYTES = TK * D * 2;
  static constexpr uint64_t LAYOUT = RB == 128 ? 1 : 2;  // wgmma descriptor: 128 B / 64 B swizzle
  static constexpr uint32_t ATOM = 8 * RB;               // eight rows of the swizzle pattern
  static constexpr uint32_t OFF_K = Q_BYTES;
  static constexpr uint32_t OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr uint32_t OFF_BIAS = OFF_V + STAGES * KV_BYTES;
  static constexpr uint32_t OFF_BAR = OFF_BIAS + STAGES * TK * 4;
  static constexpr uint32_t SMEM = OFF_BAR + (1 + 2 * STAGES) * 8 + 1024;  // + alignment
};

// 4 bytes global -> shared, zero-filled when `valid` is false (`src` must
// still be an address inside the tensor).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// One arrival on `bar` once this thread's cp.async copies so far have landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d[64, N] += A[64, 16] . B[16, N] (wgmma_ss_n128_first: d = A . B): wgmma_ss
// with A and B K-major in shared memory; wgmma_rs with A in registers (per warp the
// m16n8k16 A fragment of its 16 rows) and B MN-major in shared memory. Lane l
// = 4 g + t of warp w holds d[4 j + e] = element (16 w + g + 8 (e / 2),
// 8 j + 2 t + e % 2).
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC64(0)
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_n128_first(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : OUT64(0)
      : "l"(da), "l"(db), "r"(0));
}

__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : ACC16(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ACC64(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (D == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1)
flash_attn_fwd(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap, const float* __restrict__ bias,
               bf16* __restrict__ out, int T, int S, int H, long long bias_stride,
               float scale) {
  using C = Cfg<D>;
  constexpr int NC = C::NC, TQ = C::TQ;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = smem_u32(smem);
  const uint32_t bar_q = base + C::OFF_BAR;
  const int t0 = blockIdx.x * TQ, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (S + TK - 1) / TK;
  const bool has_bias = bias != nullptr;
  auto bar_full = [&](int st) { return bar_q + 8 + 8 * st; };
  auto bar_empty = [&](int st) { return bar_q + 8 + 8 * (C::STAGES + st); };

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < C::STAGES; ++st) {
      // The producer's expect_tx, and with a bias one cp.async arrival a lane.
      mbar_init(bar_full(st), has_bias ? 33 : 1);
      mbar_init(bar_empty(st), 4 * NC);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer. One warp loads; the other three have nothing to do.
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0) {
      mbar_expect_tx(bar_q, C::Q_BYTES);
      for (int ch = 0; ch < C::CHUNKS; ++ch)
        tma_load4(base + ch * TQ * C::RB, &qmap, bar_q, ch * C::DC, h, t0, b);
    }
    const float* brow = has_bias ? bias + (size_t)b * bias_stride : nullptr;
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % C::STAGES;
      mbar_wait(bar_empty(st), ((i / C::STAGES) & 1) ^ 1);
      if (has_bias) {
        const uint32_t dst = base + C::OFF_BIAS + st * TK * 4;
        for (int e = lane; e < TK; e += 32) {
          const int s = i * TK + e;
          cp_async4(dst + 4 * e, brow + (s < S ? s : 0), s < S);
        }
        cp_async_arrive(bar_full(st));
      }
      if (lane == 0) {
        mbar_expect_tx(bar_full(st), 2 * C::KV_BYTES);
        for (int ch = 0; ch < C::CHUNKS; ++ch) {
          const uint32_t off = st * C::KV_BYTES + ch * TK * C::RB;
          tma_load4(base + C::OFF_K + off, &kmap, bar_full(st), ch * C::DC, h, i * TK, b);
          tma_load4(base + C::OFF_V + off, &vmap, bar_full(st), ch * C::DC, h, i * TK, b);
        }
      }
      __syncwarp();
    }
    return;
  }

  // Consumers: warpgroup c owns query rows 64 c .. 64 c + 63 of the tile.
  setmaxnreg_inc<C::CONSUMER_REGS>();
  const int c = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  // Scale this warpgroup's query rows in fp32 and round them to bf16 in place
  // (elementwise, so the swizzle does not matter), then hand them to the
  // async proxy that wgmma reads through. Zero-filled rows past T stay zero.
  mbar_wait(bar_q, 0);
#pragma unroll
  for (int ch = 0; ch < C::CHUNKS; ++ch) {
    uint4* rows = reinterpret_cast<uint4*>(smem + ch * TQ * C::RB + c * 64 * C::RB);
    for (int i = tid; i < 64 * C::RB / 16; i += 128) {
      uint4 val = rows[i];
      bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(__bfloat162float(e[j]) * scale);
      rows[i] = val;
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  bar_sync(1 + NC + c, 128);
  // Turns at the softmax, round the warpgroups: barrier 1 + c is warpgroup
  // c's.
  const int my_turn = 1 + c, next_turn = 1 + (c + 1) % NC;
  if (c == NC - 1) bar_arrive(1, 256);  // warpgroup 0 goes first

  const uint32_t q_addr = base + c * 64 * C::RB;
  float o[D / 2], s[TK / 2];
  uint32_t p[TK / 16][4];
  constexpr float kLog2e = 1.4426950408889634f;
  float m_run[2] = {-1e30f, -1e30f}, ml_run[2] = {-1e30f * kLog2e, -1e30f * kLog2e};
  float l_part[2] = {0.0f, 0.0f}, corr[2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < TK / 16; ++i) p[i][0] = p[i][1] = p[i][2] = p[i][3] = 0u;

  // Descriptors of the tiles' first rows; a step adds its byte offset / 16
  // to the address field (which stays under 2^14: shared memory < 256 KB).
  const uint64_t q_desc = gmma_desc(q_addr, 16, C::ATOM, C::LAYOUT);
  const uint64_t k_desc = gmma_desc(base + C::OFF_K, 16, C::ATOM, C::LAYOUT);
  const uint64_t v_desc = gmma_desc(base + C::OFF_V, TK * C::RB, C::ATOM, C::LAYOUT);
  // s = q_scaled . K^T of the tile in slot st.
  auto start_s = [&](int st) {
    const uint32_t k_off = st * (C::KV_BYTES / 16);
    fence_regs(p);  // p of the last tile is read, s free to overwrite
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int ch = kk / (C::DC / 16), col = (kk % (C::DC / 16)) * 32;
      const uint64_t dq = q_desc + (ch * TQ * C::RB + col) / 16;
      const uint64_t dk = k_desc + k_off + (ch * TK * C::RB + col) / 16;
      if (kk == 0) wgmma_ss_n128_first(s, dq, dk);
      else wgmma_ss_n128(s, dq, dk);
    }
    wgmma_commit();
  };
  // o += p . V of the tile in slot st; V is [keys, D], MN-major (D
  // contiguous), 16 keys a step; along D the boxes lie TK * RB apart.
  auto start_pv = [&](int st) {
    const uint32_t v_off = st * (C::KV_BYTES / 16);
    fence_regs(o);
    fence_regs(p);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk)
      wgmma_rs<D>(o, p[kk], v_desc + v_off + kk * C::RB);
    wgmma_commit();
  };
  // Online softmax of rows g and g + 8 of this warp over the tile's scores;
  // keys past S take no part (a score of -1e30 gives p = 0, since the tile's
  // first key is real and bounds the maximum from below). s becomes p, fp32.
  auto softmax = [&](int st, int s0) {
    if (has_bias) {
      const float* bs = reinterpret_cast<const float*>(smem + C::OFF_BIAS + st * TK * 4);
#pragma unroll
      for (int j = 0; j < TK / 8; ++j) {
        const float2 bv = *reinterpret_cast<const float2*>(bs + 8 * j + 2 * t);
        s[4 * j] += bv.x; s[4 * j + 1] += bv.y;
        s[4 * j + 2] += bv.x; s[4 * j + 3] += bv.y;
      }
    }
    if (s0 + TK > S) {
#pragma unroll
      for (int j = 0; j < TK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (s0 + 8 * j + 2 * t + (e & 1) >= S) s[4 * j + e] = -1e30f;
    }
    // Row maxima and sums as trees: a running fold would be a chain of 32
    // dependent instructions a row.
    float sum[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float v[TK / 8];
#pragma unroll
      for (int j = 0; j < TK / 8; ++j) v[j] = fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]);
      float mx = fmaxf(m_run[r], tree_max(v));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // p = 2^(s log2(e) - m log2(e)): one FFMA and one MUFU.EX2 an element
      // (ex2.approx, relative error ~2^-22, vanishes in p's rounding to
      // bf16). corr takes the same rounded m log2(e), so the rounding of
      // that product cancels between tiles.
      const float ml = mx * kLog2e;
      corr[r] = ex2_ftz(ml_run[r] - ml);
      m_run[r] = mx;
      ml_run[r] = ml;
#pragma unroll
      for (int j = 0; j < TK / 8; ++j) {
        s[4 * j + 2 * r] = ex2_ftz(fmaf(s[4 * j + 2 * r], kLog2e, -ml));
        s[4 * j + 2 * r + 1] = ex2_ftz(fmaf(s[4 * j + 2 * r + 1], kLog2e, -ml));
        v[j] = s[4 * j + 2 * r] + s[4 * j + 2 * r + 1];
      }
      sum[r] = tree_sum(v);
    }
    // The lane's share of l; the quad's four shares are summed at the end.
    l_part[0] = l_part[0] * corr[0] + sum[0];
    l_part[1] = l_part[1] * corr[1] + sum[1];
  };
  // p rounded to bf16, where it lies: score blocks 2 kk and 2 kk + 1 are the A
  // fragment of the 16-key step kk.
  auto to_bf16 = [&]() {
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
  };
  auto rescale = [&]() {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
  };

  // Tile j: s of tile j and p . V of tile j - 1 are started together; the
  // softmax of tile j waits for this warpgroup's turn, so that the
  // warpgroups' softmaxes run one after another, each with the SFUs to
  // itself, while the others' products run on the tensor cores. Tile 0 has
  // no p . V before it (no branch between the starts: ptxas would wait for s
  // at one).
  mbar_wait(bar_full(0), 0);
  start_s(0);
  wgmma_wait<0>();
  fence_regs(s);
  bar_sync(my_turn, 256);
  softmax(0, 0);
  fence_regs(s);
  // Every bar_sync meets one arrival: the last warpgroup's first one came
  // before the loop, so its last turn passes none on.
  if (c != NC - 1 || n_tiles > 1) bar_arrive(next_turn, 256);
  to_bf16();
  for (int j = 1; j < n_tiles; ++j) {
    const int st = j % C::STAGES, prev = (j - 1) % C::STAGES;
    mbar_wait(bar_full(st), (j / C::STAGES) & 1);
    start_s(st);
    rescale();
    start_pv(prev);
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(o);
    if (lane == 0) mbar_arrive(bar_empty(prev));
    bar_sync(my_turn, 256);
    softmax(st, j * TK);
    fence_regs(s);
    if (c != NC - 1 || j < n_tiles - 1) bar_arrive(next_turn, 256);
    to_bf16();
  }
  rescale();
  start_pv((n_tiles - 1) % C::STAGES);
  wgmma_wait<0>();
  fence_regs(o);

  // out = o / l, two neighbouring columns a store; rows past T are not written.
  float l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = l_part[r] + __shfl_xor_sync(0xffffffffu, l_part[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = t0 + c * 64 + warp * 16 + g + 8 * r;
    if (row >= T) continue;
    bf16* dst = out + (((size_t)b * T + row) * H + h) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          pack_bf16(o[4 * j + 2 * r] / l[r], o[4 * j + 2 * r + 1] / l[r]);
  }
}


// A map over the [B, rows, H, D] bf16 tensor at `ptr` as dims (D, H, rows, B),
// boxes of (DC, 1, 128, 1) with the swizzle wgmma reads; out of bounds reads
// zeros.
template <int D>
int make_map(CUtensorMap* map, const void* ptr, int B, int rows, int H, int box_rows) {
  using C = Cfg<D>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)rows * H * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)C::DC, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
      elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      C::RB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* bias, void* out, int B,
           int T, int S, int H, long long bias_stride, float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap qmap, kmap, vmap;
  int err = make_map<D>(&qmap, q, B, T, H, C::TQ);
  if (err == 0) err = make_map<D>(&kmap, k, B, S, H, TK);
  if (err == 0) err = make_map<D>(&vmap, v, B, S, H, TK);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(flash_attn_fwd<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T + C::TQ - 1) / C::TQ, H, B);
  flash_attn_fwd<D><<<grid, C::THREADS, C::SMEM, stream>>>(
      qmap, kmap, vmap, static_cast<const float*>(bias), static_cast<bf16*>(out), T, S, H,
      bias_stride, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out [B, T, H, D]; k, v [B, S, H, D], bf16, contiguous, 16-byte aligned;
// bias null or fp32 with bias[b * bias_stride + s] the bias of key s in batch
// row b (4-byte aligned). D is 32, 64 or 128; heads and batch rows are the
// grid's y and z (at most 65535 each).
extern "C" int itt_flash_attn_fwd_bf16(const void* q, const void* k, const void* v,
                                       const void* bias, void* out, int B, int T, int S,
                                       int H, int D, long long bias_stride, float scale,
                                       void* stream) {
  if (B < 1 || T < 1 || S < 1 || H < 1 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(q, k, v, bias, out, B, T, S, H, bias_stride, scale, st);
    case 64: return launch<64>(q, k, v, bias, out, B, T, S, H, bias_stride, scale, st);
    case 128: return launch<128>(q, k, v, bias, out, B, T, S, H, bias_stride, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
