// Fused training attention with in-kernel dropout for Hopper (sm_90a): a
// flash-style forward and an FA2-style backward, every product on wgmma.
//
// Replaces the Pallas TPU kernels of imagetranslate_tpu/ops/train_attention.py
// (`_fwd_kernel` :60 behind `fused_dropout_attention` :242, and `_bwd_kernel`
// :86 behind `_bwd_rule` :256). Forward: softmax(Q K^T * scale + bias) in fp32,
// a Bernoulli keep-mask (keep iff 32 random bits >= threshold), kept probs
// divided by (1 - rate), times V. Backward: dv = drop(p)^T g, dp = g v^T masked
// and scaled, ds = p (dp - delta), dq = ds k * scale, dk = ds^T q * scale, and
// dbias = ds summed over heads (and over queries for a [B, 1, 1, S] bias). No
// [T, S] row exists anywhere: keys (forward, dq) or queries (dk/dv) stream
// through shared memory in tiles, and scores, probabilities and masks live in
// registers.
//
// What bounds it: operations and the mask, not bytes. At the MLM shape (B=16,
// T=S=512, H=12, D=64) the forward moves 50 MB (0.015 ms at 3.35 TB/s) for 12.9
// GFLOP (0.013 ms at 989 TFLOP/s) and draws 12.6 M Philox blocks, some 12
// integer instructions a score; the backward does 7 products, 45 GFLOP. On the
// card the instructions around the products (the mask, the softmax, the
// elementwise backward) and their latencies take longer than the products
// (PERF.md). So:
//   - one warpgroup a block owns 64 rows (wgmma's M), and two or three blocks
//     share an SM, so that one block's softmax runs under another's products;
//   - thread 0 streams the tiles by TMA (4-D tensor maps over the [B, L, H, D]
//     tensors as they lie, boxes of 64 or 32 rows, swizzled as wgmma reads
//     them: 128 B rows at D = 64 and 128 (two boxes along D), 64 B at D = 32,
//     32 B at D = 16; rows past T or S are zero-filled) into a ring of slots
//     with one full mbarrier each, and refills a slot once the warpgroup has
//     passed its products;
//   - S = Q K^T and dP = dO V^T are wgmma with both operands K-major in shared
//     memory; P V, dS K, P^T dO and dS^T Q take P or dS from registers (the
//     accumulator of the first product, rounded to bf16, is the A fragment of
//     the second) and read the right operand MN-major through the transpose
//     bit;
//   - the forward draws a tile's Philox bits while that tile's Q K^T and the
//     last tile's P V run on the tensor cores (the first tile's while Q, K
//     and V load), with the round keys scheduled on the host, and draws each
//     bit once a step: when a backward follows, it writes the keep bits, 32
//     keys to a word, [B, H, T, W] with W = ceil(S / 32) rounded up to four
//     words (16 bytes, a TMA stride), and the backward reads them instead of
//     drawing them again;
//   - a tile's bias is loaded as soon as the last one's is spent, so that its
//     latency passes under the products.

// Forward (a block per (64 queries, head, batch row), keys in tiles of 64): an
// online softmax with a running maximum m and sum l. l sums every
// probability, the accumulator only the kept ones; p = exp(x - m) is rounded
// to bf16 un-normalised before the product with V, and the division by l and
// by 1 - rate comes last. The forward also writes each row's logsumexp in two
// parts, (m, log l): at the -10000 of a fully masked row one fp32 lse would
// round to 2^-10 and shift every recomputed p by ~0.05 %.
//
// Backward, two kernels and no atomics. The dq kernel (a block per 64
// queries) takes delta = rowsum(g o) over the bf16 output in fp32 (under
// dropout sum_j p_j keep_j / (1 - rate) (g . v_j) = g . o, as without), then
// walks the key tiles once: S and dP recomputed, ds = p (dp - delta), dQ +=
// dS K; it writes delta for the dk/dv kernel. Where dbias is asked for, delta
// has to be exact for dbias's 1e-4 tolerance, and the dq kernel walks the
// keys twice: the first pass sums delta = rowsum(p dp) in fp32. The dk/dv
// kernel (a block per 64 keys) walks the query tiles (32 queries: with 64,
// S^T, dP^T and their fragments beside dK and dV take 217 registers and two
// blocks an SM; with 32, three blocks fit, which was faster on the card),
// each with its Q, dO, keep bits, row statistics and delta by TMA, and keeps
// dK and dV in registers to the end. ds and drop(p)
// enter the products as one bf16 pass (the TPU kernel contracts in fp32; the
// rounding is ~2^-9 of a term, inside the 2^-6 tolerance at S = 512).
//
// The mask is a pure function of (seed, b, h, t, s): Philox-4x32-10 keyed on
// the 64-bit seed with the counter (s / 4, t, h, b), word s % 4 of its four
// outputs, as the plain PyTorch version (ops/train_attention.py) draws it; the
// kernels are held against it element by element.
//
// dbias: per-head partials (ds itself for a [B, 1, T, S] bias, from the dq
// kernel; the column sums over queries for [B, 1, 1, S], from the dk/dv
// kernel), then a third kernel sums the heads in ascending order, so dbias is
// bit-reproducible. They run only when the caller asks for dbias (the model's
// biases come from masks and need none).
//
// Plain C interface, loaded with ctypes (imagetranslate_tpu_torch/ops/_build.py).
// The TMA, mbarrier and wgmma helpers are in hopper.cuh.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TM = 64;            // rows a block's warpgroup owns: wgmma's M
constexpr int TK = 64;            // keys a tile
constexpr int THREADS = 128;      // one warpgroup
constexpr int MAX_S = 512;        // the gate's (and the TPU kernel's) longest key axis
constexpr int MAX_W = MAX_S / 32;  // words of a row of keep bits at most
constexpr float MASKED = -1e30f;  // score of a key past S: p = 0
constexpr float LOG2E = 1.4426950408889634f;

struct Dims {
  int B, T, S, H;
  int W;          // words a row of keep bits: ceil(S / 32) rounded up to 4
  int Tp;         // row stride of the (m, log l) statistics and delta: T rounded up to 4
  int bias_rows;  // 1: bias [B, 1, T, S]; 0: bias [B, 1, 1, S]
};

// A tile of `rows` rows of a [.., D] bf16 tensor in shared memory, as TMA
// writes it: D / DC boxes of [rows, DC], each row RB bytes, swizzled.
template <int D>
struct Geo {
  static constexpr int DC = D < 64 ? D : 64;
  static constexpr int RB = 2 * DC;
  static constexpr int CHUNKS = D / DC;
  static constexpr uint64_t LAYOUT = RB == 128 ? 1 : RB == 64 ? 2 : 3;  // 128, 64, 32 B swizzle
  static constexpr uint32_t ATOM = 8 * RB;  // eight rows of the swizzle pattern
  static constexpr uint32_t bytes(int rows) { return (uint32_t)rows * D * 2; }
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// ---------------------------------------------------------------- Philox

// The mask's key: the ten rounds' key pairs of Philox-4x32-10, scheduled on
// the host (a kernel parameter: the rounds read them from the constant bank),
// and the 32-bit keep threshold (0: rate 0, every probability kept).
struct MaskKey {
  uint32_t round[10][2];
  uint32_t threshold;
};

__device__ __forceinline__ uint4 philox4x32_10(uint32_t c0, uint32_t c1, uint32_t c2,
                                               uint32_t c3, const MaskKey& key) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint64_t p0 = (uint64_t)0xD2511F53u * c0, p1 = (uint64_t)0xCD9E8D57u * c2;
    const uint32_t n0 = (uint32_t)(p1 >> 32) ^ c1 ^ key.round[i][0];
    const uint32_t n2 = (uint32_t)(p0 >> 32) ^ c3 ^ key.round[i][1];
    c1 = (uint32_t)p1; c3 = (uint32_t)p0; c0 = n0; c2 = n2;
  }
  return make_uint4(c0, c1, c2, c3);
}

// Bit w of the result: word w of the block at counter (group, t, h, b) is kept.
__device__ __forceinline__ uint32_t keep_nibble(uint32_t group, uint32_t t, uint32_t h,
                                                uint32_t b, const MaskKey& key) {
  const uint4 r = philox4x32_10(group, t, h, b, key);
  return (r.x >= key.threshold ? 1u : 0u) | (r.y >= key.threshold ? 2u : 0u) |
         (r.z >= key.threshold ? 4u : 0u) | (r.w >= key.threshold ? 8u : 0u);
}

// The keep bits of a warp's [16 rows, 64 keys] slice of the accumulator:
// lane 4 g + t holds rows g (e = 0, 1) and g + 8 (e = 2, 3) at keys 8 j + 2 t
// + (e & 1); bit 4 j + e of the result is element (j, e). Keys 8 j + 2 t, + 1
// are words 2 (t & 1), + 1 of the block at group 2 j + t / 2, which lanes t
// and t ^ 1 share: the even lane draws row g's block, the odd one row g + 8's,
// and one shuffle trades the halves.
//
// `word` receives the same bits as the backward reads them: lane t's word is
// keys s0 + 32 (t / 2) .. + 31 of row g + 8 (t % 2), bit i key s0 + 32 (t / 2)
// + i, keys at or past S cleared. A lane's blocks are keys 8 j + 4 (t / 2) ..
// + 3 of its row, so its nibbles spread to bytes make half of two words, and
// lane t ^ 2 holds the other half: one more shuffle.
__device__ __forceinline__ uint32_t draw_keep(int row0, int s0, int h, int b, int S,
                                              const MaskKey& key, uint32_t& word) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, odd = t & 1;
  const uint32_t row = (uint32_t)(row0 + g + 8 * odd);
  uint32_t own = 0u;
#pragma unroll
  for (int j = 0; j < TK / 8; ++j)
    own |= keep_nibble((uint32_t)(s0 / 4 + 2 * j + (t >> 1)), row, h, b, key) << (4 * j);
  uint32_t half[2];  // nibble j of a word's four at byte j, this lane's half of each byte
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    uint32_t x = (own >> (16 * hf)) & 0xFFFFu;
    x = (x | (x << 8)) & 0x00FF00FFu;
    half[hf] = ((x | (x << 4)) & 0x0F0F0F0Fu) << (4 * (t >> 1));
  }
  const int mine = t >> 1;
  word = half[mine] | __shfl_xor_sync(0xffffffffu, half[mine ^ 1], 2);
  const int left = S - (s0 + 32 * mine);  // keys of the word below S
  if (left < 32) word = left <= 0 ? 0u : word & ((1u << left) - 1u);
  const uint32_t other = __shfl_xor_sync(0xffffffffu, own, 1);
  const uint32_t top = odd ? other : own, bottom = odd ? own : other;  // rows g, g + 8
  const int sh = 2 * odd;
  return ((top >> sh) & 0x33333333u) | (((bottom >> sh) & 0x33333333u) << 2);
}

// ---------------------------------------------------------------- wgmma

// d[64, N] (+)= A[64, 16] . B[16, N]. wgmma_ss: A and B K-major in shared
// memory (_first: d = A . B); wgmma_rs: A in registers (per warp the m16n8k16
// A fragment of its 16 rows), B MN-major in shared memory. Lane l = 4 g + t of
// warp w holds d[4 j + e] = element (16 w + g + 8 (e / 2), 8 j + 2 t + e % 2).
__device__ __forceinline__ void wgmma_ss_n32_first(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : OUT16(0)
      : "l"(da), "l"(db), "r"(0));
}

__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : ACC16(0)
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_n64_first(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : OUT32(0)
      : "l"(da), "l"(db), "r"(0));
}

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC32(0)
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : ACC8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : ACC16(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ACC64(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, bool first) {
  if constexpr (N == 32) { if (first) wgmma_ss_n32_first(d, da, db); else wgmma_ss_n32(d, da, db); }
  else { if (first) wgmma_ss_n64_first(d, da, db); else wgmma_ss_n64(d, da, db); }
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 16) wgmma_rs_n16(d, a, db);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

// acc[64, N] = A[64, D] . B[N, D]^T: A a 64-row tile at `a`, B an N-row tile
// at `b`, both K-major. A step of 16 columns moves 32 bytes along a row, or
// to the next box of DC columns. Issues; the caller fences and commits.
template <int D, int N>
__device__ __forceinline__ void mma_abt(float (&acc)[N / 2], uint32_t a, uint32_t b) {
  using G = Geo<D>;
  constexpr int PER = G::DC / 16;
  const uint64_t da = gmma_desc(a, 16, G::ATOM, G::LAYOUT);
  const uint64_t db = gmma_desc(b, 16, G::ATOM, G::LAYOUT);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk % PER) * 32;
    wgmma_ss<N>(acc, da + ((kk / PER) * TM * G::RB + col) / 16,
                db + ((kk / PER) * N * G::RB + col) / 16, kk == 0);
  }
}

// acc[64, D] += P[64, 16 KS] . B[16 KS, D]: P as KS A fragments in registers,
// B a (16 KS)-row tile at `b` read MN-major (the boxes along D lie 16 KS RB
// bytes apart, the leading offset; eight rows the stride offset).
template <int D, int KS>
__device__ __forceinline__ void mma_pb(float (&acc)[D / 2], const uint32_t (&p)[KS][4],
                                       uint32_t b) {
  using G = Geo<D>;
  const uint64_t db = gmma_desc(b, 16 * KS * G::RB, G::ATOM, G::LAYOUT);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) wgmma_rs<D>(acc, p[kk], db + kk * G::RB);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// An fp32 accumulator [64, 16 KS] rounded to bf16 where it lies: its column
// blocks 2 kk and 2 kk + 1 are the A fragment of the 16-deep step kk.
template <int KS>
__device__ __forceinline__ void to_frags(uint32_t (&a)[KS][4], const float (&s)[8 * KS]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
}

// ---------------------------------------------------------------- bias

// The bias of a thread's accumulator elements over keys [s0, s0 + 64): rows
// row0 + g, + 8 (a [B, 1, T, S] bias; rows past T read as 0) or one row (a
// [B, 1, 1, S] bias) at columns s0 + 8 j + 2 t, + 1; keys past S read as 0.
// `brow` is the batch row's bias.
__device__ __forceinline__ void load_bias(float (&bv)[TK / 2], const float* __restrict__ brow,
                                          const Dims& d, int row0, int s0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool vec = (d.S & 1) == 0;  // float2 loads stay aligned
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    const float* src = d.bias_rows ? (row < d.T ? brow + (size_t)row * d.S : nullptr) : brow;
#pragma unroll
    for (int j = 0; j < TK / 8; ++j) {
      const int col = s0 + 8 * j + 2 * t;
      float2 v = make_float2(0.0f, 0.0f);
      if (src != nullptr) {
        if (vec && col + 1 < d.S) {
          v = __ldg(reinterpret_cast<const float2*>(src + col));
        } else {
          if (col < d.S) v.x = __ldg(src + col);
          if (col + 1 < d.S) v.y = __ldg(src + col + 1);
        }
      }
      bv[4 * j + 2 * r] = v.x;
      bv[4 * j + 2 * r + 1] = v.y;
    }
  }
}

// x = score * scale + bias over a [64, 64] accumulator, keys past S pushed
// to MASKED.
__device__ __forceinline__ void scores(float (&s)[TK / 2], const float (&bv)[TK / 2], int s0,
                                       int S, float scale) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < TK / 2; ++i) s[i] = fmaf(s[i], scale, bv[i]);
  if (s0 + TK > S) {
#pragma unroll
    for (int j = 0; j < TK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (s0 + 8 * j + 2 * t + (e & 1) >= S) s[4 * j + e] = MASKED;
  }
}

// ---------------------------------------------------------------- forward

template <int D>
struct Fwd {
  static constexpr int STAGES = D == 128 ? 2 : 3;   // K and V slots
  static constexpr uint32_t TILE = Geo<D>::bytes(64);
  static constexpr uint32_t OFF_K = TILE;           // Q | K slots | V slots | mbarriers
  static constexpr uint32_t OFF_V = OFF_K + STAGES * TILE;
  static constexpr uint32_t OFF_BAR = OFF_V + STAGES * TILE;
  static constexpr uint32_t SMEM = OFF_BAR + (1 + STAGES) * 8 + 1024;  // + alignment
};

template <int D>
__global__ void __launch_bounds__(THREADS, D == 128 ? 2 : 3)
attn_fwd(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
         const __grid_constant__ CUtensorMap vmap, const float* __restrict__ bias,
         bf16* __restrict__ out, float2* __restrict__ stats, uint32_t* __restrict__ bits,
         Dims d, float scale, float inv_keep, const __grid_constant__ MaskKey key) {
  using C = Fwd<D>;
  using G = Geo<D>;
  constexpr int ST = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = smem_u32(align1024(smem_raw));
  const uint32_t bar_q = base + C::OFF_BAR;
  auto bar_full = [&](int st) { return bar_q + 8 + 8 * st; };
  const int t0 = blockIdx.x * TM, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int n_tiles = (d.S + TK - 1) / TK;
  const bool drop = key.threshold > 0u;

  auto load_kv = [&](int i) {  // key tile i into slot i % ST
    const int st = i % ST;
    mbar_expect_tx(bar_full(st), 2 * C::TILE);
#pragma unroll
    for (int ch = 0; ch < G::CHUNKS; ++ch) {
      const uint32_t off = st * C::TILE + ch * TK * G::RB;
      tma_load4(base + C::OFF_K + off, &kmap, bar_full(st), ch * G::DC, h, i * TK, b);
      tma_load4(base + C::OFF_V + off, &vmap, bar_full(st), ch * G::DC, h, i * TK, b);
    }
  };
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < ST; ++st) mbar_init(bar_full(st), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, C::TILE);
#pragma unroll
    for (int ch = 0; ch < G::CHUNKS; ++ch)
      tma_load4(base + ch * TM * G::RB, &qmap, bar_q, ch * G::DC, h, t0, b);
    for (int i = 0; i < ST && i < n_tiles; ++i) load_kv(i);
  }

  const int row0 = t0 + 16 * warp;  // the warp's 16 rows: row0 + g, + 8
  const float* brow = bias + (size_t)b * (d.bias_rows ? (size_t)d.T * d.S : (size_t)d.S);
  float o[D / 2], s[TK / 2], bv[TK / 2];
  uint32_t p[TK / 16][4];
  float m_run[2] = {MASKED, MASKED}, l_part[2] = {0.0f, 0.0f}, corr[2] = {1.0f, 1.0f};
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < TK / 16; ++i) p[i][0] = p[i][1] = p[i][2] = p[i][3] = 0u;

  auto start_s = [&](int st) {
    fence_regs(p);
    wgmma_fence();
    mma_abt<D, TK>(s, base, base + C::OFF_K + st * C::TILE);
    wgmma_commit();
  };
  auto start_pv = [&](int st) {
    fence_regs(o);
    fence_regs(p);
    wgmma_fence();
    mma_pb<D, TK / 16>(o, p, base + C::OFF_V + st * C::TILE);
    wgmma_commit();
  };
  auto rescale = [&]() {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
  };
  // The tile's keep bits from Philox, drawn while its products run (and
  // the first tile's while Q, K and V are on their way).
  uint32_t word = 0u;
  auto draw = [&](int s0) {
    uint32_t keep = drop ? draw_keep(row0, s0, h, b, d.S, key, word) : 0xffffffffu;
    asm volatile("" : "+r"(keep));  // drawn here, under the products
    return keep;
  };
  // The online softmax of rows g and g + 8 over the tile; s becomes the kept
  // p as bf16 fragments. exp(x - m) is ex2((x - m) log2 e) on the SFU
  // (relative error ~2^-22, vanishes in p's rounding to bf16). The next
  // tile's bias is loaded as soon as this one's is spent, so that it lands
  // while the next products run.
  auto softmax = [&](uint32_t keep, int s0) {
    scores(s, bv, s0, d.S, scale);
    if (s0 + TK < d.S) load_bias(bv, brow, d, row0, s0 + TK);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float v[TK / 8];
#pragma unroll
      for (int j = 0; j < TK / 8; ++j) v[j] = fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]);
      float mx = fmaxf(m_run[r], tree_max(v));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      corr[r] = ex2_ftz((m_run[r] - mx) * LOG2E);
      m_run[r] = mx;
#pragma unroll
      for (int j = 0; j < TK / 8; ++j) {
        float pr[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * r + e;
          pr[e] = ex2_ftz((s[i] - mx) * LOG2E);
          s[i] = ((keep >> i) & 1u) ? pr[e] : 0.0f;  // only the kept ones go on
        }
        v[j] = pr[0] + pr[1];                        // every probability
      }
      l_part[r] = l_part[r] * corr[r] + tree_sum(v);
    }
    to_frags(p, s);
    if (bits != nullptr) {
      const int row = row0 + g + 8 * (t & 1);
      if (row < d.T) bits[(((size_t)b * d.H + h) * d.T + row) * d.W + s0 / 32 + (t >> 1)] = word;
    }
  };

  // Tile j: Q K^T of tile j and P V of tile j - 1 are started together, and
  // the tile's mask is drawn under them. Tile 0 has no P V before it (no
  // branch between the starts: ptxas would wait for s at one).
  load_bias(bv, brow, d, row0, 0);
  uint32_t keep = draw(0);
  mbar_wait(bar_q, 0);
  mbar_wait(bar_full(0), 0);
  start_s(0);
  wgmma_wait<0>();
  fence_regs(s);
  softmax(keep, 0);
  for (int j = 1; j < n_tiles; ++j) {
    const int st = j % ST, prev = (j - 1) % ST;
    mbar_wait(bar_full(st), (j / ST) & 1);
    start_s(st);
    rescale();
    start_pv(prev);
    keep = draw(j * TK);
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(o);
    if (j - 1 + ST < n_tiles) {  // slot prev is free once every warp is past it
      bar_sync(1, THREADS);
      if (tid == 0) load_kv(j - 1 + ST);
    }
    softmax(keep, j * TK);
  }
  rescale();
  start_pv((n_tiles - 1) % ST);
  wgmma_wait<0>();
  fence_regs(o);

  // out = o / l / (1 - rate); rows past T are not written.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_part[r] + __shfl_xor_sync(0xffffffffu, l_part[r], 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = row0 + g + 8 * r;
    if (row >= d.T) continue;
    const float f = inv_keep / l;
    bf16* dst = out + (((size_t)b * d.T + row) * d.H + h) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) = pack_bf16(o[4 * j + 2 * r] * f, o[4 * j + 2 * r + 1] * f);
    if (t == 0) stats[((size_t)b * d.H + h) * d.Tp + row] = make_float2(m_run[r], logf(l));
  }
}

// ---------------------------------------------------------------- backward: dq and delta

template <int D>
struct Dq {
  static constexpr int STAGES = 2;
  static constexpr uint32_t TILE = Geo<D>::bytes(64);
  static constexpr uint32_t OFF_G = TILE;           // Q | dO | keep bits | K slots | V slots | mbarriers
  static constexpr uint32_t OFF_BITS = 2 * TILE;
  static constexpr uint32_t OFF_K = OFF_BITS + TM * MAX_W * 4;
  static constexpr uint32_t OFF_V = OFF_K + STAGES * TILE;
  static constexpr uint32_t OFF_BAR = OFF_V + STAGES * TILE;
  static constexpr uint32_t SMEM = OFF_BAR + (1 + STAGES) * 8 + 1024;
};

// EXACT: delta = rowsum(p dp) in a first pass over the keys (dbias wanted);
// else delta = rowsum(g o) from the output.
template <int D, bool EXACT>
__global__ void __launch_bounds__(THREADS, D == 128 ? 2 : 3)
attn_bwd_dq(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap gmap,
            const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
            const __grid_constant__ CUtensorMap bmap, const float* __restrict__ bias,
            const bf16* __restrict__ gr, const bf16* __restrict__ out,
            const float2* __restrict__ stats, float* __restrict__ delta, bf16* __restrict__ dq,
            float* __restrict__ db_part,  // [B, H, T, S] for a [B, 1, T, S] bias, else null
            Dims d, float scale, float inv_keep, int has_bits) {
  using C = Dq<D>;
  using G = Geo<D>;
  constexpr int ST = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t bar_q = base + C::OFF_BAR;
  auto bar_full = [&](int st) { return bar_q + 8 + 8 * st; };
  const int t0 = blockIdx.x * TM, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int n_tiles = (d.S + TK - 1) / TK;
  const int n_iter = EXACT ? 2 * n_tiles : n_tiles;  // EXACT: the keys twice

  auto load_kv = [&](int i) {  // iteration i's key tile into slot i % ST
    const int st = i % ST, kt = i % n_tiles;
    mbar_expect_tx(bar_full(st), 2 * C::TILE);
#pragma unroll
    for (int ch = 0; ch < G::CHUNKS; ++ch) {
      const uint32_t off = st * C::TILE + ch * TK * G::RB;
      tma_load4(base + C::OFF_K + off, &kmap, bar_full(st), ch * G::DC, h, kt * TK, b);
      tma_load4(base + C::OFF_V + off, &vmap, bar_full(st), ch * G::DC, h, kt * TK, b);
    }
  };
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < ST; ++st) mbar_init(bar_full(st), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, 2 * C::TILE + (has_bits ? TM * d.W * 4 : 0));
#pragma unroll
    for (int ch = 0; ch < G::CHUNKS; ++ch) {
      tma_load4(base + ch * TM * G::RB, &qmap, bar_q, ch * G::DC, h, t0, b);
      tma_load4(base + C::OFF_G + ch * TM * G::RB, &gmap, bar_q, ch * G::DC, h, t0, b);
    }
    if (has_bits) tma_load3(base + C::OFF_BITS, &bmap, bar_q, 0, t0, b * d.H + h);
    for (int i = 0; i < ST && i < n_iter; ++i) load_kv(i);
  }

  const int row0 = t0 + 16 * warp;
  const float* brow = bias + (size_t)b * (d.bias_rows ? (size_t)d.T * d.S : (size_t)d.S);
  float st_m[2], st_l[2], dsum[2] = {0.0f, 0.0f};  // rows g, g + 8: m, log2(l), delta
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    const float2 mv = row < d.T ? stats[((size_t)b * d.H + h) * d.Tp + row] : make_float2(0.f, 0.f);
    st_m[r] = mv.x;
    st_l[r] = mv.y * LOG2E;
  }
  if constexpr (!EXACT) {
    // delta = rowsum(g o): the quad's four lanes take D / 4 columns each.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g + 8 * r;
      float acc = 0.0f;
      if (row < d.T) {
        const size_t at = (((size_t)b * d.T + row) * d.H + h) * D + t * (D / 4);
        const uint2* gp = reinterpret_cast<const uint2*>(gr + at);
        const uint2* op = reinterpret_cast<const uint2*>(out + at);
#pragma unroll
        for (int c = 0; c < D / 16; ++c) {
          const uint2 gv = __ldg(gp + c), ov = __ldg(op + c);
          const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
          const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float2 a = __bfloat1622float2(g2[e]), c2 = __bfloat1622float2(o2[e]);
            acc = fmaf(a.x, c2.x, acc);
            acc = fmaf(a.y, c2.y, acc);
          }
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      dsum[r] = acc;
      if (t == 0 && row < d.T) delta[((size_t)b * d.H + h) * d.Tp + row] = acc;
    }
  }

  float acc[D / 2], s[TK / 2], dp[TK / 2], bv[TK / 2];
  uint32_t pa[TK / 16][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < TK / 16; ++i) pa[i][0] = pa[i][1] = pa[i][2] = pa[i][3] = 0u;
  const uint32_t* kbits = reinterpret_cast<const uint32_t*>(smem + C::OFF_BITS);

  // A tile's bias is loaded as soon as the previous one's is spent, so that
  // it lands while the products run.
  load_bias(bv, brow, d, row0, 0);
  mbar_wait(bar_q, 0);
  for (int it = 0; it < n_iter; ++it) {
    const int st = it % ST, kt = it % n_tiles, s0 = kt * TK;
    const bool first = EXACT && it < n_tiles;  // the pass that sums delta
    mbar_wait(bar_full(st), (it / ST) & 1);
    fence_regs(pa);
    wgmma_fence();
    mma_abt<D, TK>(s, base, base + C::OFF_K + st * C::TILE);
    mma_abt<D, TK>(dp, base + C::OFF_G, base + C::OFF_V + st * C::TILE);
    wgmma_commit();
    // The keep words of rows g, g + 8 over the tile, shifted to this lane's
    // keys: bit 8 (j % 4) + e of word j / 4 is element (j, 2 r + e).
    uint32_t kw[2][2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      uint2 w = make_uint2(0xffffffffu, 0xffffffffu);
      if (has_bits)
        w = *reinterpret_cast<const uint2*>(kbits + (16 * warp + g + 8 * r) * d.W + 2 * kt);
      kw[r][0] = w.x >> (2 * t);
      kw[r][1] = w.y >> (2 * t);
    }
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    fence_regs(acc);
    if (it >= 1 && it - 1 + ST < n_iter) {
      bar_sync(1, THREADS);
      if (tid == 0) load_kv(it - 1 + ST);
    }
    scores(s, bv, s0, d.S, scale);
    if (it + 1 < n_iter) load_bias(bv, brow, d, row0, ((it + 1) % n_tiles) * TK);
#pragma unroll
    for (int j = 0; j < TK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e, r = e >> 1;
        const float p = ex2_ftz(fmaf(s[i] - st_m[r], LOG2E, -st_l[r]));
        const bool kept = (kw[r][j >> 2] >> (8 * (j & 3) + (e & 1))) & 1u;
        const float dpm = kept ? dp[i] * inv_keep : 0.0f;
        if (first) dsum[r] += p * dpm;
        else s[i] = p * (dpm - dsum[r]);  // ds
      }
    if (first) {
      if (it == n_tiles - 1) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          dsum[r] += __shfl_xor_sync(0xffffffffu, dsum[r], 1);
          dsum[r] += __shfl_xor_sync(0xffffffffu, dsum[r], 2);
          const int row = row0 + g + 8 * r;
          if (t == 0 && row < d.T) delta[((size_t)b * d.H + h) * d.Tp + row] = dsum[r];
        }
      }
      continue;
    }
    if (db_part != nullptr) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + g + 8 * r;
        if (row >= d.T) continue;
        float* dst = db_part + (((size_t)b * d.H + h) * d.T + row) * d.S;
#pragma unroll
        for (int j = 0; j < TK / 8; ++j) {
          const int col = s0 + 8 * j + 2 * t;
          if (col < d.S) dst[col] = s[4 * j + 2 * r];
          if (col + 1 < d.S) dst[col + 1] = s[4 * j + 2 * r + 1];
        }
      }
    }
    to_frags(pa, s);
    fence_regs(pa);
    fence_regs(acc);
    wgmma_fence();
    mma_pb<D, TK / 16>(acc, pa, base + C::OFF_K + st * C::TILE);  // dQ += dS K
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(acc);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= d.T) continue;
    bf16* dst = dq + (((size_t)b * d.T + row) * d.H + h) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          pack_bf16(acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
  }
}

// ---------------------------------------------------------------- backward: dk and dv

template <int D>
struct Dkv {
  static constexpr int TQ = 32;  // queries a tile: 32 keep three blocks an SM in registers
  static constexpr int STAGES = 2;
  static constexpr uint32_t KV_TILE = Geo<D>::bytes(64);
  static constexpr uint32_t Q_TILE = Geo<D>::bytes(TQ);
  // A slot: Q | dO | keep bits [TQ, W] | (m, log l) [TQ] | delta [TQ].
  static constexpr uint32_t SLOT_G = Q_TILE;
  static constexpr uint32_t SLOT_BITS = 2 * Q_TILE;
  static constexpr uint32_t SLOT_STATS = SLOT_BITS + TQ * MAX_W * 4;
  static constexpr uint32_t SLOT_DELTA = SLOT_STATS + TQ * 8;
  static constexpr uint32_t SLOT = (SLOT_DELTA + TQ * 4 + 1023) / 1024 * 1024;
  static constexpr uint32_t OFF_V = KV_TILE;        // K | V | slots | mbarriers
  static constexpr uint32_t OFF_SLOTS = 2 * KV_TILE;
  static constexpr uint32_t OFF_BAR = OFF_SLOTS + STAGES * SLOT;
  static constexpr uint32_t SMEM = OFF_BAR + (1 + STAGES) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(THREADS, D == 128 ? 2 : 3)
attn_bwd_dkdv(const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
              const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap gmap,
              const __grid_constant__ CUtensorMap bmap, const __grid_constant__ CUtensorMap smap,
              const __grid_constant__ CUtensorMap dmap, const float* __restrict__ bias,
              bf16* __restrict__ dk, bf16* __restrict__ dv,
              float* __restrict__ db_part,  // [B, H, S] for a [B, 1, 1, S] bias, else null
              Dims d, float scale, float inv_keep, int has_bits) {
  using C = Dkv<D>;
  using G = Geo<D>;
  constexpr int ST = C::STAGES, TQ = C::TQ, NQ = TQ / 8;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t bar_kv = base + C::OFF_BAR;
  auto bar_full = [&](int st) { return bar_kv + 8 + 8 * st; };
  const int s0 = blockIdx.x * TK, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int n_tiles = (d.T + TQ - 1) / TQ;
  const uint32_t slot_bytes = 2 * C::Q_TILE + (has_bits ? TQ * d.W * 4 : 0) + TQ * 12;

  auto load_q = [&](int i) {  // query tile i into slot i % ST
    const int st = i % ST, q0 = i * TQ;
    const uint32_t at = base + C::OFF_SLOTS + st * C::SLOT;
    mbar_expect_tx(bar_full(st), slot_bytes);
#pragma unroll
    for (int ch = 0; ch < G::CHUNKS; ++ch) {
      tma_load4(at + ch * TQ * G::RB, &qmap, bar_full(st), ch * G::DC, h, q0, b);
      tma_load4(at + C::SLOT_G + ch * TQ * G::RB, &gmap, bar_full(st), ch * G::DC, h, q0, b);
    }
    if (has_bits) tma_load3(at + C::SLOT_BITS, &bmap, bar_full(st), 0, q0, b * d.H + h);
    tma_load2(at + C::SLOT_STATS, &smap, bar_full(st), 2 * q0, b * d.H + h);
    tma_load2(at + C::SLOT_DELTA, &dmap, bar_full(st), q0, b * d.H + h);
  };
  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int st = 0; st < ST; ++st) mbar_init(bar_full(st), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_kv, 2 * C::KV_TILE);
#pragma unroll
    for (int ch = 0; ch < G::CHUNKS; ++ch) {
      tma_load4(base + ch * TK * G::RB, &kmap, bar_kv, ch * G::DC, h, s0, b);
      tma_load4(base + C::OFF_V + ch * TK * G::RB, &vmap, bar_kv, ch * G::DC, h, s0, b);
    }
    for (int i = 0; i < ST && i < n_tiles; ++i) load_q(i);
  }

  // Keys 16 warp + g + 8 r of the block; their keep bits are bits sh and sh
  // + 8 of word (s0 + 32 (warp / 2)) / 32 of a query's row.
  const int key0 = s0 + 16 * warp + g;
  const bool live[2] = {key0 < d.S, key0 + 8 < d.S};
  const int word = s0 / 32 + (warp >> 1), sh = 16 * (warp & 1) + g;
  float kb[2] = {0.0f, 0.0f};  // a [B, 1, 1, S] bias of the two keys
  if (!d.bias_rows) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (live[r]) kb[r] = __ldg(bias + (size_t)b * d.S + key0 + 8 * r);
  }
  const float* bmat = bias + (size_t)b * d.T * d.S;  // [B, 1, T, S]

  float ak[D / 2], av[D / 2], sT[TQ / 2], dpT[TQ / 2], bv[TQ / 2];
  uint32_t pa[TQ / 16][4], da[TQ / 16][4];
  float colsum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < D / 2; ++i) ak[i] = av[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < TQ / 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) pa[i][e] = da[i][e] = 0u;

  mbar_wait(bar_kv, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % ST, q0 = it * TQ;
    const uint32_t at = base + C::OFF_SLOTS + st * C::SLOT;
    mbar_wait(bar_full(st), (it / ST) & 1);
    // S^T = K Q^T and dP^T = V dO^T over this tile's queries.
    fence_regs(pa);
    fence_regs(da);
    wgmma_fence();
    mma_abt<D, TQ>(sT, base, at);
    mma_abt<D, TQ>(dpT, base + C::OFF_V, at + C::SLOT_G);
    wgmma_commit();
    if (d.bias_rows) {
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = q0 + 8 * j + 2 * t + (e & 1), key = key0 + 8 * (e >> 1);
          bv[4 * j + e] = q < d.T && key < d.S ? __ldg(bmat + (size_t)q * d.S + key) : 0.0f;
        }
    }
    wgmma_wait<0>();
    fence_regs(sT);
    fence_regs(dpT);
    fence_regs(ak);
    fence_regs(av);
    if (it >= 1 && it - 1 + ST < n_tiles) {
      bar_sync(1, THREADS);
      if (tid == 0) load_q(it - 1 + ST);
    }
    const unsigned char* slot = smem + C::OFF_SLOTS + st * C::SLOT;
    const uint32_t* qbits = reinterpret_cast<const uint32_t*>(slot + C::SLOT_BITS);
    const float2* qstats = reinterpret_cast<const float2*>(slot + C::SLOT_STATS);
    const float* qdelta = reinterpret_cast<const float*>(slot + C::SLOT_DELTA);
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int ql = 8 * j + 2 * t + c;     // the query, in the tile
        const float2 mv = qstats[ql];         // zero past T, as dO and delta
        const float dl = qdelta[ql];
        const uint32_t w = has_bits ? qbits[ql * d.W + word] >> sh : 0xffffffffu;
        const bool qlive = q0 + ql < d.T;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * j + 2 * r + c;
          const float x = fmaf(sT[i], scale, d.bias_rows ? bv[i] : kb[r]);
          const float p =
              live[r] && qlive ? ex2_ftz(fmaf(x - mv.x, LOG2E, -mv.y * LOG2E)) : 0.0f;
          const bool kept = (w >> (8 * r)) & 1u;
          const float dpm = kept ? dpT[i] * inv_keep : 0.0f;
          const float ds = p * (dpm - dl);
          colsum[r] += ds;
          sT[i] = kept ? p * inv_keep : 0.0f;  // drop(p)^T
          dpT[i] = ds;                          // ds^T
        }
      }
    to_frags(pa, sT);
    to_frags(da, dpT);
    fence_regs(pa);
    fence_regs(da);
    fence_regs(av);
    fence_regs(ak);
    wgmma_fence();
    mma_pb<D, TQ / 16>(av, pa, at + C::SLOT_G);  // dV += drop(P)^T dO
    mma_pb<D, TQ / 16>(ak, da, at);              // dK += dS^T Q
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(ak);
  fence_regs(av);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (db_part != nullptr) {
      colsum[r] += __shfl_xor_sync(0xffffffffu, colsum[r], 1);
      colsum[r] += __shfl_xor_sync(0xffffffffu, colsum[r], 2);
      if (t == 0 && live[r]) db_part[((size_t)b * d.H + h) * d.S + key0 + 8 * r] = colsum[r];
    }
    if (!live[r]) continue;
    const size_t off = (((size_t)b * d.S + key0 + 8 * r) * d.H + h) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dk + off + 8 * j) =
          pack_bf16(ak[4 * j + 2 * r] * scale, ak[4 * j + 2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + 8 * j) = pack_bf16(av[4 * j + 2 * r], av[4 * j + 2 * r + 1]);
    }
  }
}

// dbias[b, r] = sum over heads, ascending, of part[b, h, r]; r runs over the
// Tb * S entries of one batch row's bias.
__global__ void __launch_bounds__(256)
dbias_reduce(const float* __restrict__ part, float* __restrict__ dbias, int B, int H,
             size_t row) {
  const size_t i = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (i >= (size_t)B * row) return;
  const size_t b = i / row, r = i - b * row;
  float acc = 0.f;
  for (int h = 0; h < H; ++h) acc += part[(b * H + h) * row + r];
  dbias[i] = acc;
}

// ---------------------------------------------------------------- launches

int encode(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* ptr,
           const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
           CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, type, rank, const_cast<void*>(ptr), dims, strides, box, ones,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The [B, L, H, D] bf16 tensor at `ptr` as dims (D, H, L, B), boxes of (DC, 1,
// rows, 1) in the swizzle wgmma reads; out of bounds reads zeros.
template <int D>
int map_rows(CUtensorMap* map, const void* ptr, int B, int L, int H, int rows) {
  using G = Geo<D>;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)L * H * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)G::DC, 1, (cuuint32_t)rows, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, ptr, dims, strides, box,
                G::RB == 128   ? CU_TENSOR_MAP_SWIZZLE_128B
                : G::RB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                              : CU_TENSOR_MAP_SWIZZLE_32B);
}

// The keep bits [B H, T, W] as dims (W, T, B H), boxes of whole rows.
int map_bits(CUtensorMap* map, const void* ptr, const Dims& d, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)d.W, (cuuint64_t)d.T, (cuuint64_t)d.B * d.H};
  const cuuint64_t strides[2] = {(cuuint64_t)d.W * 4, (cuuint64_t)d.T * d.W * 4};
  const cuuint32_t box[3] = {(cuuint32_t)d.W, (cuuint32_t)rows, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 3, ptr, dims, strides, box,
                CU_TENSOR_MAP_SWIZZLE_NONE);
}

// [B H, Tp, n] fp32 (the row statistics: n = 2; delta: n = 1) as dims (n T,
// B H), boxes of n rows floats: queries past T read as zeros.
int map_rowvals(CUtensorMap* map, const void* ptr, const Dims& d, int n, int rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)n * d.T, (cuuint64_t)d.B * d.H};
  const cuuint64_t strides[1] = {(cuuint64_t)n * d.Tp * 4};
  const cuuint32_t box[2] = {(cuuint32_t)(n * rows), 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, ptr, dims, strides, box,
                CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

inline bool make_dims(Dims& d, int B, int T, int S, int H, int D, int bias_rows) {
  d.B = B; d.T = T; d.S = S; d.H = H;
  d.W = ((S + 31) / 32 + 3) / 4 * 4;
  d.Tp = (T + 3) / 4 * 4;
  d.bias_rows = bias_rows;
  return B >= 1 && T >= 1 && S >= 1 && H >= 1 && B <= 65535 && H <= 65535 && S <= MAX_S &&
         (D == 16 || D == 32 || D == 64 || D == 128);
}

template <int D>
int fwd(const void* q, const void* k, const void* v, const void* bias, void* out, void* stats,
        void* bits, const Dims& d, float scale, float inv_keep, const MaskKey& key,
        cudaStream_t st) {
  // A runtime call before the driver's tensor-map encoder: it makes the
  // device's context current in this thread, which the encoder needs.
  int err = allow_smem(attn_fwd<D>, Fwd<D>::SMEM);
  CUtensorMap qmap, kmap, vmap;
  if (!err) err = map_rows<D>(&qmap, q, d.B, d.T, d.H, TM);
  if (!err) err = map_rows<D>(&kmap, k, d.B, d.S, d.H, TK);
  if (!err) err = map_rows<D>(&vmap, v, d.B, d.S, d.H, TK);
  if (err) return err;
  attn_fwd<D><<<dim3((d.T + TM - 1) / TM, d.H, d.B), THREADS, Fwd<D>::SMEM, st>>>(
      qmap, kmap, vmap, static_cast<const float*>(bias), static_cast<bf16*>(out),
      static_cast<float2*>(stats), static_cast<uint32_t*>(bits), d, scale, inv_keep, key);
  return (int)cudaGetLastError();
}

template <int D, bool EXACT>
int launch_dq(const CUtensorMap& qmap, const CUtensorMap& gmap, const CUtensorMap& kmap,
              const CUtensorMap& vmap, const CUtensorMap& bmap, const void* bias, const void* g,
              const void* out, const void* stats, void* delta, void* dq, void* db_part,
              const Dims& d, float scale, float inv_keep, int has_bits, cudaStream_t st) {
  attn_bwd_dq<D, EXACT><<<dim3((d.T + TM - 1) / TM, d.H, d.B), THREADS, Dq<D>::SMEM, st>>>(
      qmap, gmap, kmap, vmap, bmap, static_cast<const float*>(bias), static_cast<const bf16*>(g),
      static_cast<const bf16*>(out), static_cast<const float2*>(stats),
      static_cast<float*>(delta), static_cast<bf16*>(dq),
      d.bias_rows ? static_cast<float*>(db_part) : nullptr, d, scale, inv_keep, has_bits);
  return (int)cudaGetLastError();
}

template <int D>
int bwd(const void* q, const void* k, const void* v, const void* bias, const void* g,
        const void* out, const void* stats, const void* bits, void* delta, void* dq, void* dk,
        void* dv, void* db_part, void* dbias, const Dims& d, float scale, float inv_keep,
        cudaStream_t st) {
  using C = Dkv<D>;
  const int has_bits = bits != nullptr;
  // Runtime calls before the driver's tensor-map encoder: they make the
  // device's context current in this thread (the autograd engine's worker
  // may have none yet), which the encoder needs.
  int err = dbias != nullptr ? allow_smem(attn_bwd_dq<D, true>, Dq<D>::SMEM)
                             : allow_smem(attn_bwd_dq<D, false>, Dq<D>::SMEM);
  if (!err) err = allow_smem(attn_bwd_dkdv<D>, C::SMEM);
  CUtensorMap qmap, gmap, kmap, vmap, bmap, qmap_t, gmap_t, bmap_t, smap, dmap;
  if (!err) err = map_rows<D>(&qmap, q, d.B, d.T, d.H, TM);
  if (!err) err = map_rows<D>(&gmap, g, d.B, d.T, d.H, TM);
  if (!err) err = map_rows<D>(&kmap, k, d.B, d.S, d.H, TK);
  if (!err) err = map_rows<D>(&vmap, v, d.B, d.S, d.H, TK);
  if (!err) err = map_rows<D>(&qmap_t, q, d.B, d.T, d.H, C::TQ);
  if (!err) err = map_rows<D>(&gmap_t, g, d.B, d.T, d.H, C::TQ);
  if (!err) err = map_rowvals(&smap, stats, d, 2, C::TQ);
  if (!err) err = map_rowvals(&dmap, delta, d, 1, C::TQ);
  if (!err && has_bits) err = map_bits(&bmap, bits, d, TM);
  if (!err && has_bits) err = map_bits(&bmap_t, bits, d, C::TQ);
  if (err) return err;
  if (!has_bits) bmap = bmap_t = qmap;  // never read
  err = dbias != nullptr
            ? launch_dq<D, true>(qmap, gmap, kmap, vmap, bmap, bias, g, out, stats, delta, dq,
                                 db_part, d, scale, inv_keep, has_bits, st)
            : launch_dq<D, false>(qmap, gmap, kmap, vmap, bmap, bias, g, out, stats, delta, dq,
                                  db_part, d, scale, inv_keep, has_bits, st);
  if (err) return err;
  attn_bwd_dkdv<D><<<dim3((d.S + TK - 1) / TK, d.H, d.B), THREADS, C::SMEM, st>>>(
      kmap, vmap, qmap_t, gmap_t, bmap_t, smap, dmap, static_cast<const float*>(bias),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      d.bias_rows ? nullptr : static_cast<float*>(db_part), d, scale, inv_keep, has_bits);
  err = (int)cudaGetLastError();
  if (err || dbias == nullptr) return err;
  const size_t row = (size_t)(d.bias_rows ? d.T : 1) * d.S;
  const size_t total = (size_t)d.B * row;
  dbias_reduce<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(db_part), static_cast<float*>(dbias), d.B, d.H, row);
  return (int)cudaGetLastError();
}

}  // namespace

// 1 if the kernels (forward and backward alike) take this shape, else 0.
// ops/train_attention.py::fused_attention_supported repeats this arithmetic
// so that it answers without a build; the smoke test holds the two against
// each other.
extern "C" int itt_fused_attn_supported(int B, int T, int S, int H, int D) {
  Dims d;
  return make_dims(d, B, T, S, H, D, 0) ? 1 : 0;
}

// q, out [B, T, H, D]; k, v [B, S, H, D], bf16, contiguous, 16-byte aligned;
// bias fp32 [B, 1, 1|T, S]; stats [B, H, Tp, 2] fp32 (m, log l) out, Tp = T
// rounded up to 4; bits null or uint32 [B, H, T, W] out (the keep bits, W =
// ceil(S / 32) rounded up to 4; written only at rate > 0).
extern "C" int itt_fused_attn_fwd_bf16(const void* q, const void* k, const void* v,
                                       const void* bias, void* out, void* stats, void* bits,
                                       int B, int T, int S, int H, int D, int bias_rows,
                                       float scale, float keep_prob, unsigned threshold,
                                       unsigned seed_lo, unsigned seed_hi, void* stream) {
  Dims d;
  if (!make_dims(d, B, T, S, H, D, bias_rows)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float inv_keep = 1.0f / keep_prob;
  MaskKey key;
  key.threshold = threshold;
  for (int i = 0; i < 10; ++i) {
    key.round[i][0] = seed_lo + i * 0x9E3779B9u;
    key.round[i][1] = seed_hi + i * 0xBB67AE85u;
  }
  void* b = threshold > 0u ? bits : nullptr;
  switch (D) {
    case 16: return fwd<16>(q, k, v, bias, out, stats, b, d, scale, inv_keep, key, st);
    case 32: return fwd<32>(q, k, v, bias, out, stats, b, d, scale, inv_keep, key, st);
    case 64: return fwd<64>(q, k, v, bias, out, stats, b, d, scale, inv_keep, key, st);
    default: return fwd<128>(q, k, v, bias, out, stats, b, d, scale, inv_keep, key, st);
  }
}

// g [B, T, H, D] bf16; out, stats, bits: the forward's (bits null at rate 0:
// every probability kept); delta: fp32 scratch [B, H, Tp]. db_part / dbias:
// null unless dbias is wanted; db_part is [B, H, Tb, S] fp32.
extern "C" int itt_fused_attn_bwd_bf16(const void* q, const void* k, const void* v,
                                       const void* bias, const void* g, const void* out,
                                       const void* stats, const void* bits, void* delta,
                                       void* dq, void* dk, void* dv, void* db_part, void* dbias,
                                       int B, int T, int S, int H, int D, int bias_rows,
                                       float scale, float keep_prob, void* stream) {
  Dims d;
  if (!make_dims(d, B, T, S, H, D, bias_rows)) return (int)cudaErrorInvalidValue;
  if ((db_part == nullptr) != (dbias == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float inv_keep = 1.0f / keep_prob;
  switch (D) {
    case 16: return bwd<16>(q, k, v, bias, g, out, stats, bits, delta, dq, dk, dv, db_part, dbias, d, scale, inv_keep, st);
    case 32: return bwd<32>(q, k, v, bias, g, out, stats, bits, delta, dq, dk, dv, db_part, dbias, d, scale, inv_keep, st);
    case 64: return bwd<64>(q, k, v, bias, g, out, stats, bits, delta, dq, dk, dv, db_part, dbias, d, scale, inv_keep, st);
    default: return bwd<128>(q, k, v, bias, g, out, stats, bits, delta, dq, dk, dv, db_part, dbias, d, scale, inv_keep, st);
  }
}
