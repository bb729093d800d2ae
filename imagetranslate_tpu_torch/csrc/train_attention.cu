// Fused training attention with in-kernel dropout for Hopper (sm_90a):
// a flash-style forward and an FA2-style backward.
//
// Replaces the Pallas TPU kernels of imagetranslate_tpu/ops/train_attention.py
// (`_fwd_kernel` :60 behind `fused_dropout_attention` :242, and `_bwd_kernel`
// :86 behind `_bwd_rule` :256). Forward: softmax(Q K^T * scale + bias) in fp32,
// a Bernoulli keep-mask (keep iff 32 random bits >= threshold), kept probs
// divided by (1 - rate), times V. Backward: dv = drop(p)^T g, dp = g v^T masked
// and scaled, ds = p (dp - delta) with delta = rowsum(p dp), dq = ds k * scale,
// dk = ds^T q * scale, and dbias = ds summed over heads (and over queries for
// a [B, 1, 1, S] bias). No [T, S] row exists anywhere: keys (forward, dq) or
// queries (dk/dv) stream through shared memory in tiles of 64, and scores,
// probabilities and masks live in registers.
//
// What bounds it: operations and the mask, not bytes. At the MLM shape (B=16,
// T=S=512, H=12, D=64) the forward moves 50 MB (0.015 ms at 3.35 TB/s) for 12.9
// GFLOP (0.013 ms at 989 TFLOP/s) and draws 12.6 M Philox blocks; the backward
// does 10 B H T S D = 32 GFLOP over 88 MB. So every intermediate stays in
// registers, both products run on the tensor cores (mma.sync m16n8k16, bf16 in,
// fp32 accumulate, fed by ldmatrix), the next tile's cp.async copies are in
// flight while this one is multiplied (two stages, one barrier a tile), and each
// Philox block is drawn by one lane and shared with the lanes that hold its
// other words (one shuffle a tile in the forward layout, four in the dk/dv
// kernel's transposed one). wgmma, TMA and warp specialisation are later work.
//
// Forward (one block per (64-query tile, head, batch row); a warp owns 16
// query rows): an online softmax with a running maximum m and sum l. l sums
// every probability, the accumulator only the kept ones; p = exp(x - m) is
// rounded to bf16 un-normalised before the product with V, and the division by
// l and by 1 - rate comes last. The forward also writes each row's logsumexp in
// two parts, (m, log l): at the -10000 of a fully masked row one fp32 lse
// would round to 2^-10 and shift every recomputed p by ~0.05 %.
//
// Backward, two kernels and no atomics. The dq kernel (one block per query
// tile) walks the key tiles twice: the first pass recomputes p from (m, log l)
// and the mask, and sums delta = rowsum(p dp) in fp32 exactly (not as rowsum(g
// out) over the bf16 output, which would move dbias past its 1e-4 tolerance);
// it keeps the mask bits in shared memory (one word a lane a tile) and writes
// delta; the second pass forms ds and accumulates dq. The dk/dv kernel (one
// block per (64-key tile, head, batch row), a warp owning 16 keys) walks the
// query tiles, recomputes p^T and dp^T for its keys, regenerates the mask, and
// keeps dk and dv in registers until the end. ds and drop(p) enter the
// products as one bf16 pass (the TPU kernel contracts in fp32; the rounding
// is ~2^-9 of a term, inside the 2^-6 tolerance at S = 512).
//
// The mask is a pure function of (seed, b, h, t, s): Philox-4x32-10 keyed on
// the 64-bit seed with the counter (s / 4, t, h, b), word s % 4 of its four
// outputs. The three kernels tile differently, yet they see the same mask; so
// does the plain PyTorch version (ops/train_attention.py), which the kernels
// are held against element by element.
//
// dbias: per-head partials (ds itself for a [B, 1, T, S] bias, from the dq
// kernel; the column sums over queries for [B, 1, 1, S], from the dk/dv
// kernel), then a third kernel sums the heads in ascending order, so dbias is
// bit-reproducible. They run only when the caller asks for dbias (the model's
// biases come from masks and need none).
//
// Plain C interface, loaded with ctypes (imagetranslate_tpu_torch/ops/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TQ = 64;            // queries a tile
constexpr int TK = 64;            // keys a tile
constexpr int WARPS = 4;          // a warp owns 16 rows of a 64-row tile
constexpr int THREADS = WARPS * 32;
constexpr int PAD = 8;            // bf16 row padding: ldmatrix without bank conflicts
constexpr int LB = TK + 8;        // fp32 row stride of a staged [64, 64] bias tile
constexpr int MAX_S = 512;        // the gate's (and the TPU kernel's) longest key axis
constexpr int MAX_KT = MAX_S / TK;
constexpr int NS = TK / 8;        // 8-column mma tiles across 64 keys or queries
constexpr float MASKED = -1e30f;  // score of a key past S: p = 0

struct Dims {
  int B, T, S, H;
  int bias_rows;  // 1: bias [B, 1, T, S]; 0: bias [B, 1, 1, S]
  int bias_vec;   // S % 4 == 0: the bias streams in 16-byte copies
};

// ---------------------------------------------------------------- Philox

__device__ __forceinline__ uint4 philox4x32_10(uint32_t c0, uint32_t c1, uint32_t c2,
                                               uint32_t c3, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0; c1 = lo1; c2 = n2; c3 = lo0;
    k0 += 0x9E3779B9u; k1 += 0xBB67AE85u;
  }
  return make_uint4(c0, c1, c2, c3);
}

// Bit w of the result: word w of the block at counter (group, t, h, b) is kept.
__device__ __forceinline__ uint32_t keep_nibble(uint32_t group, uint32_t t, uint32_t h,
                                                uint32_t b, uint32_t k0, uint32_t k1,
                                                uint32_t threshold) {
  const uint4 r = philox4x32_10(group, t, h, b, k0, k1);
  return (r.x >= threshold ? 1u : 0u) | (r.y >= threshold ? 2u : 0u) |
         (r.z >= threshold ? 4u : 0u) | (r.w >= threshold ? 8u : 0u);
}

// The keep bits of a warp's [16 rows, 64 keys] tile in the mma accumulator
// layout: lane 4 g + t holds rows g (e = 0, 1) and g + 8 (e = 2, 3) at keys
// 8 j + 2 t + (e & 1); bit 4 j + e of the result is element (j, e). Keys
// 8 j + 2 t, + 1 are words 2 (t & 1), + 1 of the block at group 2 j + t / 2,
// which lanes t and t ^ 1 share: the even lane draws row g's block, the odd
// one row g + 8's, and one shuffle trades the halves.
__device__ __forceinline__ uint32_t keep_bits_rows(int row0, int s0, int h, int b, uint32_t k0,
                                                   uint32_t k1, uint32_t threshold) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, odd = t & 1;
  const uint32_t row = (uint32_t)(row0 + g + 8 * odd);
  uint32_t own = 0u;
#pragma unroll
  for (int j = 0; j < NS; ++j)
    own |= keep_nibble((uint32_t)(s0 / 4 + 2 * j + (t >> 1)), row, h, b, k0, k1, threshold)
           << (4 * j);
  const uint32_t other = __shfl_xor_sync(0xffffffffu, own, 1);
  const uint32_t top = odd ? other : own, bottom = odd ? own : other;  // rows g, g + 8
  const int sh = 2 * odd;
  return ((top >> sh) & 0x33333333u) | (((bottom >> sh) & 0x33333333u) << 2);
}

// The same for the dk/dv kernel's transposed tile: lane 4 g + t holds keys
// key0 + g (e = 0, 1) and key0 + g + 8 (e = 2, 3) at queries q0 + 8 j + 2 t +
// (e & 1). The four lanes g = 4 u + i (same u, same t) need the four blocks
// (keys 4 u (+ 8), queries 2 t (+ 1)), each one word of each: lane i draws
// block e = i, and four shuffles hand every lane word i of each.
__device__ __forceinline__ uint32_t keep_bits_cols(int key0, int q0, int h, int b, uint32_t k0,
                                                   uint32_t k1, uint32_t threshold) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int i = g & 3, u = g >> 2;
  const uint32_t group = (uint32_t)(key0 / 4 + u + 2 * (i >> 1));
  uint32_t own = 0u;
#pragma unroll
  for (int j = 0; j < NS; ++j)
    own |= keep_nibble(group, (uint32_t)(q0 + 8 * j + 2 * t + (i & 1)), h, b, k0, k1,
                       threshold)
           << (4 * j);
  uint32_t bits = 0u;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint32_t w = __shfl_sync(0xffffffffu, own, (lane & ~12) | (e << 2));
    bits |= ((w >> i) & 0x11111111u) << e;
  }
  return bits;
}

// ---------------------------------------------------------------- copies and mma

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// global -> shared without passing through registers; zero-filled when
// `valid` is false (`src` must still be a readable address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 8 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Four 8x8 bf16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 and receives elements (l / 4, 2 (l % 4) .. + 1) of each.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The same, each matrix transposed: elements (2 (l % 4) .. + 1, l / 4).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c[16, 8] += a[16, 16] . b[16, 8]. Lane l = 4 g + t holds a: rows g, g + 8 x
// columns 2t, 2t + 1 (+ 8); b: rows 2t, 2t + 1 (+ 8) x column g; c: rows g
// (c0, c1), g + 8 (c2, c3) x columns 2t, 2t + 1.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// acc[16, 8 NS] = A[16 rows, D] . Bt[64 rows, D]^T: A is the warp's 16 rows
// of a [.., D + PAD] tile in shared memory, Bt a 64-row tile.
template <int D>
__device__ __forceinline__ void mma_abt(float (&acc)[NS][4], const bf16* A, const bf16* Bt) {
  constexpr int LD = D + PAD;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    ldmatrix_x4(af, A + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < NS; j += 2) {
      uint32_t bf[4];
      ldmatrix_x4(bf, Bt + (j * 8 + (lane >> 4) * 8 + (lane & 7)) * LD + kk * 16 +
                          ((lane >> 3) & 1) * 8);
      mma16816(acc[j], af, bf[0], bf[1]);
      mma16816(acc[j + 1], af, bf[2], bf[3]);
    }
  }
}

// acc[16, D] += P[16, 64] . Bm[64 rows, D]: P in the accumulator layout of
// mma_abt (rounded to bf16 here, the accumulators of two neighbouring 8-column
// tiles being the A operand of one 16-deep step), Bm a 64-row tile.
template <int D>
__device__ __forceinline__ void mma_pb(float (&acc)[D / 8][4], const float (&p)[NS][4],
                                       const bf16* Bm) {
  constexpr int LD = D + PAD;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < TK / 16; ++kk) {
    uint32_t pf[4];
    pf[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    pf[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    pf[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    pf[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
    for (int dn = 0; dn < D / 8; dn += 2) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, Bm + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD + dn * 8 +
                                (lane >> 4) * 8);
      mma16816(acc[dn], pf, bf[0], bf[1]);
      mma16816(acc[dn + 1], pf, bf[2], bf[3]);
    }
  }
}

// Rows [row0, row0 + 64) of the (b, h) slice of a [B, L, H, D] tensor into
// shared memory (row stride D + PAD) by cp.async, rows past L zero-filled (a
// product with a zero row adds nothing; garbage could be NaN).
template <int D>
__device__ __forceinline__ void load_tile(const bf16* __restrict__ src, bf16* dst, int row0,
                                          int L, int H, int b, int h) {
  constexpr int VECS = D / 8, LD = D + PAD;
  for (int i = threadIdx.x; i < 64 * VECS; i += THREADS) {
    const int r = i / VECS, c = (i - r * VECS) * 8;
    const int row = row0 + r;
    const bool valid = row < L;
    const size_t at = (((size_t)b * L + (valid ? row : L - 1)) * H + h) * D + c;
    cp_async16(dst + r * LD + c, src + at, valid);
  }
}

// The bias of queries [t0, t0 + 64) x keys [s0, s0 + 64): a [64, LB] tile for
// a [B, 1, T, S] bias (rows past T and keys past S zero), 64 floats for a
// [B, 1, 1, S] one.
__device__ __forceinline__ void load_bias(const float* __restrict__ bias, float* dst,
                                          const Dims& d, int b, int t0, int s0) {
  if (d.bias_rows) {
    const float* base = bias + (size_t)b * d.T * d.S;
    if (d.bias_vec) {  // S % 4 == 0: a 4-vector lies wholly inside or outside
      for (int i = threadIdx.x; i < TQ * (TK / 4); i += THREADS) {
        const int r = i / (TK / 4), c = (i - r * (TK / 4)) * 4;
        const bool valid = t0 + r < d.T && s0 + c < d.S;
        cp_async16(dst + r * LB + c, valid ? base + (size_t)(t0 + r) * d.S + s0 + c : bias,
                   valid);
      }
    } else {
      for (int i = threadIdx.x; i < TQ * TK; i += THREADS) {
        const int r = i / TK, c = i - r * TK;
        const bool valid = t0 + r < d.T && s0 + c < d.S;
        cp_async4(dst + r * LB + c, valid ? base + (size_t)(t0 + r) * d.S + s0 + c : bias,
                  valid);
      }
    }
  } else if (threadIdx.x < TK) {
    const int s = s0 + threadIdx.x;
    cp_async4(dst + threadIdx.x, s < d.S ? bias + (size_t)b * d.S + s : bias, s < d.S);
  }
}

__host__ __device__ constexpr int bias_stage_floats(int bias_rows) {
  return bias_rows ? TQ * LB : TK;
}

// x = score * scale + bias over the warp's [16, 64] tile in the mma layout
// (rows r0 + g, r0 + 8 of a staged bias tile), keys past S pushed to MASKED.
__device__ __forceinline__ void add_bias_rows(float (&s)[NS][4], const float* Bt, int bias_rows,
                                              int r0, int s0, int S, float scale) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    float2 b0, b1;
    if (bias_rows) {
      b0 = *reinterpret_cast<const float2*>(Bt + (r0 + g) * LB + j * 8 + 2 * t);
      b1 = *reinterpret_cast<const float2*>(Bt + (r0 + g + 8) * LB + j * 8 + 2 * t);
    } else {
      b0 = b1 = *reinterpret_cast<const float2*>(Bt + j * 8 + 2 * t);
    }
    s[j][0] = fmaf(s[j][0], scale, b0.x);
    s[j][1] = fmaf(s[j][1], scale, b0.y);
    s[j][2] = fmaf(s[j][2], scale, b1.x);
    s[j][3] = fmaf(s[j][3], scale, b1.y);
  }
  if (s0 + TK > S) {
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (s0 + j * 8 + 2 * t + (e & 1) >= S) s[j][e] = MASKED;
  }
}

// ---------------------------------------------------------------- forward

template <int D>
__global__ void __launch_bounds__(THREADS)
attn_fwd(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
         const float* __restrict__ bias, bf16* __restrict__ out, float2* __restrict__ stats,
         Dims d, float scale, float inv_keep, uint32_t threshold, uint32_t k0, uint32_t k1) {
  constexpr int LD = D + PAD, ND = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + TQ * LD;          // 2 stages
  bf16* Vs = Ks + 2 * TK * LD;      // 2 stages
  float* Bs = reinterpret_cast<float*>(Vs + 2 * TK * LD);
  const int bstage = bias_stage_floats(d.bias_rows);

  const int t0 = blockIdx.x * TQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool drop = threshold > 0u;

  load_tile<D>(q, Qs, t0, d.T, d.H, b, h);
  load_tile<D>(k, Ks, 0, d.S, d.H, b, h);
  load_tile<D>(v, Vs, 0, d.S, d.H, b, h);
  load_bias(bias, Bs, d, b, t0, 0);
  cp_async_commit();

  // A warp whose 16 rows all lie past T only helps with the copies.
  const bool active = t0 + warp * 16 < d.T;
  float o[ND][4];
#pragma unroll
  for (int dn = 0; dn < ND; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.0f;
  // Rows g and g + 8 of the warp's 16: running maximum and sum, the same in
  // the four lanes of a quad.
  float m_run[2] = {MASKED, MASKED}, l_run[2] = {0.0f, 0.0f};

  const int n_tiles = (d.S + TK - 1) / TK;
  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1, s0 = it * TK;
    // Tile `it` has landed, and every warp is done with tile `it - 1`, whose
    // stage the next tile's copies now overwrite.
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < n_tiles) {
      load_tile<D>(k, Ks + (stage ^ 1) * TK * LD, s0 + TK, d.S, d.H, b, h);
      load_tile<D>(v, Vs + (stage ^ 1) * TK * LD, s0 + TK, d.S, d.H, b, h);
      load_bias(bias, Bs + (stage ^ 1) * bstage, d, b, t0, s0 + TK);
      cp_async_commit();
    }
    if (!active) continue;

    float s[NS][4];
    mma_abt<D>(s, Qs + warp * 16 * LD, Ks + stage * TK * LD);
    add_bias_rows(s, Bs + stage * bstage, d.bias_rows, warp * 16, s0, d.S, scale);

    float mx[2] = {MASKED, MASKED};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float corr[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_cur = fmaxf(m_run[r], mx[r]);
      corr[r] = __expf(m_run[r] - m_cur);
      m_run[r] = m_cur;
    }
    // __expf is exp2 of a product, two instructions where expf is twenty:
    // its ~2^-21 relative error vanishes in p's rounding to bf16.
    const uint32_t keep =
        drop ? keep_bits_rows(t0 + warp * 16, s0, h, b, k0, k1, threshold) : 0xffffffffu;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[j][e] - m_run[e >> 1]);
        sum[e >> 1] += p;                                 // every probability
        s[j][e] = ((keep >> (4 * j + e)) & 1u) ? p : 0.0f;  // only the kept ones
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l_run[r] = l_run[r] * corr[r] + sum[r];
    }
#pragma unroll
    for (int dn = 0; dn < ND; ++dn) {
      o[dn][0] *= corr[0]; o[dn][1] *= corr[0];
      o[dn][2] *= corr[1]; o[dn][3] *= corr[1];
    }
    mma_pb<D>(o, s, Vs + stage * TK * LD);
  }

  if (!active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = t0 + warp * 16 + g + 8 * r;
    if (row >= d.T) continue;
    const float f = inv_keep / l_run[r];
    bf16* dst = out + (((size_t)b * d.T + row) * d.H + h) * D + 2 * t;
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)
      *reinterpret_cast<uint32_t*>(dst + dn * 8) = pack_bf16(o[dn][2 * r] * f, o[dn][2 * r + 1] * f);
    if (t == 0)
      stats[((size_t)b * d.H + h) * d.T + row] = make_float2(m_run[r], logf(l_run[r]));
  }
}

// ---------------------------------------------------------------- backward: dq and delta

template <int D>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dq(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
            const float* __restrict__ bias, const bf16* __restrict__ gr,
            const float2* __restrict__ stats, float* __restrict__ delta, bf16* __restrict__ dq,
            float* __restrict__ db_part,  // [B, H, T, S] for a [B, 1, T, S] bias, else null
            Dims d, float scale, float inv_keep, uint32_t threshold, uint32_t k0, uint32_t k1) {
  constexpr int LD = D + PAD, ND = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Gs = Qs + TQ * LD;
  bf16* Ks = Gs + TQ * LD;          // 2 stages
  bf16* Vs = Ks + 2 * TK * LD;      // 2 stages
  uint32_t* KB = reinterpret_cast<uint32_t*>(Vs + 2 * TK * LD);  // [WARPS][MAX_KT][32]
  float* Bs = reinterpret_cast<float*>(KB + WARPS * MAX_KT * 32);
  const int bstage = bias_stage_floats(d.bias_rows);

  const int t0 = blockIdx.x * TQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool drop = threshold > 0u;

  load_tile<D>(q, Qs, t0, d.T, d.H, b, h);
  load_tile<D>(gr, Gs, t0, d.T, d.H, b, h);
  load_tile<D>(k, Ks, 0, d.S, d.H, b, h);
  load_tile<D>(v, Vs, 0, d.S, d.H, b, h);
  load_bias(bias, Bs, d, b, t0, 0);
  cp_async_commit();

  const bool active = t0 + warp * 16 < d.T;
  float st_m[2], st_l[2];           // rows g, g + 8: (m, log l) of the forward
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = t0 + warp * 16 + g + 8 * r;
    const float2 mv = row < d.T ? stats[((size_t)b * d.H + h) * d.T + row] : make_float2(0.f, 0.f);
    st_m[r] = mv.x;
    st_l[r] = mv.y;
  }
  float acc[ND][4];
#pragma unroll
  for (int dn = 0; dn < ND; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.0f;
  float dsum[2] = {0.0f, 0.0f};

  // Pass 1 (it < n_tiles) sums delta; pass 2 forms ds and dq. With more
  // than two key tiles the copies run across the boundary and the tiles
  // stream twice; one or two stay resident in their own stages for pass 2.
  const int n_tiles = (d.S + TK - 1) / TK;
  const bool resident = n_tiles <= 2;
  for (int it = 0; it < 2 * n_tiles; ++it) {
    const int kt = it < n_tiles ? it : it - n_tiles, s0 = kt * TK;
    const int stage = resident ? kt : (it & 1);
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < (resident ? n_tiles : 2 * n_tiles)) {
      const int nt = it + 1 < n_tiles ? it + 1 : it + 1 - n_tiles;
      const int ns = resident ? nt : (stage ^ 1);
      load_tile<D>(k, Ks + ns * TK * LD, nt * TK, d.S, d.H, b, h);
      load_tile<D>(v, Vs + ns * TK * LD, nt * TK, d.S, d.H, b, h);
      load_bias(bias, Bs + ns * bstage, d, b, t0, nt * TK);
      cp_async_commit();
    }
    if (!active) continue;

    const bf16* Kt = Ks + stage * TK * LD;
    float s[NS][4], dp[NS][4];
    mma_abt<D>(s, Qs + warp * 16 * LD, Kt);
    mma_abt<D>(dp, Gs + warp * 16 * LD, Vs + stage * TK * LD);
    add_bias_rows(s, Bs + stage * bstage, d.bias_rows, warp * 16, s0, d.S, scale);

    uint32_t keep = 0xffffffffu;
    uint32_t* kb = KB + (warp * MAX_KT + kt) * 32 + lane;
    if (drop) {
      if (it < n_tiles) {
        keep = keep_bits_rows(t0 + warp * 16, s0, h, b, k0, k1, threshold);
        *kb = keep;
      } else {
        keep = *kb;
      }
    }
    // In pass 2 dsum holds delta, the same in the four lanes of a quad.
    const bool first = it < n_tiles;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = __expf((s[j][e] - st_m[r]) - st_l[r]);
        const float dpm = ((keep >> (4 * j + e)) & 1u) ? dp[j][e] * inv_keep : 0.0f;
        if (first)
          dsum[r] += p * dpm;
        else
          s[j][e] = p * (dpm - dsum[r]);   // ds
      }
    }
    if (first) {
      if (it == n_tiles - 1) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          dsum[r] += __shfl_xor_sync(0xffffffffu, dsum[r], 1);
          dsum[r] += __shfl_xor_sync(0xffffffffu, dsum[r], 2);
          const int row = t0 + warp * 16 + g + 8 * r;
          if (t == 0 && row < d.T) delta[((size_t)b * d.H + h) * d.T + row] = dsum[r];
        }
      }
      continue;
    }
    if (db_part != nullptr) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = t0 + warp * 16 + g + 8 * r;
        if (row >= d.T) continue;
        float* dst = db_part + (((size_t)b * d.H + h) * d.T + row) * d.S;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const int col = s0 + j * 8 + 2 * t;
          if (col < d.S) dst[col] = s[j][2 * r];
          if (col + 1 < d.S) dst[col + 1] = s[j][2 * r + 1];
        }
      }
    }
    mma_pb<D>(acc, s, Kt);
  }

  if (!active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = t0 + warp * 16 + g + 8 * r;
    if (row >= d.T) continue;
    bf16* dst = dq + (((size_t)b * d.T + row) * d.H + h) * D + 2 * t;
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)
      *reinterpret_cast<uint32_t*>(dst + dn * 8) =
          pack_bf16(acc[dn][2 * r] * scale, acc[dn][2 * r + 1] * scale);
  }
}

// ---------------------------------------------------------------- backward: dk and dv

template <int D>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dkdv(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
              const float* __restrict__ bias, const bf16* __restrict__ gr,
              const float2* __restrict__ stats, const float* __restrict__ delta,
              bf16* __restrict__ dk, bf16* __restrict__ dv,
              float* __restrict__ db_part,  // [B, H, S] for a [B, 1, 1, S] bias, else null
              Dims d, float scale, float inv_keep, uint32_t threshold, uint32_t k0, uint32_t k1) {
  constexpr int LD = D + PAD, ND = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + TK * LD;
  bf16* Qs = Vs + TK * LD;          // 2 stages
  bf16* Gs = Qs + 2 * TQ * LD;      // 2 stages
  float2* Ss = reinterpret_cast<float2*>(Gs + 2 * TQ * LD);  // 2 stages of (m, log l)
  float* Ds = reinterpret_cast<float*>(Ss + 2 * TQ);         // 2 stages of delta
  float* Bs = Ds + 2 * TQ;    // 2 stages of [64, LB] or one [64] for a [B, 1, 1, S] bias
  const int bstage = d.bias_rows ? TQ * LB : 0;

  const int s0 = blockIdx.x * TK, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool drop = threshold > 0u;
  const size_t row_base = ((size_t)b * d.H + h) * d.T;

  // Per query tile: Q, g, their (m, log l) and delta (queries past T get
  // m = +inf, so p = 0, and delta = 0), and a [B, 1, T, S] bias's tile.
  auto load_queries = [&](int stage, int t0) {
    load_tile<D>(q, Qs + stage * TQ * LD, t0, d.T, d.H, b, h);
    load_tile<D>(gr, Gs + stage * TQ * LD, t0, d.T, d.H, b, h);
    if (threadIdx.x < TQ) {
      const int row = t0 + threadIdx.x;
      if (row < d.T) {
        cp_async8(Ss + stage * TQ + threadIdx.x, stats + row_base + row, true);
        cp_async4(Ds + stage * TQ + threadIdx.x, delta + row_base + row, true);
      } else {
        Ss[stage * TQ + threadIdx.x] = make_float2(INFINITY, 0.0f);
        Ds[stage * TQ + threadIdx.x] = 0.0f;
      }
    }
    if (d.bias_rows) load_bias(bias, Bs + stage * bstage, d, b, t0, s0);
  };

  load_tile<D>(k, Ks, s0, d.S, d.H, b, h);
  load_tile<D>(v, Vs, s0, d.S, d.H, b, h);
  if (!d.bias_rows) load_bias(bias, Bs, d, b, 0, s0);
  load_queries(0, 0);
  cp_async_commit();

  const int key0 = s0 + warp * 16;  // the warp's 16 keys
  const bool active = key0 < d.S;
  float ak[ND][4], av[ND][4];
#pragma unroll
  for (int dn = 0; dn < ND; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) ak[dn][e] = av[dn][e] = 0.0f;
  float colsum[2] = {0.0f, 0.0f};   // keys g, g + 8: ds over queries
  bool live[2];
  float kb_bias[2] = {0.0f, 0.0f};  // a [B, 1, 1, S] bias of keys g, g + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) live[r] = key0 + g + 8 * r < d.S;

  const int n_tiles = (d.T + TQ - 1) / TQ;
  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1, t0 = it * TQ;
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < n_tiles) {
      load_queries(stage ^ 1, t0 + TQ);
      cp_async_commit();
    }
    if (!active) continue;
    if (it == 0 && !d.bias_rows) {
      kb_bias[0] = Bs[warp * 16 + g];
      kb_bias[1] = Bs[warp * 16 + g + 8];
    }

    const bf16* Qt = Qs + stage * TQ * LD;
    const bf16* Gt = Gs + stage * TQ * LD;
    const float2* St = Ss + stage * TQ;
    const float* Dt = Ds + stage * TQ;
    const float* Bt = Bs + stage * bstage;
    // s^T[16 keys, 64 queries] = K_w Q^T, dp^T = V_w g^T.
    float s[NS][4], dp[NS][4];
    mma_abt<D>(s, Ks + warp * 16 * LD, Qt);
    mma_abt<D>(dp, Vs + warp * 16 * LD, Gt);
    const uint32_t keep =
        drop ? keep_bits_cols(key0, t0, h, b, k0, k1, threshold) : 0xffffffffu;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = j * 8 + 2 * t + (e & 1), r = e >> 1;
        const float bv = d.bias_rows ? Bt[qi * LB + warp * 16 + g + 8 * r] : kb_bias[r];
        const float2 mv = St[qi];
        const float x = fmaf(s[j][e], scale, bv);
        const float p = live[r] ? __expf((x - mv.x) - mv.y) : 0.0f;
        const bool kept = (keep >> (4 * j + e)) & 1u;
        const float dpm = kept ? dp[j][e] * inv_keep : 0.0f;
        const float ds = p * (dpm - Dt[qi]);
        colsum[r] += ds;
        s[j][e] = kept ? p * inv_keep : 0.0f;   // drop(p)^T
        dp[j][e] = ds;                          // ds^T
      }
    }
    mma_pb<D>(av, s, Gt);
    mma_pb<D>(ak, dp, Qt);
  }

  if (!active) return;
  if (db_part != nullptr) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      colsum[r] += __shfl_xor_sync(0xffffffffu, colsum[r], 1);
      colsum[r] += __shfl_xor_sync(0xffffffffu, colsum[r], 2);
      if (t == 0 && live[r]) db_part[((size_t)b * d.H + h) * d.S + key0 + g + 8 * r] = colsum[r];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!live[r]) continue;
    const size_t off = (((size_t)b * d.S + key0 + g + 8 * r) * d.H + h) * D + 2 * t;
#pragma unroll
    for (int dn = 0; dn < ND; ++dn) {
      *reinterpret_cast<uint32_t*>(dk + off + dn * 8) =
          pack_bf16(ak[dn][2 * r] * scale, ak[dn][2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + dn * 8) = pack_bf16(av[dn][2 * r], av[dn][2 * r + 1]);
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

template <int D>
constexpr size_t tile_bytes() { return (size_t)64 * (D + PAD) * sizeof(bf16); }

template <int D>
size_t fwd_smem(int bias_rows) {
  return 5 * tile_bytes<D>() + 2 * bias_stage_floats(bias_rows) * sizeof(float);
}

template <int D>
size_t dq_smem(int bias_rows) {
  return 6 * tile_bytes<D>() + WARPS * MAX_KT * 32 * sizeof(uint32_t) +
         2 * bias_stage_floats(bias_rows) * sizeof(float);
}

template <int D>
size_t dkdv_smem(int bias_rows) {
  return 6 * tile_bytes<D>() + 2 * TQ * (sizeof(float2) + sizeof(float)) +
         (bias_rows ? 2 * TQ * LB : TK) * sizeof(float);
}

template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

inline bool make_dims(Dims& d, int B, int T, int S, int H, int D, int bias_rows) {
  d.B = B; d.T = T; d.S = S; d.H = H;
  d.bias_rows = bias_rows;
  d.bias_vec = S % 4 == 0;
  return B >= 1 && T >= 1 && S >= 1 && H >= 1 && B <= 65535 && H <= 65535 && S <= MAX_S &&
         (D == 16 || D == 32 || D == 64 || D == 128);
}

template <int D>
int fwd(const void* q, const void* k, const void* v, const void* bias, void* out, void* stats,
        const Dims& d, float scale, float inv_keep, unsigned threshold, unsigned k0, unsigned k1,
        cudaStream_t st) {
  const size_t smem = fwd_smem<D>(d.bias_rows);
  int err = allow_smem(attn_fwd<D>, smem);
  if (err) return err;
  dim3 grid((d.T + TQ - 1) / TQ, d.H, d.B);
  attn_fwd<D><<<grid, THREADS, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(bias), static_cast<bf16*>(out), static_cast<float2*>(stats), d,
      scale, inv_keep, threshold, k0, k1);
  return (int)cudaGetLastError();
}

template <int D>
int bwd(const void* q, const void* k, const void* v, const void* bias, const void* g,
        const void* stats, void* delta, void* dq, void* dk, void* dv, void* db_part, void* dbias,
        const Dims& d, float scale, float inv_keep, unsigned threshold, unsigned k0, unsigned k1,
        cudaStream_t st) {
  const size_t smem_q = dq_smem<D>(d.bias_rows), smem_kv = dkdv_smem<D>(d.bias_rows);
  int err = allow_smem(attn_bwd_dq<D>, smem_q);
  if (err) return err;
  err = allow_smem(attn_bwd_dkdv<D>, smem_kv);
  if (err) return err;
  attn_bwd_dq<D><<<dim3((d.T + TQ - 1) / TQ, d.H, d.B), THREADS, smem_q, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(bias), static_cast<const bf16*>(g),
      static_cast<const float2*>(stats), static_cast<float*>(delta), static_cast<bf16*>(dq),
      d.bias_rows ? static_cast<float*>(db_part) : nullptr, d, scale, inv_keep, threshold, k0, k1);
  err = (int)cudaGetLastError();
  if (err) return err;
  attn_bwd_dkdv<D><<<dim3((d.S + TK - 1) / TK, d.H, d.B), THREADS, smem_kv, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(bias), static_cast<const bf16*>(g),
      static_cast<const float2*>(stats), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      d.bias_rows ? nullptr : static_cast<float*>(db_part), d, scale, inv_keep, threshold, k0,
      k1);
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

// q, out [B, T, H, D]; k, v [B, S, H, D], bf16, contiguous; bias fp32
// [B, 1, 1|T, S]; stats [B, H, T] float2 (m, log l) out.
extern "C" int itt_fused_attn_fwd_bf16(const void* q, const void* k, const void* v,
                                       const void* bias, void* out, void* stats, int B, int T,
                                       int S, int H, int D, int bias_rows, float scale,
                                       float keep_prob, unsigned threshold, unsigned seed_lo,
                                       unsigned seed_hi, void* stream) {
  Dims d;
  if (!make_dims(d, B, T, S, H, D, bias_rows)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float inv_keep = 1.0f / keep_prob;
  switch (D) {
    case 16: return fwd<16>(q, k, v, bias, out, stats, d, scale, inv_keep, threshold, seed_lo, seed_hi, st);
    case 32: return fwd<32>(q, k, v, bias, out, stats, d, scale, inv_keep, threshold, seed_lo, seed_hi, st);
    case 64: return fwd<64>(q, k, v, bias, out, stats, d, scale, inv_keep, threshold, seed_lo, seed_hi, st);
    default: return fwd<128>(q, k, v, bias, out, stats, d, scale, inv_keep, threshold, seed_lo, seed_hi, st);
  }
}

// stats: the forward's; delta: fp32 scratch [B, H, T]. db_part / dbias: null
// unless dbias is wanted; db_part is [B, H, Tb, S] fp32.
extern "C" int itt_fused_attn_bwd_bf16(const void* q, const void* k, const void* v,
                                       const void* bias, const void* g, const void* stats,
                                       void* delta, void* dq, void* dk, void* dv, void* db_part,
                                       void* dbias, int B, int T, int S, int H, int D,
                                       int bias_rows, float scale, float keep_prob,
                                       unsigned threshold, unsigned seed_lo, unsigned seed_hi,
                                       void* stream) {
  Dims d;
  if (!make_dims(d, B, T, S, H, D, bias_rows)) return (int)cudaErrorInvalidValue;
  if ((db_part == nullptr) != (dbias == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float inv_keep = 1.0f / keep_prob;
  switch (D) {
    case 16: return bwd<16>(q, k, v, bias, g, stats, delta, dq, dk, dv, db_part, dbias, d, scale, inv_keep, threshold, seed_lo, seed_hi, st);
    case 32: return bwd<32>(q, k, v, bias, g, stats, delta, dq, dk, dv, db_part, dbias, d, scale, inv_keep, threshold, seed_lo, seed_hi, st);
    case 64: return bwd<64>(q, k, v, bias, g, stats, delta, dq, dk, dv, db_part, dbias, d, scale, inv_keep, threshold, seed_lo, seed_hi, st);
    default: return bwd<128>(q, k, v, bias, g, stats, delta, dq, dk, dv, db_part, dbias, d, scale, inv_keep, threshold, seed_lo, seed_hi, st);
  }
}
