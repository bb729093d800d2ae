// Fused training attention with in-kernel dropout for Hopper (sm_90a):
// forward and backward.
//
// Replaces the Pallas TPU kernels of imagetranslate_tpu/ops/train_attention.py
// (`_fwd_kernel` :60 behind `fused_dropout_attention` :242, and `_bwd_kernel`
// :86 behind `_bwd_rule` :256). Forward: softmax(Q K^T * scale + bias) in fp32,
// a Bernoulli keep-mask (keep iff 32 random bits >= threshold), kept probs
// divided by (1 - rate), cast to bf16, times V. Backward: recompute the probs,
// regenerate the same mask, then dv = drop^T g, dp = g v^T masked and scaled,
// ds = p (dp - sum(dp p)), dq = ds k * scale, dk = ds^T q * scale, and dbias =
// ds summed over heads (and over queries for a [B, 1, 1, S] bias). Neither
// the probabilities nor the random bits nor the mask reach device memory, and
// nothing is kept between the passes but the inputs.
//
// What bounds it: bytes. At the training shape (B=256, T=S=64, H=12, D=64,
// bf16) the forward must move q, k, v and out, ~25 MB each (~100 MB, ~30 us at
// 3.35 TB/s) for 3.2 GFLOP (~3 us on the bf16 tensor cores); the backward
// moves seven such tensors for 8 GFLOP. So the design keeps every [T, S]
// intermediate in shared memory and indexes the [B, T, H, D] layout directly
// (no transposed copies). This first version stages whole K and V per block
// with plain loads and uses warp-level WMMA (bf16 in, fp32 accumulate); the
// softmax/dropout pass over the score rows, serial within a warp, is spread
// over as few lanes a row as hold it, so a warp works on several rows at
// once. cp.async/TMA pipelines, wgmma and scores kept in registers are later
// work.
//
// The mask is a pure function of (seed, b, h, t, s): Philox-4x32-10 keyed on
// the 64-bit seed with the counter (s / 4, t, h, b), lane s % 4 of its four
// outputs. Forward and backward tile differently, and a later version may
// tile differently again, yet they see the same mask; so does the plain
// PyTorch version (ops/train_attention.py), which the kernels are held
// against element by element.
//
// The TPU backward contracts in fp32. Here the fp32 operands ds and drop(p)
// are split into a bf16 head and a bf16 remainder (x = hi + lo to ~2^-17), and
// each product runs two tensor-core passes with fp32 accumulation; the other
// operand (q, k, g) is bf16 already, so its products are exact.
//
// dbias over heads: the TPU grid revisits one output block head after head.
// Blocks here run concurrently, one per (batch, head), so each writes its own
// per-head partial and a second kernel sums the heads in ascending order:
// no atomics, so dbias is bit-reproducible. Both run only when the caller
// asks for dbias (the model's biases come from masks and need none).
//
// Plain C interface, loaded with ctypes (imagetranslate_tpu_torch/ops/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TQ = 64;        // query rows per tile
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAXG = 4;       // 4-column groups a lane holds of its row: S <= 512
constexpr int PADK = 8;       // bf16 row padding of the q/k/v/g tiles (bank conflicts)
constexpr int PATCH = 16 * 16;  // one fp32 accumulator tile per warp

// ---------------------------------------------------------------- Philox

__device__ __forceinline__ uint4 philox4x32_10(uint32_t c0, uint32_t c1,
                                               uint32_t c2, uint32_t c3,
                                               uint32_t k0, uint32_t k1) {
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

// Reductions over the lpr (16 or 32) neighbouring lanes that share a row.
__device__ __forceinline__ float row_max(float v, int lpr) {
  for (int o = lpr >> 1; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v, int lpr) {
  for (int o = lpr >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The row pass gives a row to lpr lanes, the fewest that hold it in MAXG
// groups of 4 columns each: 8 lanes up to 128 columns (the training shape
// runs 4 rows a warp at once), 16 up to 256, a whole warp beyond. Lane `sub`
// of the row's lanes holds columns 4 lpr g + 4 sub + j, g < MAXG.
__device__ __forceinline__ int lanes_per_row(int Sp) {
  return Sp <= 128 ? 8 : (Sp <= 256 ? 16 : 32);
}

// ---------------------------------------------------------------- tiles

struct Dims {
  int B, T, S, H, D;
  int Sp;        // S rounded up to 16
  int LS;        // fp32 row stride of a score row (Sp or Sp + 8)
  int ldk;       // bf16 row stride of a q/k/v/g tile (D + PADK)
  int bias_rows; // 1: bias [B, 1, T, S]; 0: bias [B, 1, 1, S]
};

// Rows [row0, row0 + nrows) of the (b, h) slice of a [B, L, H, D] tensor into
// shared memory (row stride ld), 16 bytes a thread, rows past L zero-filled
// (a product with a zero row adds nothing; garbage could be NaN).
__device__ __forceinline__ void load_rows(const bf16* __restrict__ src, bf16* dst,
                                          int row0, int nrows, int L, int H, int D,
                                          int ld, int b, int h) {
  const int vecs = D >> 3;
  for (int i = threadIdx.x; i < nrows * vecs; i += THREADS) {
    const int r = i / vecs, c = (i - r * vecs) << 3;
    const int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < L)
      val = *reinterpret_cast<const uint4*>(src + (((size_t)b * L + row) * H + h) * D + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;

// C[TQ, 16 nt] (fp32, row stride ldc) = A[TQ, D] . Bm[16 nt, D]^T, both bf16 in
// shared memory. Warps stride over the 16x16 output tiles.
__device__ __forceinline__ void matmul_abt(const bf16* A, const bf16* Bm, int ldab,
                                           float* C, int ldc, int nt, int D) {
  const int warp = threadIdx.x >> 5;
  for (int tile = warp; tile < (TQ / 16) * nt; tile += WARPS) {
    const int tm = tile % (TQ / 16), tn = tile / (TQ / 16);
    Acc acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < D; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bm;
      wmma::load_matrix_sync(a, A + tm * 16 * ldab + kk, ldab);
      wmma::load_matrix_sync(bm, Bm + tn * 16 * ldab + kk, ldab);
      wmma::mma_sync(acc, a, bm, acc);
    }
    wmma::store_matrix_sync(C + tm * 16 * ldc + tn * 16, acc, ldc, wmma::mem_row_major);
  }
}

// acc += A[16, K] . Bm[K, 16] with A row-major (stride lda) in shared memory,
// Bm row-major (stride ldb). A_lo, when not null, is the bf16 remainder of A.
__device__ __forceinline__ void mma_row(Acc& acc, const bf16* A, const bf16* A_lo, int lda,
                                        const bf16* Bm, int ldb, int K) {
  for (int kk = 0; kk < K; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
    wmma::load_matrix_sync(bm, Bm + kk * ldb, ldb);
    wmma::load_matrix_sync(a, A + kk, lda);
    wmma::mma_sync(acc, a, bm, acc);
    if (A_lo != nullptr) {
      wmma::load_matrix_sync(a, A_lo + kk, lda);
      wmma::mma_sync(acc, a, bm, acc);
    }
  }
}

// acc += A^T[16, K] . Bm[K, 16] where A is stored [K, ...] row-major (stride
// lda), i.e. the transposed operand is read column-major.
__device__ __forceinline__ void mma_col(Acc& acc, const bf16* A, const bf16* A_lo, int lda,
                                        const bf16* Bm, int ldb, int K) {
  for (int kk = 0; kk < K; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
    wmma::load_matrix_sync(bm, Bm + kk * ldb, ldb);
    wmma::load_matrix_sync(a, A + kk * lda, lda);
    wmma::mma_sync(acc, a, bm, acc);
    if (A_lo != nullptr) {
      wmma::load_matrix_sync(a, A_lo + kk * lda, lda);
      wmma::mma_sync(acc, a, bm, acc);
    }
  }
}

// One warp writes its finished 16x16 tile: through its fp32 patch, scaled by
// alpha, rows row0.. of the (b, h) slice of a [B, L, H, D] tensor (rows past L
// dropped), columns col0... mode 0: store bf16 to out. mode 1: store fp32 to
// accum. mode 2: add to fp32 accum.
__device__ __forceinline__ void emit_tile(const Acc& acc, float* patch, float alpha,
                                          bf16* out, float* accum, int mode, int row0,
                                          int col0, int L, int H, int D, int b, int h) {
  const int lane = threadIdx.x & 31;
  wmma::store_matrix_sync(patch, acc, 16, wmma::mem_row_major);
  __syncwarp();
  const int r = lane >> 1, c = (lane & 1) << 3;
  const int row = row0 + r;
  if (row < L) {
    const size_t off = (((size_t)b * L + row) * H + h) * D + col0 + c;
    const float* p = patch + r * 16 + c;
    if (mode == 0) {
      __align__(16) bf16 vals[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) vals[j] = __float2bfloat16(p[j] * alpha);
      *reinterpret_cast<uint4*>(out + off) = *reinterpret_cast<const uint4*>(vals);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float v = p[j] * alpha;
        accum[off + j] = (mode == 1) ? v : accum[off + j] + v;
      }
    }
  }
  __syncwarp();
}

// The softmax row of one query: x = score * scale + bias over s < S, in
// registers (lane sub holds columns 4 lpr g + 4 sub + j), normalised to probs.
// Columns past S get 0.
__device__ __forceinline__ void softmax_row(const float* row, const float* brow, int S,
                                            int Sp, float scale, int sub, int lpr,
                                            float (&p)[MAXG][4]) {
  const int gs = 4 * lpr;  // columns between a lane's groups
  float m = -INFINITY;
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    const int s0 = g * gs + sub * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s0 < Sp) x = *reinterpret_cast<const float4*>(row + s0);
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = s0 + j;
      p[g][j] = (s < S) ? xs[j] * scale + brow[s] : -INFINITY;
      m = fmaxf(m, p[g][j]);
    }
  }
  m = row_max(m, lpr);
  float sum = 0.f;
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g * gs < Sp) {  // the whole warp skips a group past the row's end
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = g * gs + sub * 4 + j;
        p[g][j] = (s < S) ? expf(p[g][j] - m) : 0.f;
        sum += p[g][j];
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) p[g][j] = 0.f;
    }
  }
  sum = row_sum(sum, lpr);
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
    if (g * gs < Sp) {
#pragma unroll
      for (int j = 0; j < 4; ++j) p[g][j] = p[g][j] / sum;
    }
}

// The keep bits of the four columns from s0 on (s0 % 4 == 0): bit j of the result.
__device__ __forceinline__ uint32_t keep_bits(int s0, int t, int h, int b, uint32_t k0,
                                              uint32_t k1, uint32_t threshold) {
  const uint4 r = philox4x32_10((uint32_t)(s0 >> 2), (uint32_t)t, (uint32_t)h,
                                (uint32_t)b, k0, k1);
  return (r.x >= threshold ? 1u : 0u) | (r.y >= threshold ? 2u : 0u) |
         (r.z >= threshold ? 4u : 0u) | (r.w >= threshold ? 8u : 0u);
}

__device__ __forceinline__ void split_store(bf16* hi, bf16* lo, const float (&x)[4]) {
  __align__(8) bf16 h4[4];
  __align__(8) bf16 l4[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    h4[j] = __float2bfloat16(x[j]);
    l4[j] = __float2bfloat16(x[j] - __bfloat162float(h4[j]));
  }
  *reinterpret_cast<uint2*>(hi) = *reinterpret_cast<const uint2*>(h4);
  if (lo != nullptr) *reinterpret_cast<uint2*>(lo) = *reinterpret_cast<const uint2*>(l4);
}

// ---------------------------------------------------------------- forward

// One block per (query tile, head, batch row). Shared memory: the fp32 score
// rows [TQ, LS] (overwritten in place by the bf16 probs, row stride 2 LS), the
// Q tile, one [Sp, ldk] buffer that holds K and then V, and the warps' patches.
__global__ void __launch_bounds__(THREADS)
fused_attn_fwd(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const float* __restrict__ bias,
               bf16* __restrict__ out, Dims d, float scale, float keep_prob,
               uint32_t threshold, uint32_t k0, uint32_t k1) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* S1 = reinterpret_cast<float*>(smem);
  bf16* Qs = reinterpret_cast<bf16*>(S1 + TQ * d.LS);
  bf16* KVs = Qs + TQ * d.ldk;
  float* patches = reinterpret_cast<float*>(KVs + d.Sp * d.ldk);

  const int t0 = blockIdx.x * TQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool drop = threshold > 0u;

  load_rows(q, Qs, t0, TQ, d.T, d.H, d.D, d.ldk, b, h);
  load_rows(k, KVs, 0, d.Sp, d.S, d.H, d.D, d.ldk, b, h);
  __syncthreads();
  matmul_abt(Qs, KVs, d.ldk, S1, d.LS, d.Sp / 16, d.D);
  __syncthreads();
  load_rows(v, KVs, 0, d.Sp, d.S, d.H, d.D, d.ldk, b, h);

  const int Tb = d.bias_rows ? d.T : 1;
  const int lpr = lanes_per_row(d.Sp), rpw = 32 / lpr;
  const int sub = lane & (lpr - 1);
  for (int r = warp * rpw + lane / lpr; r < TQ; r += WARPS * rpw) {
    const int t = t0 + r;
    float* row = S1 + r * d.LS;
    const float* brow = bias + ((size_t)b * Tb + ((d.bias_rows && t < d.T) ? t : 0)) * d.S;
    float p[MAXG][4];
    softmax_row(row, brow, d.S, d.Sp, scale, sub, lpr, p);
    __syncwarp();  // every lane has read its fp32 scores before any bf16 write
    bf16* prow = reinterpret_cast<bf16*>(row);
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      const int s0 = g * 4 * lpr + sub * 4;
      if (s0 < d.Sp) {
        if (drop) {
          const uint32_t keep = keep_bits(s0, t, h, b, k0, k1, threshold);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            p[g][j] = ((keep >> j) & 1u) ? p[g][j] / keep_prob : 0.f;
        }
        split_store(prow + s0, nullptr, p[g]);
      }
    }
  }
  __syncthreads();

  // out tile [TQ, D] = probs [TQ, Sp] . V [Sp, D]
  const int ntn = d.D / 16;
  float* patch = patches + warp * PATCH;
  const bf16* P = reinterpret_cast<const bf16*>(S1);
  for (int tile = warp; tile < (TQ / 16) * ntn; tile += WARPS) {
    const int tm = tile % (TQ / 16), tn = tile / (TQ / 16);
    Acc acc;
    wmma::fill_fragment(acc, 0.0f);
    mma_row(acc, P + tm * 16 * 2 * d.LS, nullptr, 2 * d.LS, KVs + tn * 16, d.ldk, d.Sp);
    emit_tile(acc, patch, 1.0f, out, nullptr, 0, t0 + tm * 16, tn * 16, d.T, d.H, d.D, b, h);
  }
}

// ---------------------------------------------------------------- backward

// One block per (head, batch row); it walks the query tiles in order, so dk
// and dv of its (b, h) slice need no atomics: with one query tile they are
// written straight out, with more they accumulate in an fp32 scratch that the
// block converts at the end. Shared memory: S1 (scores, then the bf16 head
// and remainder of drop(p)), S2 (dp, then the head and remainder of ds), K, V,
// the Q and g tiles, and the warps' patches.
__global__ void __launch_bounds__(THREADS)
fused_attn_bwd(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const float* __restrict__ bias,
               const bf16* __restrict__ g, bf16* __restrict__ dq,
               bf16* __restrict__ dk, bf16* __restrict__ dv,
               float* __restrict__ dkv_acc,   // [2, B, S, H, D] fp32 or null
               float* __restrict__ db_part,   // [B, H, Tb, S] fp32 or null
               Dims d, float scale, float keep_prob, uint32_t threshold,
               uint32_t k0, uint32_t k1) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* S1 = reinterpret_cast<float*>(smem);
  float* S2 = S1 + TQ * d.LS;
  bf16* Ks = reinterpret_cast<bf16*>(S2 + TQ * d.LS);
  bf16* Vs = Ks + d.Sp * d.ldk;
  bf16* Qs = Vs + d.Sp * d.ldk;
  bf16* Gs = Qs + TQ * d.ldk;
  float* patches = reinterpret_cast<float*>(Gs + TQ * d.ldk);

  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool drop = threshold > 0u;
  const int n_qt = (d.T + TQ - 1) / TQ;
  const int Tb = d.bias_rows ? d.T : 1;
  const int lpr = lanes_per_row(d.Sp), rpw = 32 / lpr;
  const int sub = lane & (lpr - 1);
  const int ldp = 2 * d.LS;            // bf16 row stride inside S1 / S2
  const int lo_off = ldp - d.Sp;       // where a row's remainder half starts
  float* patch = patches + warp * PATCH;
  const size_t kv_elems = (size_t)d.B * d.S * d.H * d.D;

  float colsum[MAXG][4];               // dbias over queries, [B, 1, 1, S] layout
#pragma unroll
  for (int gi = 0; gi < MAXG; ++gi)
#pragma unroll
    for (int j = 0; j < 4; ++j) colsum[gi][j] = 0.f;

  load_rows(k, Ks, 0, d.Sp, d.S, d.H, d.D, d.ldk, b, h);
  load_rows(v, Vs, 0, d.Sp, d.S, d.H, d.D, d.ldk, b, h);

  for (int qt = 0; qt < n_qt; ++qt) {
    const int t0 = qt * TQ;
    __syncthreads();  // the previous tile's products have read Qs, Gs, S1, S2
    load_rows(q, Qs, t0, TQ, d.T, d.H, d.D, d.ldk, b, h);
    load_rows(g, Gs, t0, TQ, d.T, d.H, d.D, d.ldk, b, h);
    __syncthreads();
    matmul_abt(Qs, Ks, d.ldk, S1, d.LS, d.Sp / 16, d.D);   // scores
    matmul_abt(Gs, Vs, d.ldk, S2, d.LS, d.Sp / 16, d.D);   // dp_drop = g v^T
    __syncthreads();

    for (int r = warp * rpw + lane / lpr; r < TQ; r += WARPS * rpw) {
      const int t = t0 + r;
      float* row1 = S1 + r * d.LS;
      float* row2 = S2 + r * d.LS;
      const float* brow =
          bias + ((size_t)b * Tb + ((d.bias_rows && t < d.T) ? t : 0)) * d.S;
      float p[MAXG][4], dp[MAXG][4];
      softmax_row(row1, brow, d.S, d.Sp, scale, sub, lpr, p);
      float delta = 0.f;
      uint32_t keep[MAXG];
#pragma unroll
      for (int gi = 0; gi < MAXG; ++gi) {
        const int s0 = gi * 4 * lpr + sub * 4;
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        keep[gi] = 0xfu;
        if (s0 < d.Sp) {
          x = *reinterpret_cast<const float4*>(row2 + s0);
          if (drop) keep[gi] = keep_bits(s0, t, h, b, k0, k1, threshold);
        }
        const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool kept = (keep[gi] >> j) & 1u;
          const bool live = (s0 + j) < d.S;
          dp[gi][j] = (live && kept) ? (drop ? xs[j] / keep_prob : xs[j]) : 0.f;
          delta += dp[gi][j] * p[gi][j];
        }
      }
      delta = row_sum(delta, lpr);
      __syncwarp();  // all fp32 reads of both rows are done before the bf16 writes
      bf16* prow = reinterpret_cast<bf16*>(row1);
      bf16* drow = reinterpret_cast<bf16*>(row2);
#pragma unroll
      for (int gi = 0; gi < MAXG; ++gi) {
        const int s0 = gi * 4 * lpr + sub * 4;
        if (s0 < d.Sp) {
          float pd[4], ds[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const bool kept = (keep[gi] >> j) & 1u;
            pd[j] = kept ? (drop ? p[gi][j] / keep_prob : p[gi][j]) : 0.f;
            ds[j] = p[gi][j] * (dp[gi][j] - delta);
            if (t < d.T) colsum[gi][j] += ds[j];
          }
          split_store(prow + s0, prow + lo_off + s0, pd);
          split_store(drow + s0, drow + lo_off + s0, ds);
          if (db_part != nullptr && d.bias_rows && t < d.T) {
            float* dst = db_part + (((size_t)b * d.H + h) * d.T + t) * d.S;
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (s0 + j < d.S) dst[s0 + j] = ds[j];
          }
        }
      }
    }
    __syncthreads();

    const bf16* Pd = reinterpret_cast<const bf16*>(S1);
    const bf16* Ds = reinterpret_cast<const bf16*>(S2);
    const int ntn = d.D / 16;
    // dq tile [TQ, D] = ds [TQ, Sp] . K [Sp, D] * scale
    for (int tile = warp; tile < (TQ / 16) * ntn; tile += WARPS) {
      const int tm = tile % (TQ / 16), tn = tile / (TQ / 16);
      Acc acc;
      wmma::fill_fragment(acc, 0.0f);
      mma_row(acc, Ds + tm * 16 * ldp, Ds + tm * 16 * ldp + lo_off, ldp, Ks + tn * 16,
              d.ldk, d.Sp);
      emit_tile(acc, patch, scale, dq, nullptr, 0, t0 + tm * 16, tn * 16, d.T, d.H, d.D,
                b, h);
    }
    // dv [Sp, D] += drop(p)^T [Sp, TQ] . g [TQ, D];  dk += ds^T . Q * scale
    const int mode = (n_qt == 1) ? 0 : (qt == 0 ? 1 : 2);
    const int nsm = d.Sp / 16;
    for (int tile = warp; tile < 2 * nsm * ntn; tile += WARPS) {
      const int which = tile / (nsm * ntn);          // 0: dv, 1: dk
      const int rest = tile - which * nsm * ntn;
      const int tm = rest % nsm, tn = rest / nsm;
      const bf16* A = which == 0 ? Pd : Ds;
      const bf16* Bm = which == 0 ? Gs : Qs;
      Acc acc;
      wmma::fill_fragment(acc, 0.0f);
      mma_col(acc, A + tm * 16, A + lo_off + tm * 16, ldp, Bm + tn * 16, d.ldk, TQ);
      emit_tile(acc, patch, which == 0 ? 1.0f : scale, which == 0 ? dv : dk,
                dkv_acc + (which == 0 ? 0 : kv_elems), mode, tm * 16, tn * 16, d.S, d.H,
                d.D, b, h);
    }
  }

  if (n_qt > 1) {
    __syncthreads();  // the block's own fp32 accumulations are visible
    const int vecs = d.D >> 3;
    for (int i = threadIdx.x; i < d.S * vecs; i += THREADS) {
      const int s = i / vecs, c = (i - s * vecs) << 3;
      const size_t off = (((size_t)b * d.S + s) * d.H + h) * d.D + c;
#pragma unroll
      for (int which = 0; which < 2; ++which) {
        const float* src = dkv_acc + which * kv_elems + off;
        __align__(16) bf16 vals[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) vals[j] = __float2bfloat16(src[j]);
        *reinterpret_cast<uint4*>((which == 0 ? dv : dk) + off) =
            *reinterpret_cast<const uint4*>(vals);
      }
    }
  }

  if (db_part != nullptr && !d.bias_rows) {
    // Sum the column sums of the warps' row groups, in order, through S1
    // (free by now).
    __syncthreads();
    float* ws = S1;  // [WARPS * rpw, Sp]; WARPS * rpw * Sp <= TQ * LS
    const int group = warp * rpw + lane / lpr;
#pragma unroll
    for (int gi = 0; gi < MAXG; ++gi) {
      const int s0 = gi * 4 * lpr + sub * 4;
      if (s0 < d.Sp) {
#pragma unroll
        for (int j = 0; j < 4; ++j) ws[group * d.Sp + s0 + j] = colsum[gi][j];
      }
    }
    __syncthreads();
    for (int s = threadIdx.x; s < d.S; s += THREADS) {
      float acc = 0.f;
      for (int w = 0; w < WARPS * rpw; ++w) acc += ws[w * d.Sp + s];
      db_part[((size_t)b * d.H + h) * d.S + s] = acc;
    }
  }
}

// dbias[b, r] = sum over heads, ascending, of part[b, h, r]; r runs over the
// Tb * S entries of one batch row's bias.
__global__ void __launch_bounds__(THREADS)
dbias_reduce(const float* __restrict__ part, float* __restrict__ dbias, int B, int H,
             size_t row) {
  const size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= (size_t)B * row) return;
  const size_t b = i / row, r = i - b * row;
  float acc = 0.f;
  for (int h = 0; h < H; ++h) acc += part[(b * H + h) * row + r];
  dbias[i] = acc;
}

inline int round16(int x) { return (x + 15) / 16 * 16; }

// Dynamic shared memory of a block, for score rows of LS floats.
inline size_t fwd_smem(int Sp, int D, int LS) {
  const int ldk = D + PADK;
  return (size_t)TQ * LS * 4 + (size_t)(TQ + Sp) * ldk * 2 + WARPS * PATCH * 4;
}

inline size_t bwd_smem(int Sp, int D, int LS) {
  const int ldk = D + PADK;
  return (size_t)2 * TQ * LS * 4 + (size_t)2 * (TQ + Sp) * ldk * 2 + WARPS * PATCH * 4;
}

constexpr size_t SMEM_LIMIT = 232448;  // 227 KB a block on sm_90

inline bool make_dims(Dims& d, int B, int T, int S, int H, int D, int bias_rows,
                      bool backward) {
  d.B = B; d.T = T; d.S = S; d.H = H; d.D = D;
  d.Sp = round16(S);
  d.ldk = D + PADK;
  d.bias_rows = bias_rows;
  // A row fits the registers of a warp: 32 lanes x MAXG groups x 4 columns;
  // heads and batch rows are the grid's y and z (at most 65535 each).
  if (B < 1 || T < 1 || S < 1 || H < 1 || B > 65535 || H > 65535 || D < 16 ||
      D % 16 != 0 || d.Sp > MAXG * 128)
    return false;
  // Score rows are padded by 8 floats against bank conflicts where that fits.
  d.LS = d.Sp + 8;
  size_t need = backward ? bwd_smem(d.Sp, D, d.LS) : fwd_smem(d.Sp, D, d.LS);
  if (need > SMEM_LIMIT) {
    d.LS = d.Sp;
    need = backward ? bwd_smem(d.Sp, D, d.LS) : fwd_smem(d.Sp, D, d.LS);
  }
  return need <= SMEM_LIMIT;
}

}  // namespace

// 1 if the forward (backward == 0) or the backward kernel takes this shape,
// else 0. ops/train_attention.py::fused_attention_supported repeats this
// arithmetic so that it answers without a build; the smoke test holds the
// two against each other.
extern "C" int itt_fused_attn_supported(int B, int T, int S, int H, int D, int backward) {
  Dims d;
  return make_dims(d, B, T, S, H, D, 0, backward != 0) ? 1 : 0;
}

extern "C" int itt_fused_attn_fwd_bf16(const void* q, const void* k, const void* v,
                                       const void* bias, void* out, int B, int T, int S,
                                       int H, int D, int bias_rows, float scale,
                                       float keep_prob, unsigned threshold,
                                       unsigned seed_lo, unsigned seed_hi, void* stream) {
  Dims d;
  if (!make_dims(d, B, T, S, H, D, bias_rows, false)) return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem(d.Sp, D, d.LS);
  cudaError_t err = cudaFuncSetAttribute(
      fused_attn_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + TQ - 1) / TQ, H, B);
  fused_attn_fwd<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(bias),
      static_cast<bf16*>(out), d, scale, keep_prob, threshold, seed_lo, seed_hi);
  return (int)cudaGetLastError();
}

// dkv_acc: fp32 scratch [2, B, S, H, D], needed when T > 64 (else may be null).
// db_part / dbias: null unless dbias is wanted; db_part is [B, H, Tb, S] fp32.
extern "C" int itt_fused_attn_bwd_bf16(const void* q, const void* k, const void* v,
                                       const void* bias, const void* g, void* dq, void* dk,
                                       void* dv, void* dkv_acc, void* db_part, void* dbias,
                                       int B, int T, int S, int H, int D, int bias_rows,
                                       float scale, float keep_prob, unsigned threshold,
                                       unsigned seed_lo, unsigned seed_hi, void* stream) {
  Dims d;
  if (!make_dims(d, B, T, S, H, D, bias_rows, true)) return (int)cudaErrorInvalidValue;
  if (T > TQ && dkv_acc == nullptr) return (int)cudaErrorInvalidValue;
  if ((db_part == nullptr) != (dbias == nullptr)) return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem(d.Sp, D, d.LS);
  cudaError_t err = cudaFuncSetAttribute(
      fused_attn_bwd, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(H, B);
  fused_attn_bwd<<<grid, THREADS, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(bias),
      static_cast<const bf16*>(g), static_cast<bf16*>(dq), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), static_cast<float*>(dkv_acc), static_cast<float*>(db_part),
      d, scale, keep_prob, threshold, seed_lo, seed_hi);
  err = cudaGetLastError();
  if (err != cudaSuccess || dbias == nullptr) return (int)err;
  const size_t row = (size_t)(bias_rows ? T : 1) * S;
  const size_t total = (size_t)B * row;
  dbias_reduce<<<(unsigned)((total + THREADS - 1) / THREADS), THREADS, 0, st>>>(
      static_cast<const float*>(db_part), static_cast<float*>(dbias), B, H, row);
  return (int)cudaGetLastError();
}
