// Deterministic flash attention (forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of imagetranslate_tpu/ops/flash_attention.py
// (`_kernel` :47 behind `flash_attention` :97): softmax(Q K^T * scale + bias) V
// without dropout, with the online softmax over tiles of keys, so that the
// [T, S] scores never reach device memory. Arithmetic as the TPU kernel's: q
// is scaled in fp32 and rounded to bf16; scores accumulate in fp32 and take
// the fp32 bias; a running row maximum m (from -1e30) and denominator l; the
// fp32 accumulator is rescaled by exp(m_prev - m_cur); p = exp(s - m_cur) is
// rounded to bf16 un-normalised before the product with V; the division by l
// comes last. The bias is additive (-10000 at padded keys, never -inf), so a
// fully padded row gives finite, near-uniform weights.
//
// What bounds it: operations. At B=8, T=S=2048, H=12, D=64 the two products
// are 4 B H T S D = 103 GFLOP (0.104 ms at 989 TFLOP/s) over 101 MB of q, k,
// v and out (0.030 ms at 3.35 TB/s); the plain version moves 1.6 GB of fp32
// scores besides. So scores, probabilities and the output accumulator stay in
// registers from the first product to the second, and the [B, T, H, D] layout
// is read directly (no transposed copies). One block per (128-query tile,
// head, batch row); eight warps, each owning 16 query rows, so the row
// statistics never leave a quad of lanes; keys and values stream through
// shared memory 64 at a time, the next tile's cp.async copies in flight while
// this tile is multiplied (two stages, one barrier a tile). Both products are
// mma.sync m16n8k16 (bf16 in, fp32 accumulate) fed by ldmatrix: the score
// accumulators of two neighbouring 8-key tiles are, element for element, the
// A operand of the second product's 16-key step, so p is rounded to bf16 in
// place. A ragged last key tile and a ragged last query tile are masked here.
// wgmma, TMA and warp specialisation are later work.
//
// Plain C interface, loaded with ctypes (imagetranslate_tpu_torch/ops/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TQ = 128;           // query rows a block
constexpr int TK = 64;            // keys a tile
constexpr int WARPS = TQ / 16;    // a warp owns 16 query rows
constexpr int THREADS = WARPS * 32;
constexpr int PAD = 8;            // bf16 row padding: ldmatrix without bank conflicts
constexpr int STAGES = 2;         // K/V tiles in shared memory

template <int D>
constexpr size_t smem_bytes() {
  return (size_t)(TQ + 2 * STAGES * TK) * (D + PAD) * sizeof(bf16)  // Q; K, V stages
         + (size_t)STAGES * TK * sizeof(float);                     // bias of a tile
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared without passing through registers; zero-filled
// when `valid` is false (`src` must still be an address inside the tensor).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(n));
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

// Keys [row0, row0 + TK) of the (b, h) slice of a [B, S, H, D] tensor into
// shared memory by cp.async, rows past S zero-filled (a product with a zero
// row adds nothing; garbage could be NaN).
template <int D>
__device__ __forceinline__ void load_kv_tile(const bf16* __restrict__ src, bf16* dst, int row0,
                                             int S, int H, int b, int h) {
  constexpr int VECS = D / 8, LD = D + PAD;
  for (int i = threadIdx.x; i < TK * VECS; i += THREADS) {
    const int r = i / VECS, c = (i - r * VECS) * 8;
    const int row = row0 + r;
    const bool valid = row < S;
    const size_t at = (((size_t)b * S + (valid ? row : S - 1)) * H + h) * D + c;
    cp_async16(dst + r * LD + c, src + at, valid);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_attn_fwd(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const float* __restrict__ bias,
               bf16* __restrict__ out, int T, int S, int H, long long bias_stride,
               float scale) {
  constexpr int LD = D + PAD, KD = D / 16, ND = D / 8, NS = TK / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + TQ * LD;                  // STAGES tiles
  bf16* Vs = Ks + STAGES * TK * LD;         // STAGES tiles
  float* Bs = reinterpret_cast<float*>(Vs + STAGES * TK * LD);

  const int t0 = blockIdx.x * TQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  auto load_bias = [&](int stage, int s0) {
    if (threadIdx.x < TK) {
      const int s = s0 + threadIdx.x;
      Bs[stage * TK + threadIdx.x] =
          (bias != nullptr && s < S) ? bias[(size_t)b * bias_stride + s] : 0.0f;
    }
  };

  // The first K/V tile is on its way while the query tile is scaled in fp32,
  // rounded to bf16 and stored (rows past T as zeros).
  load_kv_tile<D>(k, Ks, 0, S, H, b, h);
  load_kv_tile<D>(v, Vs, 0, S, H, b, h);
  cp_async_commit();
  load_bias(0, 0);
  for (int i = threadIdx.x; i < TQ * (D / 8); i += THREADS) {
    const int r = i / (D / 8), c = (i - r * (D / 8)) * 8;
    const int row = t0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < T) {
      val = *reinterpret_cast<const uint4*>(q + (((size_t)b * T + row) * H + h) * D + c);
      bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(__bfloat162float(e[j]) * scale);
    }
    *reinterpret_cast<uint4*>(Qs + r * LD + c) = val;
  }
  __syncthreads();

  // A warp whose 16 rows all lie past T only helps with the loads.
  const bool active = t0 + warp * 16 < T;
  uint32_t qf[KD][4];
  if (active) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      ldmatrix_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
  }

  float o[ND][4];
#pragma unroll
  for (int dn = 0; dn < ND; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.0f;
  // Rows g and g + 8 of the warp's 16: their running maximum and denominator,
  // the same in the four lanes of a quad.
  float m_run[2] = {-1e30f, -1e30f}, l_run[2] = {0.0f, 0.0f};

  const int n_tiles = (S + TK - 1) / TK;
  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1, s0 = it * TK;
    // Tile `it` has landed, and every warp is done with tile `it - 1`, whose
    // stage the next tile's copies now overwrite.
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < n_tiles) {
      load_kv_tile<D>(k, Ks + (stage ^ 1) * TK * LD, s0 + TK, S, H, b, h);
      load_kv_tile<D>(v, Vs + (stage ^ 1) * TK * LD, s0 + TK, S, H, b, h);
      cp_async_commit();
      load_bias(stage ^ 1, s0 + TK);
    }
    if (!active) continue;
    const bf16* Kt = Ks + stage * TK * LD;
    const bf16* Vt = Vs + stage * TK * LD;
    const float* Bt = Bs + stage * TK;

    // scores[16, 64] = q_scaled . K^T, fp32 accumulation; two 8-key tiles a load.
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        uint32_t kf[4];
        ldmatrix_x4(kf, Kt + (j * 8 + (lane >> 4) * 8 + (lane & 7)) * LD + kk * 16 +
                            ((lane >> 3) & 1) * 8);
        mma16816(s[j], qf[kk], kf[0], kf[1]);
        mma16816(s[j + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // Online softmax of rows g and g + 8. Only the last tile can hold keys
    // past S: they take no part (a score of -1e30 gives p = 0 below, since
    // the tile's first key is real and bounds the maximum from below).
    if (bias != nullptr) {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float2 bv = *reinterpret_cast<const float2*>(Bt + j * 8 + 2 * t);
        s[j][0] += bv.x; s[j][1] += bv.y;
        s[j][2] += bv.x; s[j][3] += bv.y;
      }
    }
    if (s0 + TK > S) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (s0 + j * 8 + 2 * t + (e & 1) >= S) s[j][e] = -1e30f;
    }
    float mx[2] = {-1e30f, -1e30f};
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
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = __expf(s[j][e] - m_run[e >> 1]);
        sum[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l_run[r] = l_run[r] * corr[r] + sum[r];
    }

    // acc = acc * corr + p . V, p rounded to bf16 where it lies.
#pragma unroll
    for (int dn = 0; dn < ND; ++dn) {
      o[dn][0] *= corr[0]; o[dn][1] *= corr[0];
      o[dn][2] *= corr[1]; o[dn][3] *= corr[1];
    }
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      uint32_t pf[4];
      pf[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pf[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pf[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pf[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dn = 0; dn < ND; dn += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, Vt + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD + dn * 8 +
                                  (lane >> 4) * 8);
        mma16816(o[dn], pf, vf[0], vf[1]);
        mma16816(o[dn + 1], pf, vf[2], vf[3]);
      }
    }
  }

  // out = acc / l, two neighbouring columns a store.
  if (!active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = t0 + warp * 16 + g + 8 * r;
    if (row >= T) continue;
    bf16* dst = out + (((size_t)b * T + row) * H + h) * D + 2 * t;
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)
      *reinterpret_cast<uint32_t*>(dst + dn * 8) =
          pack_bf16(o[dn][2 * r] / l_run[r], o[dn][2 * r + 1] / l_run[r]);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* bias, void* out, int B,
           int T, int S, int H, long long bias_stride, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_fwd<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + TQ - 1) / TQ, H, B);
  flash_attn_fwd<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(bias), static_cast<bf16*>(out), T, S, H, bias_stride, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out [B, T, H, D]; k, v [B, S, H, D], bf16, contiguous; bias null or fp32
// with bias[b * bias_stride + s] the bias of key s in batch row b. D is 32, 64
// or 128; heads and batch rows are the grid's y and z (at most 65535 each).
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
