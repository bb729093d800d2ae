// Beam decode cross-attention over deduplicated encoder K/V, for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: the JAX package computes this step in XLA
// einsums (imagetranslate_tpu/models/transformer.py,
// `Attention.cross_step_dedup`). For query row r = b K + k of q [R, H, D]
// (R = B K: the K beams of source b) and head h, over the S positions of the
// encoder K/V ek / ev [B, S, H, D], stored once a source:
//   s = (q . k) * scale accumulated in fp32 from bf16 operands, then plus the
//   source's fp32 bias [B, S] (every one of the S positions is read and its
//   bias added, padded or not); an fp32 softmax over the S positions;
//   p = bf16(e / sum) with the whole row's sum; ctx = sum p * v accumulated in
//   fp32 and rounded to bf16 last.
// That is the rounding order of the plain path (ops/attention.py,
// plain_attention): no online rescaling before p is rounded.
//
// What bounds it: bytes. A source's K and V (2 S H D bf16) serve its K beams'
// 4 K S H D operations: about K operations a byte, where the card needs 295
// before its tensor cores set the pace. The per-beam path it replaces read K
// copies of them and made fp32 and transposed copies besides. So the design
// reads each source's lines from device memory once and serves every beam
// from shared memory:
// - A unit is one source and a group of hg heads (hg D <= 256 channels).
//   Blocks stay resident (as many as the SMs hold at once) and walk units. A
//   unit's K lines, then its V lines, come in tiles of up to `spos` positions
//   by bulk copies (cp.async.bulk), one a position line of the group (hg D
//   bf16, contiguous in ek / ev), into a ring of `depth` slots (2 to 4) with a
//   full and an empty mbarrier each. A producer warp issues the copies as
//   slots are released, running ahead across units; 8 consumer warps do the
//   products. The copy engine takes a line every ~60-75 cycles, so issuing
//   ~100 lines a unit from a warp that also computes held every other warp
//   at the block's barriers for most of the unit (clock64 readings on the
//   card): the producer keeps the engine busy while the products run. A
//   slot's lines lie 16 bytes further apart than their width, so that the 8
//   lines an ldmatrix reads fall in 8 bank groups.
// - Products on mma.sync m16n8k16 (bf16 operands, fp32 accumulators), the
//   beams as the 8 columns: scores C[16 positions x 8 beams] = K rows . q^T,
//   and ctx^T[16 channels x 8 beams] = V^T (ldmatrix.trans) . p^T, the
//   accumulators in registers over all of a unit's V tiles. More than 8 beams
//   take further column tiles.
// - Nothing but the lines is read from device memory inside a unit's phases:
//   q's rows ride with the unit's first K tile (a bulk copy a beam), and the
//   next unit's bias comes into shared memory by cp.async during this one, so
//   the products wait on no global load (read inside each unit, they took
//   twice the loads' time).
// - The scores stay on chip (fp32 [hg, K, S] beside the ring, p as bf16 beside
//   them, rows padded so that a warp's stores and fragment reads meet no bank
//   twice) or, where they outgrow shared memory (long sources), in a scratch
//   that the wrapper allocates.
// The plan (heads a unit, positions a tile, ring depth, scratch) is
// ops/cross_attention.py::work_plan; `plan` below is the same arithmetic, and
// the C entry refuses any other.
//
// Plain C interface, loaded with ctypes (imagetranslate_tpu_torch/ops/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int WARPS = 8;                     // consumer warps
constexpr int CONSUMERS = 32 * WARPS;
constexpr int THREADS = CONSUMERS + 32;      // and a producer warp
constexpr int MAX_D = 128;
constexpr int MAX_CHANNELS = 256;            // hg D a unit
constexpr int MAX_UNITS = 32;                // (beam tile, head, 16 channels) a unit
constexpr int UNITS_PER_WARP = MAX_UNITS / WARPS;
constexpr int STAGE_BYTES = 40960;           // a slot's lines, at most, in whole 16s
constexpr int MAX_DEPTH = 4;                 // ring slots
constexpr long long HALF_SMEM = 115712;      // two blocks an SM: 228 KB, 1 KB each kept
constexpr long long SMEM_LIMIT = 232448;     // 227 KB a block

struct Plan {
  int hg;          // heads a unit (0: no plan)
  int spos;        // positions a tile, at most
  int depth;       // ring slots
  int scratch;     // scores in the scratch
  long long smem;  // dynamic shared memory a block
};

// A score row's pitch (fp32, 4 mod 32 words: the 4 beams of a store's lanes
// fall in other banks) and a p row's (bf16, 8 mod 64: the 8 beams of a
// fragment read do), for S positions rounded up to 16.
__host__ __device__ __forceinline__ int score_pitch(int S) {
  const int sp = (S + 15) / 16 * 16;
  return (sp - 4 + 31) / 32 * 32 + 4;
}
__host__ __device__ __forceinline__ int p_pitch(int S) {
  const int sp = (S + 15) / 16 * 16;
  return (sp - 8 + 63) / 64 * 64 + 8;
}

// The work plan (ops/cross_attention.py: work_plan, the same arithmetic): the
// most heads a unit that keep hg D <= 256 and the PV pass's units within 32,
// with the deepest ring (4, 3, then 2 slots), first where two blocks fit an
// SM, then where one does; else the most heads with the scores in the
// scratch. Shared memory: the ring, two units' q rows, then (without the
// scratch) two units' bias, the scores and p, then the full and empty
// barriers.
Plan plan(int K, int S, int H, int D) {
  const int nbt = (K + 7) / 8, dt = (D + 15) / 16, sp = (S + 15) / 16 * 16;
  Plan p = {0, 0, 0, 0, 0};
  for (int pass = 0; pass < 3; ++pass) {
    for (int hg = H; hg >= 1; --hg) {
      if (H % hg != 0 || hg * D > MAX_CHANNELS || hg * dt * nbt > MAX_UNITS) continue;
      const int pitch = hg * D * 2 + 16;
      int spos = STAGE_BYTES / pitch / 16 * 16;
      if (spos < 16) spos = 16;
      const long long st = S < spos ? S : spos;
      const long long scores =
          8LL * sp + (long long)hg * K * (4LL * score_pitch(S) + 2LL * p_pitch(S));
      for (int depth = MAX_DEPTH; depth >= 2; --depth) {
        const long long fixed = depth * st * pitch + 2LL * K * pitch + 16LL * MAX_DEPTH;
        if (pass < 2 && fixed + scores > (pass == 0 ? HALF_SMEM : SMEM_LIMIT)) continue;
        if (pass == 2 && fixed > SMEM_LIMIT) continue;
        p.hg = hg;
        p.spos = spos;
        p.depth = depth;
        p.scratch = pass == 2;
        p.smem = fixed + (pass == 2 ? 0 : scores);
        return p;
      }
    }
  }
  return p;
}

struct Args {
  const bf16* q;        // [B K, H, D]
  const bf16* k;        // [B, S, H, D]
  const bf16* v;
  const float* bias;    // [B, S] or null
  bf16* out;            // [B K, H, D]
  float* scratch;       // B H K (4 score_pitch + 2 p_pitch) bytes, or null
  int B, K, S, H, D, hg, spos, depth, scratch_on;
  float scale;
};

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a b, m16n8k16, bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragment coordinates (m16n8k16): lane l holds A rows g = l / 4 and g + 8 at
// columns 2 t, 2 t + 1 (+ 8, + 9), t = l % 4; B rows 2 t, 2 t + 1 (+ 8, + 9) of
// column g; C rows g and g + 8 at columns 2 t, 2 t + 1. ldmatrix takes the
// row addresses of its four 8 x 8 matrices from lanes 0-7, 8-15, 16-23, 24-31.
__global__ void __launch_bounds__(THREADS, 2) cross_attn_dedup_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int K = a.K, S = a.S, H = a.H, D = a.D, hg = a.hg, depth = a.depth;
  const int G = H / hg;
  const int seg = hg * D * 2, pitch = seg + 16;
  const int st = min(S, a.spos);               // positions a tile (the last may hold fewer)
  const int nt = (S + st - 1) / st;
  const int per_unit = 2 * nt;                 // K's tiles, then V's
  const int sp = (S + 15) / 16 * 16;           // positions a row, rounded up to 16
  const int scp = score_pitch(S), pp = p_pitch(S);
  const int nbt = (K + 7) / 8, dt = (D + 15) / 16;
  const int slot_bytes = st * pitch;
  const uint32_t ring = smem_u32(smem);
  const long long rows = (long long)hg * K;    // (head, beam) rows of a unit
  // This block's units: blockIdx.x, + gridDim.x, ...; stage i of the walk is
  // stage i % per_unit of unit i / per_unit, in slot i % depth.
  const int all_units = a.B * G;
  const int units = (all_units - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int total = units * per_unit;

  // Shared memory: the ring; q's K rows of the group for two units (the pitch
  // of a line); unless they live in the scratch, two units' bias [sp], the
  // scores (fp32 [hg, K, scp]) and p (bf16 [hg, K, pp]); the barriers.
  const uint32_t qarea = ring + depth * slot_bytes;
  int off = depth * slot_bytes + 2 * K * pitch;
  float* sbias = nullptr;
  float* sc_smem = nullptr;
  bf16* pb_smem = nullptr;
  if (!a.scratch_on) {
    sbias = reinterpret_cast<float*>(smem + off);
    sc_smem = sbias + 2 * sp;
    pb_smem = reinterpret_cast<bf16*>(sc_smem + rows * scp);
    off += (int)(8 * sp + rows * (4LL * scp + 2LL * pp));
  }
  const uint32_t full = ring + off;             // a slot's lines landed
  const uint32_t empty = full + 8 * MAX_DEPTH;   // every consumer warp is done with it

  if (threadIdx.x == 0) {
    for (int i = 0; i < depth; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // The 16 bytes past each line: the last head's channels D .. D + 7 where
  // D % 16 == 8, read by the last k-step and multiplied by zeros. Zero, so that
  // they are finite.
  for (int i = threadIdx.x; i < depth * st; i += THREADS)
    *reinterpret_cast<uint4*>(smem + i * pitch + seg) = make_uint4(0u, 0u, 0u, 0u);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // Stage i into slot i % depth, by the producer: lane 0 arms the slot's barrier
  // with the tile's bytes (and, for a unit's first, q's), the lanes copy a
  // line each in turn (and q's row of each beam, into the unit's q area).
  auto issue = [&](int i) {
    const int j = i / per_unit, w = i - j * per_unit;
    const int unit = (int)blockIdx.x + j * (int)gridDim.x;
    const int b = unit / G, h0 = (unit % G) * hg;
    const bool is_v = w >= nt;
    const int s0 = (is_v ? w - nt : w) * st, n = min(st, S - s0);
    const bf16* src = (is_v ? a.v : a.k) + (((long long)b * S + s0) * H + h0) * D;
    const int slot = i % depth;
    const uint32_t dst = ring + slot * slot_bytes, bar = full + 8 * slot;
    if (lane == 0) mbar_expect_tx(bar, (uint32_t)(n + (w == 0 ? K : 0)) * seg);
    __syncwarp();
    for (int u = lane; u < n; u += 32)
      bulk_load(dst + u * pitch, src + (long long)u * H * D, (uint32_t)seg, bar);
    if (w == 0)
      for (int k = lane; k < K; k += 32)
        bulk_load(qarea + ((j & 1) * K + k) * pitch, a.q + (((long long)b * K + k) * H + h0) * D,
                  (uint32_t)seg, bar);
  };
  if (warp == WARPS) {
    // The producer: stage i once every consumer warp has released what its
    // slot held (stage i - depth).
    for (int i = 0; i < total; ++i) {
      if (i >= depth) mbar_wait(empty + 8 * (i % depth), (uint32_t)((i / depth - 1) & 1));
      issue(i);
    }
    return;
  }
  // The consumers' own barrier (the producer is not in it).
  auto consumers_sync = [] { bar_sync(1, CONSUMERS); };
  // A unit's bias into its area (j & 1) of shared memory, by every consumer.
  auto fetch_bias = [&](int j) {
    if (!sbias || !a.bias || j >= units) return;
    const int unit = (int)blockIdx.x + j * (int)gridDim.x;
    const float* src = a.bias + (long long)(unit / G) * S;
    for (int p = threadIdx.x; p < S; p += CONSUMERS)
      cp_async4(smem_u32(sbias + (j & 1) * sp + p), src + p);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  fetch_bias(0);

  const int pv_units = nbt * hg * dt;
  int i = 0;                                   // the walk's stage
  for (int j = 0; j < units; ++j) {
    const int unit = (int)blockIdx.x + j * (int)gridDim.x;
    const int b = unit / G, h0 = (unit % G) * hg;
    float* sc = a.scratch_on ? a.scratch + unit * rows * scp : sc_smem;
    bf16* pb = a.scratch_on
                   ? reinterpret_cast<bf16*>(a.scratch + all_units * rows * scp) + unit * rows * pp
                   : pb_smem;
    const float* brow = a.bias ? a.bias + (long long)b * S : nullptr;
    if (sbias && brow) {
      // This unit's bias landed during the last one (every thread waits for
      // its own copies, the barrier shows them to all); the next unit's starts.
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      consumers_sync();
      brow = sbias + (j & 1) * sp;
      fetch_bias(j + 1);
    }
    const unsigned char* qunit = smem + depth * slot_bytes + (j & 1) * K * pitch;

    // The PV pass's units (beam tile, head, 16 channels), up to
    // UNITS_PER_WARP a warp: unit warp + WARPS m accumulates in acc[m] over
    // all the V tiles.
    float acc[UNITS_PER_WARP][4];
#pragma unroll
    for (int m = 0; m < UNITS_PER_WARP; ++m) acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;

    for (int w = 0; w < per_unit; ++w, ++i) {
      const int slot = i % depth;
      const bool is_v = w >= nt;
      const int s0 = (is_v ? w - nt : w) * st, n = min(st, S - s0);
      const uint32_t lines = ring + slot * slot_bytes;
      if (w == nt) {
        // Every warp's scores are in.
        consumers_sync();
        // Softmax in fp32 over each (head, beam) row, a warp a row: its max,
        // e = exp(s - max) in place and their sum, each lane over every 32nd
        // position and then the lanes in a fixed tree; p = bf16(e / sum),
        // zero past S (the PV pass reads p in whole 16s).
        for (int r = warp; r < rows; r += WARPS) {
          float* row = sc + (long long)r * scp;
          bf16* prow = pb + (long long)r * pp;
          float m = -INFINITY;
          for (int p = lane; p < S; p += 32) m = fmaxf(m, row[p]);
          for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
          float sum = 0.f;
          for (int p = lane; p < S; p += 32) {
            const float e = expf(row[p] - m);
            row[p] = e;
            sum += e;
          }
          for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
          for (int p = lane; p < sp; p += 32)
            prow[p] = __float2bfloat16_rn(p < S ? __fdiv_rn(row[p], sum) : 0.f);
        }
        consumers_sync();
      }
      mbar_wait(full + 8 * slot, (uint32_t)((i / depth) & 1));
      if (!is_v) {
        // Scores of the tile: units (beam tile, head, 16 positions). A = 16
        // position lines (rows past n read line n - 1 again and are
        // dropped), B = q^T of 8 beams from q's rows (zero past K and D).
        const int ptiles = (n + 15) / 16;
        const int score_units = nbt * hg * ptiles;
        for (int u = warp; u < score_units; u += WARPS) {
          const int pt = u % ptiles, h = (u / ptiles) % hg, bt = u / (ptiles * hg);
          const int row = min(pt * 16 + (lane & 15), n - 1);
          const uint32_t a_addr = lines + row * pitch + h * D * 2 + (lane >> 4) * 16;
          const int beam = bt * 8 + g;
          const unsigned char* qrow = qunit + beam * pitch + h * D * 2 + 4 * t4;
          float c[4] = {0.f, 0.f, 0.f, 0.f};
          for (int ks = 0; ks < dt; ++ks) {
            uint32_t af[4];
            ldsm_x4(a_addr + ks * 32, af);
            uint32_t b0 = 0u, b1 = 0u;
            if (beam < K) {
              b0 = *reinterpret_cast<const uint32_t*>(qrow + ks * 32);
              if (ks * 16 + 8 < D) b1 = *reinterpret_cast<const uint32_t*>(qrow + ks * 32 + 16);
            }
            mma_bf16(c, af, b0, b1);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int pos = pt * 16 + g + (e >> 1) * 8, kk = bt * 8 + 2 * t4 + (e & 1);
            if (pos < n && kk < K) {
              float x = __fmul_rn(c[e], a.scale);
              if (brow) x = __fadd_rn(x, brow[s0 + pos]);
              sc[((long long)h * K + kk) * scp + s0 + pos] = x;
            }
          }
        }
      } else {
        // p . V of the tile into each unit's accumulators: A = V^T (16
        // channels x 16 positions, ldmatrix.trans; positions past n read
        // line n - 1 again, where p is zero), B = p^T of 8 beams (zero past
        // K).
#pragma unroll
        for (int m = 0; m < UNITS_PER_WARP; ++m) {
          const int u = warp + WARPS * m;
          if (u < pv_units) {
            const int dtile = u % dt, h = (u / dt) % hg, bt = u / (dt * hg);
            const int beam = bt * 8 + g;
            const uint32_t col = h * D * 2 + (dtile * 2 + ((lane >> 3) & 1)) * 16;
            const bf16* prow = pb + ((long long)h * K + beam) * pp + s0 + 2 * t4;
            for (int pt = 0; pt * 16 < n; ++pt) {
              const int row = min(pt * 16 + (lane & 7) + ((lane >> 4) & 1) * 8, n - 1);
              uint32_t af[4];
              ldsm_x4_trans(lines + row * pitch + col, af);
              uint32_t b0 = 0u, b1 = 0u;
              if (beam < K) {
                b0 = *reinterpret_cast<const uint32_t*>(prow + pt * 16);
                b1 = *reinterpret_cast<const uint32_t*>(prow + pt * 16 + 8);
              }
              mma_bf16(acc[m], af, b0, b1);
            }
          }
        }
      }
      // Release the slot to the producer, which refills it with stage
      // i + depth (this unit's or a later one's). The fences order this
      // warp's reads of the slot before the bulk copies that overwrite it.
      __syncwarp();
      if (lane == 0) {
        __threadfence_block();
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(empty + 8 * slot);
      }
    }

    // ctx: C rows are channels dtile 16 + g (+ 8), columns beams bt 8 + 2 t
    // (+ 1).
#pragma unroll
    for (int m = 0; m < UNITS_PER_WARP; ++m) {
      const int u = warp + WARPS * m;
      if (u < pv_units) {
        const int dtile = u % dt, h = (u / dt) % hg, bt = u / (dt * hg);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = dtile * 16 + g + (e >> 1) * 8, kk = bt * 8 + 2 * t4 + (e & 1);
          if (d < D && kk < K)
            a.out[(((long long)b * K + kk) * H + h0 + h) * D + d] = __float2bfloat16_rn(acc[m][e]);
        }
      }
    }
  }
}

}  // namespace

// q [B K, H, D] (row b K + k: beam k of source b); k, v [B, S, H, D]; bias fp32
// [B, S] or null; out [B K, H, D]; scratch B H K (4 score_pitch(S) + 2
// p_pitch(S)) bytes when the plan says so, else null. bf16 but the bias and
// the scratch, all contiguous, the bf16 ones 16-byte aligned. (hg, spos,
// depth, use_scratch) must be work_plan's.
extern "C" int itt_cross_attn_bf16(const void* q, const void* k, const void* v, const void* bias,
                                   void* out, void* scratch, int B, int K, int S, int H, int D,
                                   float scale, int hg, int spos, int depth, int use_scratch,
                                   void* stream) {
  if (B < 1 || K < 1 || S < 1 || H < 1 || D < 8 || D > MAX_D || D % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (!q || !k || !v || !out) return (int)cudaErrorInvalidValue;
  const Plan p = plan(K, S, H, D);
  if (p.hg == 0 || hg != p.hg || spos != p.spos || depth != p.depth ||
      use_scratch != p.scratch || (p.scratch && !scratch) || p.smem > SMEM_LIMIT ||
      (long long)B * (H / p.hg) > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<bf16*>(out);
  a.scratch = p.scratch ? static_cast<float*>(scratch) : nullptr;
  a.B = B; a.K = K; a.S = S; a.H = H; a.D = D;
  a.hg = p.hg; a.spos = p.spos; a.depth = p.depth; a.scratch_on = p.scratch;
  a.scale = scale;
  if (p.smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(cross_attn_dedup_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)p.smem);
    if (err != cudaSuccess) return (int)err;
  }
  // As many blocks as the SMs hold at once, each walking its share of the
  // B H / hg units.
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cross_attn_dedup_kernel, THREADS,
                                                        (size_t)p.smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  long long blocks = (long long)B * (H / p.hg);
  if (blocks > (long long)sms * per_sm) blocks = (long long)sms * per_sm;
  cross_attn_dedup_kernel<<<(unsigned)blocks, THREADS, (size_t)p.smem,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
