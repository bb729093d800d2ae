// Beam decode self-attention, one query token a row, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of imagetranslate_tpu/ops/decode_attention.py
// (`_kernel` :76 behind `windowed_decode_attention` :188). For query row r of
// q [R, H, D] (R = B * K beams) and head h:
//   prefix   positions 0 .. t0-1 of physical row (r / K) * K + rowsel[r] of
//            main_k / main_v [R, ., H, D];
//   window   slots w = 0 .. wlive-1 of physical row (r / K) * K + wanc[r, w]
//            of win_k / win_v [R, W, H, D];
//   s = (q . k) * scale accumulated in fp32 from bf16 operands, an fp32
//   softmax over the t0 + wlive live positions, p = bf16(e / sum) with the
//   full row's sum, then ctx = sum p * v accumulated in fp32 and rounded to
//   bf16 last.
// A null row map reads row r itself: with both maps null and no window this
// is the step of a cache whose rows are reordered after every beam selection
// (the port's own cache). A row map is an index in a copy here, where the TPU
// kernel multiplies one-hot matrices (Mosaic cannot index sublanes at a
// dynamic offset); the dead window slots (w >= wlive), which the TPU kernel
// pushes down by -10000, are left out.
//
// What bounds it: bytes. Each live K and V element is read once (2 n H D bf16
// a row) against 4 n H D operations: 1 operation a byte, where the card needs
// 295 before its tensor cores set the pace. So the design aims at bytes in
// flight and few fixed costs a row:
// - A block owns a row over all its heads (a group of up to 12 heads), and
//   walks rows (the grid is what the SMs hold at once). A position is one
//   line of H D bf16 (1536 bytes at BERT width); a ring of `depth` stages of
//   `spos` lines (and q) in shared memory is filled by bulk copies
//   (cp.async.bulk), each stage completing on an mbarrier: one copy for a run
//   of prefix lines, one a line (the lanes in turn) for window slots or a
//   head group. The warp that is last done with a slot refills it at once,
//   with the next stage of the row or of the block's next row: K's stages,
//   then V's, then the next row's, so V and the next row are landing while
//   the softmax runs, and no warp waits for another to issue.
// - A warp owns a head (a share of its positions when a block has fewer than
//   8 heads) and takes 16 positions at a time on mma.sync (below): a few
//   instructions for 16 positions' dot products, where one lane per 8
//   channels would spend ~20 a position. A head's max and sum exp stay
//   inside its warp (shuffles), or its warps when it has several.
// - Few or long rows split their positions across a thread-block cluster of
//   C blocks (contiguous ranges): the blocks exchange each head's max, then
//   each head's sum exp(s - M), through distributed shared memory with a
//   cluster barrier between, so p is normalised by the whole row's sum before
//   it is rounded, as the contract says; each block's partial ctx is summed
//   over the cluster in rank order. Every sum runs in a fixed order: two
//   launches give the same bits.
// - Scores that outgrow shared memory (long rows of many heads) live in an
//   fp32 scratch [R, H, n] that the wrapper allocates.
// The plan (clusters, head groups, warps a head, positions a block, stage
// size and depth, scratch) is ops/decode_attention.py::work_plan; `plan`
// below is the same arithmetic, and the C entry refuses any other plan.
//
// Plain C interface, loaded with ctypes (imagetranslate_tpu_torch/ops/_build.py).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int MAX_D = 128;
constexpr int MAX_HEADS = 12;       // heads a block owns at most
constexpr int MAX_WARPS = 12;       // a warp a head, or
constexpr int FEW_WARPS = 8;        // about this many, a head's positions split
constexpr int SMS = 132;            // an H100's SMs
constexpr int WAVE = 2 * SMS;       // blocks a cluster split aims at
constexpr int STAGE_BYTES = 24576;  // a stage's lines, at most (twice that
                                    // when the blocks fit the SMs once), in
                                    // whole 16s, at least 16
constexpr int MAX_DEPTH = 4;
constexpr long long HALF_SMEM = 115712;   // two blocks an SM: 228 KB, 1 KB each kept
constexpr int MIN_RANGE = 256;      // positions a block of a cluster takes
constexpr int MAX_CLUSTER = 8;
constexpr long long SMEM_LIMIT = 232448;   // 227 KB a block

struct Plan {
  int clusters;   // C: blocks a row's positions are split across
  int groups;     // G: head groups, H / G heads a block
  int wph;        // warps a head
  int per;        // positions a block: ceil(n / C)
  int spos;       // positions a stage
  int depth;      // stages in the ring
  int scratch;    // scores in the fp32 scratch [R, H, n]
  long long smem; // dynamic shared memory a block
};

// The work plan (ops/decode_attention.py: work_plan, the same arithmetic).
Plan plan(long long R, int H, int D, int n) {
  Plan p;
  int g = 1;
  while (H % g != 0 || H / g > MAX_HEADS) ++g;
  p.groups = g;
  const int hg = H / g;
  p.wph = hg < FEW_WARPS ? FEW_WARPS / hg : 1;
  const int warps = hg * p.wph;
  const int seg = hg * D * 2;
  int c = 1;
  while (c < MAX_CLUSTER && R * g * c < WAVE && n >= 2 * c * MIN_RANGE) c *= 2;
  p.clusters = c;
  p.per = (n + c - 1) / c;
  // A stage holds a multiple of 16 positions (an mma's rows), lines side by
  // side as they lie in the cache.
  const int stage_bytes = R * g * c > SMS ? STAGE_BYTES : 2 * STAGE_BYTES;
  int spos = stage_bytes / seg / 16 * 16;
  if (spos > (p.per + 15) / 16 * 16) spos = (p.per + 15) / 16 * 16;
  if (spos < 16) spos = 16;
  p.spos = spos;
  // The ring: depth stages of spos lines, a q area of seg bytes and a pair of
  // barriers each; up to MAX_DEPTH stages, fewer (at least 2) where there
  // are more blocks than SMs and two would not fit one (HALF_SMEM each). The
  // scores stay in shared memory if they fit beside a ring of 2 or more
  // stages, else in the scratch.
  const long long others = 4LL * (2 * warps + 2 * hg) +
                           (c > 1 || p.wph > 1 ? 4LL * (warps + hg) * D : 0);
  const long long scores = 4LL * hg * p.per;
  // A block that walks rows keeps MAX_DEPTH stages (the next rows' land
  // during this one's); one that owns a cluster's share of a row needs no
  // more than its stages.
  int depth = c > 1 ? 2 * ((p.per + spos - 1) / spos) : MAX_DEPTH;
  if (depth > MAX_DEPTH) depth = MAX_DEPTH;
  const long long stage = (spos + 1LL) * seg + 16;
  while (depth > 2 && depth * stage + others > SMEM_LIMIT) --depth;
  // A shallower ring (down to 2) before the scratch, whose loads and stores
  // cost more than the depth.
  int shallow = depth;
  while (shallow > 2 && shallow * stage + others + scores > SMEM_LIMIT) --shallow;
  p.scratch = shallow * stage + others + scores > SMEM_LIMIT;
  if (!p.scratch) depth = shallow;
  const long long kept = p.scratch ? 0 : scores;
  while (R * g * c > SMS && depth > 2 && depth * stage + others + kept > HALF_SMEM) --depth;
  p.depth = depth;
  p.smem = depth * stage + others + kept;
  return p;
}

struct Args {
  const bf16* q;
  const bf16* main_k;
  const bf16* main_v;
  const bf16* win_k;
  const bf16* win_v;
  const int* rowsel;   // [R] or null
  const int* wanc;     // [R, W] or null
  bf16* out;
  float* scratch;      // [R, H, n] or null
  int R, K, H, D, t0, wlive, W;
  int hg;              // heads a block
  int clusters, groups, wph, per, spos, depth;
  long long main_stride, win_stride;   // elements between two rows
  float scale;
};

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
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
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The V pass's step m on acc[m] (rows 0..7) or, past NH, acc[m - NH] (rows
// 8..15): A's row j or j + 8 holds p of positions j and j + 8.
template <int NH>
__device__ __forceinline__ void step(float (&acc)[NH][4], int m, uint32_t a0, uint32_t a2,
                                     uint32_t b0, uint32_t b1) {
  if (m < NH)
    mma_bf16(acc[m], a0, 0u, a2, 0u, b0, b1);
  else
    mma_bf16(acc[m - NH], 0u, a0, 0u, a2, b0, b1);
}

// Where a block is: its unit (row r, head group g), and the live positions
// [first, first + nb) of the row that it owns.
struct Unit {
  int r, g, first, nb;
};

// Warp 0 fills a ring slot with stage `w` of a unit (K's stages 0 .. nst-1,
// then V's): lane 0 arms the slot's barrier with the stage's bytes (and, for
// a K stage, q's, which it brings into the slot's q area); a run of
// prefix lines of all the heads is one bulk copy, anything else one copy a
// line (the lanes in turn) of the group's seg bytes.
__device__ __forceinline__ void issue_stage(const Args& a, const Unit& t, int w, int nst,
                                            uint32_t slot, uint32_t qslot, uint32_t full_bar) {
  const int lane = threadIdx.x & 31;
  const bool is_v = w >= nst;
  const int u0 = (is_v ? w - nst : w) * a.spos;
  const int npos = min(a.spos, t.nb - u0);
  const int p0 = t.first + u0;          // live index of the stage's first line
  const uint32_t seg = (uint32_t)a.hg * a.D * 2;
  const long long line = (long long)a.H * a.D;
  const long long hoff = (long long)t.g * a.hg * a.D;
  const bf16* main = is_v ? a.main_v : a.main_k;
  const bf16* win = is_v ? a.win_v : a.win_k;
  const long long group_row = (long long)(t.r / a.K) * a.K;
  if (lane == 0) {
    mbar_expect_tx(full_bar, (uint32_t)npos * seg + (is_v ? 0u : seg));
    if (!is_v) bulk_load(qslot, a.q + (long long)t.r * line + hoff, seg, full_bar);
  }
  __syncwarp();
  if (a.groups == 1 && p0 + npos <= a.t0) {
    if (lane == 0) {
      const long long row = a.rowsel ? group_row + a.rowsel[t.r] : t.r;
      bulk_load(slot, main + row * a.main_stride + p0 * line, (uint32_t)npos * seg, full_bar);
    }
    return;
  }
  for (int u = lane; u < npos; u += 32) {
    const int p = p0 + u;
    const bf16* src;
    if (p < a.t0) {
      const long long row = a.rowsel ? group_row + a.rowsel[t.r] : t.r;
      src = main + row * a.main_stride + p * line + hoff;
    } else {
      const int wi = p - a.t0;
      const long long row = a.wanc ? group_row + a.wanc[(long long)t.r * a.W + wi] : t.r;
      src = win + row * a.win_stride + wi * line + hoff;
    }
    bulk_load(slot + u * seg, src, seg, full_bar);
  }
}

// The end of a unit. ctx: lane t's val[u] (acc[u][0..1], then acc[u - NH]
// [2..3]) holds chunk (u + t/4) % DC, channels fk, fk+1, summed over the
// positions k == t/4 mod 8. Add the 8 rows: at step o the partner row j ^ o
// holds the same chunk at index u -+ o, which it sends. Row 0's lanes (0..3)
// then hold chunk u at val[u]; then (split) the head's warps are summed in
// order, then the cluster's blocks in rank order.
template <int DC, int NH>
__device__ __forceinline__ void finish(const Args& a, const Unit& t, float (&acc)[NH][4],
                                       float* part, float* ctx, int rank, bool split, int fn,
                                       int fk) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int hg = a.hg, D = a.D, h = warp % hg, C = a.clusters, wph = a.wph;
  float val[DC][2];
#pragma unroll
  for (int u = 0; u < DC; ++u) {
    val[u][0] = u < NH ? acc[u][0] : acc[u - NH][2];
    val[u][1] = u < NH ? acc[u][1] : acc[u - NH][3];
  }
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) {
    const bool up = fn & o;
    float nxt[DC][2];
#pragma unroll
    for (int u = 0; u < DC; ++u) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float send = up ? val[((u - o) % DC + DC) % DC][e] : val[(u + o) % DC][e];
        nxt[u][e] = val[u][e] + __shfl_xor_sync(0xffffffffu, send, 4 * o);
      }
    }
#pragma unroll
    for (int u = 0; u < DC; ++u) val[u][0] = nxt[u][0], val[u][1] = nxt[u][1];
  }
  bf16* out = a.out + ((long long)t.r * a.H + (long long)t.g * hg) * D;
  if (!split) {
    if (lane < 4) {
#pragma unroll
      for (int u = 0; u < DC; ++u)
        *reinterpret_cast<uint32_t*>(out + h * D + 8 * u + fk) = pack_bf16(val[u][0], val[u][1]);
    }
    return;
  }
  if (lane < 4) {
#pragma unroll
    for (int u = 0; u < DC; ++u) {
      part[warp * D + 8 * u + fk] = val[u][0];
      part[warp * D + 8 * u + fk + 1] = val[u][1];
    }
  }
  __syncthreads();
  const int elems = hg * D;
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    float o = 0.f;
    for (int j = 0; j < wph; ++j) o += part[(j * hg + e / D) * D + e % D];
    if (C == 1)
      out[e] = __float2bfloat16_rn(o);
    else
      ctx[e] = o;
  }
  if (C == 1) {
    __syncthreads();   // part is written again at the next unit's end
    return;
  }
  // Block `rank` writes every C-th element; the last barrier keeps each
  // block's shared memory alive until the others have read it.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int e = rank + C * threadIdx.x; e < elems; e += C * blockDim.x) {
    float o = 0.f;
    for (int q = 0; q < C; ++q) o += cluster.map_shared_rank(ctx, q)[e];
    out[e] = __float2bfloat16_rn(o);
  }
  cluster.sync();
}

// DC = D / 8, the 16-byte chunks of a head. A warp takes 16 positions of
// its head at a time on mma m16n8k16 (bf16 operands, fp32 accumulators);
// the lines lie side by side in a slot, so the 8 rows an ldmatrix reads (8
// positions) would share their banks if they read the same chunk: row j reads
// chunk (m + j) % DC at step m instead, and the products undo the rotation:
// - K pass, step b: A = the 16 positions (rows) x chunks 2b, 2b+1 rotated by
//   the row; B column n = q's chunks 2b, 2b+1 rotated by n. Over the steps
//   C[j][j % 8] sums q . k of position j; the other columns are dropped.
// - V pass, step m: A[j][k] = p of position k where k % 8 == j (rows 0..7,
//   or rows 8..15 for the steps past NH = DC / 2, so that one set of 4
//   accumulators serves two steps); B = V's rows k, chunk (m + k) % DC
//   (ldmatrix.trans). Row j of step m then sums chunk (m + j) % DC of the
//   positions k == j mod 8; three shuffle steps at the row's end add the 8
//   rows back into each chunk.
// The tensor cores are used for their few instructions a product, not for
// their rate.
template <int DC>
__global__ void __launch_bounds__(32 * MAX_WARPS, DC <= 8 ? 2 : 1)
    decode_attn_kernel(const Args a) {
  constexpr int KS = (DC + 1) / 2;         // k-steps of the K pass
  constexpr int NH = (DC + 1) / 2;         // accumulator sets of the V pass
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int C = a.clusters, wph = a.wph, hg = a.hg, D = a.D;
  const int n = a.t0 + a.wlive;
  const int seg = hg * D * 2;
  const int h = warp % hg;                 // this warp's head (of the group)
  const int k = warp / hg;                 // its share of the head's positions
  const bool split = wph > 1 || C > 1;     // partial ctx summed across warps
  // Without a cluster a block walks units (row, head group) blockIdx.x,
  // + gridDim.x, ...; in a cluster it owns rank's share of one unit.
  const int rank = blockIdx.x % C;
  const int units = C > 1 ? 1 : (a.R * a.groups - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int first = rank * a.per;
  const int nb = min(a.per, n - first);    // the same for every unit
  const int nst = (nb + a.spos - 1) / a.spos;
  const int per_unit = 2 * nst;
  const int total = units * per_unit;
  auto unit = [&](int j) {
    const int u = C > 1 ? blockIdx.x / C : blockIdx.x + j * gridDim.x;
    return Unit{u / a.groups, u % a.groups, first, nb};
  };

  // Shared memory: the ring, its q areas, its full barriers and release
  // counts (8 bytes each), the scores (unless they live in the scratch),
  // each warp's (max, sum) and each head's (max, sum) for the cluster, then
  // each warp's partial ctx and the block's ctx.
  const uint32_t ring = smem_u32(smem);
  const int slot_bytes = a.spos * seg;
  const int ring_bytes = a.depth * slot_bytes;
  const uint32_t qring = ring + ring_bytes;
  const uint32_t full0 = qring + a.depth * seg;
  // A slot's count of warps done with it: the warp that completes a round
  // of the count refills the slot, so that no warp waits for the others.
  unsigned* done = reinterpret_cast<unsigned*>(smem + ring_bytes + a.depth * seg + 8 * a.depth);
  float* tail = reinterpret_cast<float*>(smem + ring_bytes + a.depth * seg + 16 * a.depth);
  float* s_smem = tail;
  if (!a.scratch) tail += hg * a.per;
  float* red_w = tail;                     // [2, nwarps]
  float* red_h = red_w + 2 * nwarps;       // [2, hg]
  float* part = red_h + 2 * hg;            // [nwarps, D] when split
  float* ctx = part + nwarps * D;          // [hg, D] when split

  if (threadIdx.x == 0) {
    for (int i = 0; i < a.depth; ++i) {
      mbar_init(full0 + 8 * i, 1);
      done[2 * i] = 0u;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == 0)
    for (int i = 0; i < min(a.depth, total); ++i)
      issue_stage(a, unit(i / per_unit), i % per_unit, nst, ring + i * slot_bytes,
                  qring + i * seg, full0 + 8 * i);

  // Fragment coordinates: lane t holds B column n = t / 4 and rows k = 2 (t %
  // 4), +1 (+8, +9); A rows j = t / 4 (+8) and columns 2 (t % 4), +1 (+8,
  // +9). For ldmatrix lane L gives row (L & 7) + 8 ((L >> 3) & 1) of the
  // tile, at the chunk its matrix L >> 4 (0: the step's first, 1: second)
  // rotates by L & 7.
  const int fn = lane >> 2, fk = 2 * (lane & 3);
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lrot = (lane & 7) + (lane >> 4);
  // acc[m] rows 0..7 collect the V pass's step m, rows 8..15 its step m + NH.
  float acc[NH][4];
  Unit t = unit(0);
  float* sh = nullptr;                     // this head's scores in this unit
  float rmax = -INFINITY;                  // the max of the scores this warp wrote
  float row_sum = 1.f;                     // the row's sum of exp(s - M)

  int w = 0, j = 0, slot = 0;              // stage i = j per_unit + w, in slot
  int round = 0;                           // i / depth: the slot's use
  uint32_t phase = 0;                      // of the slot's barrier
  for (int i = 0; i < total; ++i) {
    const uint32_t stage = ring + slot * slot_bytes;
    if (w == 0) {
      t = unit(j);
      sh = (a.scratch ? a.scratch + ((long long)t.r * a.H + (long long)t.g * hg) * n + first
                      : s_smem) +
           h * (a.scratch ? (long long)n : (long long)a.per);
#pragma unroll
      for (int m = 0; m < NH; ++m) acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;
      rmax = -INFINITY;
    }
    if (w == nst) {
      // Softmax in fp32 over the row: its max M (each warp's running max of
      // the scores it wrote, then the head's warps, then the cluster's
      // blocks), e = exp(s - M) in place and its sum; the V pass divides by
      // the sum and rounds to bf16 as it reads p. Each warp takes every
      // wph-th 32 of its head's positions. Every combination runs in the same
      // fixed order in every block.
      float m = rmax;
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      if (wph > 1) {
        if (lane == 0) red_w[warp] = m;
        __syncthreads();
        m = -INFINITY;
        for (int j = 0; j < wph; ++j) m = fmaxf(m, red_w[j * hg + h]);
      }
      if (C > 1) {
        if (k == 0 && lane == 0) red_h[h] = m;
        cg::this_cluster().sync();
        for (int q = 0; q < C; ++q)
          m = fmaxf(m, cg::this_cluster().map_shared_rank(red_h, q)[h]);
      }
      __syncwarp();
      float sum = 0.f;
      for (int p = k * 32 + lane; p < nb; p += wph * 32) {
        const float e = expf(sh[p] - m);
        sh[p] = e;
        sum += e;
      }
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (wph > 1) {
        if (lane == 0) red_w[nwarps + warp] = sum;
        __syncthreads();
        sum = 0.f;
        for (int j = 0; j < wph; ++j) sum += red_w[nwarps + j * hg + h];
      }
      if (C > 1) {
        if (k == 0 && lane == 0) red_h[hg + h] = sum;
        cg::this_cluster().sync();
        sum = 0.f;
        for (int q = 0; q < C; ++q) sum += cg::this_cluster().map_shared_rank(red_h, q)[hg + h];
      }
      row_sum = sum;
      __syncwarp();
    }

    mbar_wait(full0 + 8 * slot, phase);
    const bool is_v = w >= nst;
    uint32_t qb[KS][2];
    if (!is_v) {
      // q as B of the K pass: column n holds q's chunks 2b + n, 2b + 1 + n
      // (mod DC) at step b, zero past the head's DC chunks.
      const unsigned char* qh = smem + ring_bytes + slot * seg + h * D * 2;
#pragma unroll
      for (int b = 0; b < KS; ++b) {
        qb[b][0] = *reinterpret_cast<const uint32_t*>(qh + 2 * (8 * ((2 * b + fn) % DC) + fk));
        qb[b][1] =
            2 * b + 1 < DC
                ? *reinterpret_cast<const uint32_t*>(qh + 2 * (8 * ((2 * b + 1 + fn) % DC) + fk))
                : 0u;
      }
    }
    const int u0 = (is_v ? w - nst : w) * a.spos;
    const int npos = min(a.spos, nb - u0);
    const uint32_t rows = stage + lrow * seg + h * D * 2;
    for (int tt = 16 * k; tt < npos; tt += 16 * wph) {
      const uint32_t tile = rows + tt * seg;
      if (!is_v) {
        // Scores of positions tt .. tt+15. Rows past npos read stale lines
        // and are dropped.
        float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int b = 0; b < KS; ++b) {
          uint32_t kf[4];
          ldsm_x4(tile + 16 * ((2 * b + lrot) % DC), kf);
          mma_bf16(c, kf[0], kf[1], kf[2], kf[3], qb[b][0], qb[b][1]);
        }
        // C[j][j % 8]: lane 4 j + j / 2 holds rows j (c[0] or c[1]) and
        // j + 8 (c[2] or c[3]).
        if (fk == (fn & 6)) {
          const int p = tt + fn;
          const bool odd = fn & 1;
          if (p < npos) {
            const float x = (odd ? c[1] : c[0]) * a.scale;
            sh[u0 + p] = x;
            rmax = fmaxf(rmax, x);
          }
          if (p + 8 < npos) {
            const float x = (odd ? c[3] : c[2]) * a.scale;
            sh[u0 + p + 8] = x;
            rmax = fmaxf(rmax, x);
          }
        }
      } else {
        // A[j][k] = p of position k for k % 8 == j: lane 4 j + j / 2 holds
        // positions j (a0) and j + 8 (a2); the positions past npos hold stale
        // lines, so their p and their v are zero.
        // p = e / sum, rounded to bf16 by the pack.
        uint32_t a0 = 0u, a2 = 0u;
        if (fk == (fn & 6)) {
          const int p = tt + fn;
          const float p0 = p < npos ? sh[u0 + p] / row_sum : 0.f;
          const float p8 = p + 8 < npos ? sh[u0 + p + 8] / row_sum : 0.f;
          const bool odd = fn & 1;
          a0 = odd ? pack_bf16(0.f, p0) : pack_bf16(p0, 0.f);
          a2 = odd ? pack_bf16(0.f, p8) : pack_bf16(p8, 0.f);
        }
        const int pb = tt + fk;            // B rows: positions pb, pb+1, pb+8, pb+9
        const uint32_t lo = (pb < npos ? 0xffffu : 0u) | (pb + 1 < npos ? 0xffff0000u : 0u);
        const uint32_t hi = (pb + 8 < npos ? 0xffffu : 0u) | (pb + 9 < npos ? 0xffff0000u : 0u);
#pragma unroll
        for (int m = 0; m < DC; m += 2) {
          uint32_t vf[4];
          ldsm_x4_trans(tile + 16 * ((m + lrot) % DC), vf);
          step(acc, m, a0, a2, vf[0] & lo, vf[1] & hi);
          if (m + 1 < DC) step(acc, m + 1, a0, a2, vf[2] & lo, vf[3] & hi);
        }
      }
    }
    // Release the slot; the last warp of the round refills it. The fences
    // order this warp's reads of the slot before the count, and the count
    // before the bulk copies that overwrite it.
    __syncwarp();
    unsigned last = 0;
    if (lane == 0) {
      __threadfence_block();
      last = atomicAdd(&done[2 * slot], 1u) == (unsigned)(round + 1) * nwarps - 1;
    }
    if (__shfl_sync(0xffffffffu, last, 0) && i + a.depth < total) {
      __threadfence_block();
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      const int ni = i + a.depth, nj = ni / per_unit;
      issue_stage(a, unit(nj), ni - nj * per_unit, nst, stage, qring + slot * seg,
                  full0 + 8 * slot);
    }
    if (w == per_unit - 1) finish<DC>(a, t, acc, part, ctx, rank, split, fn, fk);
    if (++slot == a.depth) slot = 0, phase ^= 1, ++round;
    if (++w == per_unit) w = 0, ++j;
  }
}

}  // namespace

// q [R, H, D]; main_k/main_v rows of t0 (or more) positions of [H, D], two rows
// main_stride elements apart (null when t0 = 0); win_k/win_v [R, W, H, D],
// rows win_stride apart (null when wlive = 0); rowsel [R] and wanc [R, W]
// int32 indices inside a group of K rows, or null for the row itself;
// out [R, H, D]; scratch fp32 [R, H, t0 + wlive] when the plan says so, else
// null. All bf16 but the scratch, 16-byte aligned, strides multiples of 8
// elements. (clusters, groups, wph, per, spos, depth, scratch) must be
// work_plan's.
extern "C" int itt_decode_attn_bf16(const void* q, const void* main_k, const void* main_v,
                                    const void* win_k, const void* win_v, const void* rowsel,
                                    const void* wanc, void* out, void* scratch, int R, int K,
                                    int H, int D, int t0, int wlive, int W,
                                    long long main_stride, long long win_stride, float scale,
                                    int clusters, int groups, int wph, int per, int spos,
                                    int depth, int use_scratch, void* stream) {
  if (R < 1 || K < 1 || H < 1 || D < 8 || D > MAX_D || D % 8 != 0 || t0 < 0 || wlive < 0 ||
      wlive > W || t0 + wlive < 1)
    return (int)cudaErrorInvalidValue;
  if ((t0 > 0 && (!main_k || !main_v)) || (wlive > 0 && (!win_k || !win_v)))
    return (int)cudaErrorInvalidValue;
  if ((rowsel || wanc) && R % K != 0) return (int)cudaErrorInvalidValue;
  const Plan p = plan(R, H, D, t0 + wlive);
  if (clusters != p.clusters || groups != p.groups || wph != p.wph || per != p.per ||
      spos != p.spos || depth != p.depth || use_scratch != p.scratch ||
      (p.scratch && !scratch) || p.smem > SMEM_LIMIT ||
      (long long)R * p.groups * p.clusters > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = static_cast<const bf16*>(q);
  a.main_k = static_cast<const bf16*>(main_k);
  a.main_v = static_cast<const bf16*>(main_v);
  a.win_k = static_cast<const bf16*>(win_k);
  a.win_v = static_cast<const bf16*>(win_v);
  a.rowsel = static_cast<const int*>(rowsel);
  a.wanc = static_cast<const int*>(wanc);
  a.out = static_cast<bf16*>(out);
  a.scratch = p.scratch ? static_cast<float*>(scratch) : nullptr;
  a.R = R; a.K = K; a.H = H; a.D = D; a.t0 = t0; a.wlive = wlive; a.W = W;
  a.hg = H / p.groups;
  a.clusters = p.clusters; a.groups = p.groups; a.wph = p.wph; a.per = p.per;
  a.spos = p.spos; a.depth = p.depth;
  a.main_stride = main_stride;
  a.win_stride = win_stride;
  a.scale = scale;

  void (*const kernels[16])(const Args) = {
      decode_attn_kernel<1>,  decode_attn_kernel<2>,  decode_attn_kernel<3>,
      decode_attn_kernel<4>,  decode_attn_kernel<5>,  decode_attn_kernel<6>,
      decode_attn_kernel<7>,  decode_attn_kernel<8>,  decode_attn_kernel<9>,
      decode_attn_kernel<10>, decode_attn_kernel<11>, decode_attn_kernel<12>,
      decode_attn_kernel<13>, decode_attn_kernel<14>, decode_attn_kernel<15>,
      decode_attn_kernel<16>};
  void (*kernel)(const Args) = kernels[D / 8 - 1];
  if (p.smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (err != cudaSuccess) return (int)err;
  }
  // Without a cluster, as many blocks as the SMs hold at once, each walking
  // its share of the R * groups units; with one, a cluster a unit.
  const int threads = 32 * a.hg * p.wph;
  long long blocks = (long long)R * p.groups * p.clusters;
  if (p.clusters == 1) {
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                          (size_t)p.smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    if (blocks > (long long)sms * per_sm) blocks = (long long)sms * per_sm;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = (size_t)p.smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.clusters;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.clusters > 1 ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
