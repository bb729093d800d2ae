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
//   softmax over the t0 + wlive live positions, p = bf16(e / sum), then
//   ctx = sum p * v accumulated in fp32 and rounded to bf16 last.
// A null row map reads row r itself: with both maps null, no window and
// prefix = positions 0 .. index this is the step of a cache whose rows are
// reordered after every beam selection (the port's own cache).
//
// It is not the TPU kernel carried over. That one turns the row selection into
// one-hot matrix products and computes all K x K (physical row, query) pairs,
// because Mosaic cannot index sublanes at a dynamic offset; here a row map is
// an index in a load: no redundant pairs, no alignment rule for t0, no
// grouping of batches, and the dead window slots (w >= wlive, which the TPU
// kernel pushes down by -10000, so that their exp is 0 in fp32) are left out.
//
// What bounds it: bytes. Each live K and V element is read once (2 n H D bf16
// a row) against 4 n H D operations a row: 1 operation a byte, where the card
// needs 295. So nothing is staged: one block per (row, head); a group of D/8
// lanes reads one position's 2 D bytes of this head with one 16-byte load a
// lane, the groups of the four warps stride over the positions, the dot is
// finished by shuffles inside the group, the scores of the row stay in shared
// memory (4 bytes a position), and the second pass streams V the same way
// into eight fp32 accumulators a lane. The strides of a row are arguments, so
// a slice [:, :n] of a longer buffer is read in place.
//
// Plain C interface, loaded with ctypes (imagetranslate_tpu_torch/ops/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_D = 128;
// Dynamic shared memory a block may ask for: 227 KB less the static arrays.
constexpr size_t MAX_DYNAMIC_SMEM = 232448 - (WARPS * MAX_D + 2 * WARPS) * sizeof(float);

struct Args {
  const bf16* q;
  const bf16* main_k;
  const bf16* main_v;
  const bf16* win_k;
  const bf16* win_v;
  const int* rowsel;   // [R] or null
  const int* wanc;     // [R, W] or null
  bf16* out;
  int K, H, D, t0, wlive, W;
  int lpp;             // lanes a position: the power of two >= D / 8
  long long main_stride, win_stride;   // elements between two rows
  float scale;
};

__device__ __forceinline__ void load8(const bf16* p, float (&x)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// Where position p of this row's live sequence lies in `main` or `win`
// (the K buffers or the V buffers), at channel offset hoff of the [H * D] line.
__device__ __forceinline__ const bf16* position(const Args& a, const bf16* main, const bf16* win,
                                                int r, long long group_row, long long main_row,
                                                int p, int hoff) {
  const long long line = (long long)a.H * a.D;
  if (p < a.t0) return main + main_row * a.main_stride + p * line + hoff;
  const int w = p - a.t0;
  const long long row = a.wanc ? group_row + a.wanc[(long long)r * a.W + w] : r;
  return win + row * a.win_stride + w * line + hoff;
}

__global__ void __launch_bounds__(THREADS) decode_attn_kernel(const Args a) {
  extern __shared__ float s[];                 // [n] scores, then probabilities
  __shared__ float red[2 * WARPS];             // block maximum, block sum
  __shared__ float part[WARPS * MAX_D];        // the warps' partial outputs

  const int r = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ppw = 32 / a.lpp;                  // positions a warp takes at once
  const int g = lane / a.lpp;                  // which of them this lane reads
  const int c = (lane % a.lpp) * 8;            // its first channel of the head
  const bool active = c < a.D;
  const int n = a.t0 + a.wlive;
  const long long group_row = (long long)(r / a.K) * a.K;
  const long long main_row = a.rowsel ? group_row + a.rowsel[r] : r;
  const int hoff = h * a.D + c;

  float qf[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (active) load8(a.q + ((long long)r * a.H + h) * a.D + c, qf);

  // Scores. p0 is the same for every lane of a warp, so all of them reach the
  // shuffles.
  float vmax = -INFINITY;
  for (int p0 = warp * ppw; p0 < n; p0 += WARPS * ppw) {
    const int p = p0 + g;
    float d = 0.f;
    if (p < n && active) {
      float kf[8];
      load8(position(a, a.main_k, a.win_k, r, group_row, main_row, p, hoff), kf);
#pragma unroll
      for (int i = 0; i < 8; ++i) d = fmaf(qf[i], kf[i], d);
    }
    for (int o = a.lpp >> 1; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
    if (p < n) {
      d *= a.scale;
      if (c == 0) s[p] = d;
      vmax = fmaxf(vmax, d);
    }
  }
  for (int o = 16; o > 0; o >>= 1) vmax = fmaxf(vmax, __shfl_xor_sync(0xffffffffu, vmax, o));
  if (lane == 0) red[warp] = vmax;
  __syncthreads();
  vmax = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) vmax = fmaxf(vmax, red[w]);

  // Softmax in fp32; the normalised probabilities are rounded to bf16.
  float sum = 0.f;
  for (int p = threadIdx.x; p < n; p += THREADS) {
    const float e = expf(s[p] - vmax);
    s[p] = e;
    sum += e;
  }
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (lane == 0) red[WARPS + warp] = sum;
  __syncthreads();
  sum = red[WARPS];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) sum += red[WARPS + w];
  for (int p = threadIdx.x; p < n; p += THREADS)
    s[p] = __bfloat162float(__float2bfloat16_rn(s[p] / sum));
  __syncthreads();

  // p . V, eight channels a lane.
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int p = warp * ppw + g; p < n; p += WARPS * ppw) {
    if (!active) continue;
    float vf[8];
    load8(position(a, a.main_v, a.win_v, r, group_row, main_row, p, hoff), vf);
    const float w = s[p];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = fmaf(w, vf[i], acc[i]);
  }
  for (int o = 16; o >= a.lpp; o >>= 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
  }
  if (g == 0 && active) {
#pragma unroll
    for (int i = 0; i < 8; ++i) part[warp * MAX_D + c + i] = acc[i];
  }
  __syncthreads();
  if (threadIdx.x < a.D) {
    float o = part[threadIdx.x];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) o += part[w * MAX_D + threadIdx.x];
    a.out[((long long)r * a.H + h) * a.D + threadIdx.x] = __float2bfloat16_rn(o);
  }
}

}  // namespace

// q [R, H, D]; main_k/main_v rows of t0 (or more) positions of [H, D], two rows
// main_stride elements apart (null when t0 = 0); win_k/win_v [R, W, H, D],
// rows win_stride apart (null when wlive = 0); rowsel [R] and wanc [R, W]
// int32 indices inside a group of K rows, or null for the row itself;
// out [R, H, D]. All bf16, 16-byte aligned, strides multiples of 8 elements.
extern "C" int itt_decode_attn_bf16(const void* q, const void* main_k, const void* main_v,
                                    const void* win_k, const void* win_v, const void* rowsel,
                                    const void* wanc, void* out, int R, int K, int H, int D,
                                    int t0, int wlive, int W, long long main_stride,
                                    long long win_stride, float scale, void* stream) {
  if (R < 1 || K < 1 || H < 1 || D < 8 || D > MAX_D || D % 8 != 0 || t0 < 0 || wlive < 0 ||
      wlive > W || t0 + wlive < 1 || (long long)R * H > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  if ((t0 > 0 && (!main_k || !main_v)) || (wlive > 0 && (!win_k || !win_v)))
    return (int)cudaErrorInvalidValue;
  if ((rowsel || wanc) && R % K != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(t0 + wlive) * sizeof(float);
  if (smem > MAX_DYNAMIC_SMEM) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  Args a;
  a.q = static_cast<const bf16*>(q);
  a.main_k = static_cast<const bf16*>(main_k);
  a.main_v = static_cast<const bf16*>(main_v);
  a.win_k = static_cast<const bf16*>(win_k);
  a.win_v = static_cast<const bf16*>(win_v);
  a.rowsel = static_cast<const int*>(rowsel);
  a.wanc = static_cast<const int*>(wanc);
  a.out = static_cast<bf16*>(out);
  a.K = K; a.H = H; a.D = D; a.t0 = t0; a.wlive = wlive; a.W = W;
  a.lpp = 1;
  while (a.lpp * 8 < D) a.lpp *= 2;
  a.main_stride = main_stride;
  a.win_stride = win_stride;
  a.scale = scale;
  decode_attn_kernel<<<R * H, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
