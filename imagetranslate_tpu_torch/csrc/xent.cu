// Fused label-smoothed softmax cross-entropy for Hopper (sm_90a), forward and
// backward.
//
// Replaces the Pallas TPU kernels of imagetranslate_tpu/ops/xent_pallas.py
// (`_fwd_kernel` :36 under `smoothed_xent_rows` :118, `_bwd_kernel` :70 under
// `_vjp_bwd` :141). For logits x [N, V] (fp32 or bf16) and targets t [N]:
//
//   forward   logZ = logsumexp(x),  loss = logZ - (1-eps)*x_t - (eps/V)*sum(x)
//             -> loss [N] fp32 and logZ [N] fp32 (kept for the backward)
//   backward  dx = g * (exp(x - logZ) - (1-eps)*[v == t] - eps/V), in x's dtype
//
// all arithmetic in fp32. A target outside [0, V) matches no column (x_t = 0,
// no one-hot term), as in the TPU kernel.
//
// What bounds it: bytes. The forward reads x once (N*V*4 bytes in fp32: 2.06 GB
// at N = 16128, V = 32000, ~0.62 ms at 3.35 TB/s) and does ~6 fp32 operations
// and one exp per element; the backward reads x and writes dx (twice the
// bytes). So the design is about moving each byte once, 16 bytes a thread.
//
// Why it is not the TPU kernel's tiling: there the grid walks the vocab tiles
// of a row block in order and carries (max, sum exp, sum x, x_t) in scratch
// from one grid step to the next. Hopper blocks share nothing, so one block
// owns one row: each thread keeps an online (max, sum exp) and sum x in
// registers over its strided 16-byte vectors, then the warps merge by shuffle
// and through shared memory. At the training shapes N is 8192-16128 rows, far
// more blocks than the 132 SMs hold, so no row needs splitting. The TPU
// wrapper recomputes logZ with a second pass before its backward; here the
// forward writes it.
//
// Ragged V: with V not a multiple of the vector width a row does not start on
// a 16-byte boundary, so each row is cut into a scalar head up to the first
// aligned element, an aligned vector body and a scalar tail. x and dx must
// themselves be 16-byte aligned, so a dx row splits exactly as its x row.
// Offsets are 64-bit throughout: N*V passes 2^31 elements at large batches.
//
// Plain C interface, loaded with ctypes (imagetranslate_tpu_torch/ops/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Threads per block and 16-byte vectors a thread has in flight per loop trip,
// for each kernel: the fastest of a sweep on an H100 at N = 16128, V = 32000
// (threads 128..1024, 1..8 vectors, with and without the streaming load/store
// hints, which did not help): 8 warps x 2 vectors for the reduction, 16 warps
// x 4 vectors for the read-and-write pass.
constexpr int FWD_THREADS = 256;
constexpr int FWD_WARPS = FWD_THREADS / 32;
constexpr int FWD_UNROLL = 2;
constexpr int BWD_THREADS = 512;
constexpr int BWD_UNROLL = 4;
constexpr float NEG_BIG = -1e30f;  // the TPU kernel's initial running max

struct RowStats {
  float m;   // running max
  float l;   // sum of exp(x - m)
  float sx;  // sum of x
};

__device__ __forceinline__ void merge(RowStats& a, const RowStats& b) {
  const float m = fmaxf(a.m, b.m);
  a.l = a.l * __expf(a.m - m) + b.l * __expf(b.m - m);
  a.m = m;
  a.sx += b.sx;
}

template <int n>
__device__ __forceinline__ void accumulate(RowStats& s, const float (&x)[n]) {
  float vmax = x[0];
#pragma unroll
  for (int i = 1; i < n; ++i) vmax = fmaxf(vmax, x[i]);
  if (vmax > s.m) {
    s.l *= __expf(s.m - vmax);
    s.m = vmax;
  }
#pragma unroll
  for (int i = 0; i < n; ++i) {
    s.l += __expf(x[i] - s.m);
    s.sx += x[i];
  }
}

// 16-byte vectors of each logits dtype, widened to fp32 registers.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float (&x)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&x)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  }
  static __device__ __forceinline__ float load1(const float* p) { return *p; }
  static __device__ __forceinline__ void store1(float* p, float v) { *p = v; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&x)[8]) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&x)[8]) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = v;
  }
  static __device__ __forceinline__ float load1(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

// A row's scalar head (elements before the first 16-byte boundary, at most V)
// and the number of whole vectors after it.
template <typename T>
__device__ __forceinline__ void split_row(const T* row, int V, int& head, int& nvec) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(row);
  const int h = (int)(((16 - (addr & 15)) & 15) / sizeof(T));
  head = h < V ? h : V;
  nvec = (V - head) / Vec<T>::N;
}

template <typename T>
__global__ void __launch_bounds__(FWD_THREADS)
xent_fwd_kernel(const T* __restrict__ x, const long long* __restrict__ targets,
                float* __restrict__ loss, float* __restrict__ logz, int V, float keep,
                float smooth) {
  constexpr int N = Vec<T>::N;
  const size_t r = blockIdx.x;
  const T* row = x + r * (size_t)V;
  int head, nvec;
  split_row(row, V, head, nvec);

  RowStats s{NEG_BIG, 0.f, 0.f};
  const T* body = row + head;
  for (int i0 = threadIdx.x; i0 < nvec; i0 += FWD_THREADS * FWD_UNROLL) {
    float v[FWD_UNROLL][N];
#pragma unroll
    for (int u = 0; u < FWD_UNROLL; ++u)  // all the trip's loads first
      if (i0 + u * FWD_THREADS < nvec) Vec<T>::load(body + (size_t)(i0 + u * FWD_THREADS) * N, v[u]);
#pragma unroll
    for (int u = 0; u < FWD_UNROLL; ++u)
      if (i0 + u * FWD_THREADS < nvec) accumulate<N>(s, v[u]);
  }
  for (int c = threadIdx.x; c < head; c += FWD_THREADS) {
    const float v[1] = {Vec<T>::load1(row + c)};
    accumulate<1>(s, v);
  }
  for (int c = head + nvec * N + threadIdx.x; c < V; c += FWD_THREADS) {
    const float v[1] = {Vec<T>::load1(row + c)};
    accumulate<1>(s, v);
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    RowStats o;
    o.m = __shfl_xor_sync(0xffffffffu, s.m, off);
    o.l = __shfl_xor_sync(0xffffffffu, s.l, off);
    o.sx = __shfl_xor_sync(0xffffffffu, s.sx, off);
    merge(s, o);
  }
  __shared__ RowStats warp_stats[FWD_WARPS];
  if ((threadIdx.x & 31) == 0) warp_stats[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    RowStats all = warp_stats[0];
    for (int w = 1; w < FWD_WARPS; ++w) merge(all, warp_stats[w]);
    const long long t = targets[r];
    const float xt = (t >= 0 && t < (long long)V) ? Vec<T>::load1(row + t) : 0.f;
    const float lz = all.m + logf(all.l);
    logz[r] = lz;
    loss[r] = lz - keep * xt - smooth * all.sx;
  }
}

template <typename T>
__global__ void __launch_bounds__(BWD_THREADS)
xent_bwd_kernel(const T* __restrict__ x, const long long* __restrict__ targets,
                const float* __restrict__ logz, const float* __restrict__ g,
                T* __restrict__ dx, int V, float keep, float smooth) {
  constexpr int N = Vec<T>::N;
  const size_t r = blockIdx.x;
  const T* row = x + r * (size_t)V;
  T* drow = dx + r * (size_t)V;
  int head, nvec;
  split_row(row, V, head, nvec);
  const int tail = head + nvec * N;
  const float gr = g[r];
  const T* body = row + head;
  T* dbody = drow + head;

  if (gr == 0.f) {
    // A masked row: its gradient is zero whatever x holds; x is not read.
    float z[N];
#pragma unroll
    for (int i = 0; i < N; ++i) z[i] = 0.f;
    for (int i = threadIdx.x; i < nvec; i += BWD_THREADS) Vec<T>::store(dbody + (size_t)i * N, z);
    for (int c = threadIdx.x; c < head; c += BWD_THREADS) Vec<T>::store1(drow + c, 0.f);
    for (int c = tail + threadIdx.x; c < V; c += BWD_THREADS) Vec<T>::store1(drow + c, 0.f);
    return;
  }

  const float lz = logz[r];
  const long long t = targets[r];
  const int tc = (t >= 0 && t < (long long)V) ? (int)t : -1;

  for (int i0 = threadIdx.x; i0 < nvec; i0 += BWD_THREADS * BWD_UNROLL) {
    float v[BWD_UNROLL][N];
#pragma unroll
    for (int u = 0; u < BWD_UNROLL; ++u)  // all the trip's loads first
      if (i0 + u * BWD_THREADS < nvec) Vec<T>::load(body + (size_t)(i0 + u * BWD_THREADS) * N, v[u]);
#pragma unroll
    for (int u = 0; u < BWD_UNROLL; ++u) {
      const int i = i0 + u * BWD_THREADS;
      if (i < nvec) {
        const int c0 = head + i * N;
#pragma unroll
        for (int j = 0; j < N; ++j)
          v[u][j] = gr * (__expf(v[u][j] - lz) - (c0 + j == tc ? keep : 0.f) - smooth);
        Vec<T>::store(dbody + (size_t)i * N, v[u]);
      }
    }
  }
  for (int c = threadIdx.x; c < head; c += BWD_THREADS)
    Vec<T>::store1(drow + c, gr * (__expf(Vec<T>::load1(row + c) - lz) -
                                   (c == tc ? keep : 0.f) - smooth));
  for (int c = tail + threadIdx.x; c < V; c += BWD_THREADS)
    Vec<T>::store1(drow + c, gr * (__expf(Vec<T>::load1(row + c) - lz) -
                                   (c == tc ? keep : 0.f) - smooth));
}

bool bad_args(const void* x, long long N, int V) {
  return N < 1 || N > 2147483647LL || V < 1 || (reinterpret_cast<uintptr_t>(x) & 15) != 0;
}

}  // namespace

// x [N, V] fp32 or bf16 (is_bf16), contiguous, 16-byte aligned; targets [N]
// int64; loss, logz [N] fp32. keep = 1 - eps, smooth = eps / V.
extern "C" int itt_xent_fwd(const void* x, const void* targets, void* loss, void* logz,
                            long long N, int V, int is_bf16, float keep, float smooth,
                            void* stream) {
  if (bad_args(x, N, V)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* t = static_cast<const long long*>(targets);
  if (is_bf16)
    xent_fwd_kernel<__nv_bfloat16><<<(unsigned)N, FWD_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), t, static_cast<float*>(loss),
        static_cast<float*>(logz), V, keep, smooth);
  else
    xent_fwd_kernel<float><<<(unsigned)N, FWD_THREADS, 0, st>>>(
        static_cast<const float*>(x), t, static_cast<float*>(loss),
        static_cast<float*>(logz), V, keep, smooth);
  return (int)cudaGetLastError();
}

// g [N] fp32 (0 on masked rows); dx [N, V] in x's dtype, 16-byte aligned.
extern "C" int itt_xent_bwd(const void* x, const void* targets, const void* logz,
                            const void* g, void* dx, long long N, int V, int is_bf16,
                            float keep, float smooth, void* stream) {
  if (bad_args(x, N, V) || (reinterpret_cast<uintptr_t>(dx) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* t = static_cast<const long long*>(targets);
  const float* lz = static_cast<const float*>(logz);
  const float* gg = static_cast<const float*>(g);
  if (is_bf16)
    xent_bwd_kernel<__nv_bfloat16><<<(unsigned)N, BWD_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), t, lz, gg, static_cast<__nv_bfloat16*>(dx), V,
        keep, smooth);
  else
    xent_bwd_kernel<float><<<(unsigned)N, BWD_THREADS, 0, st>>>(
        static_cast<const float*>(x), t, lz, gg, static_cast<float*>(dx), V, keep, smooth);
  return (int)cudaGetLastError();
}
