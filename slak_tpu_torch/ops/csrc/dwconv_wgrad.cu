// Weight gradient of the same-padded stride-1 depthwise conv, NCHW:
//   dw[c,i,j] = sum_{n,h,w} dy[n,c,h,w] * x[n,c,h+i-kh/2,w+j-kw/2]
// (x zero outside the map), fp32 accumulation, fp32 (C, kh, kw) result.
//
// Replaces slak_tpu/ops/pallas_banded.py: wgrad_banded_cmajor
// (_wgrad_kernel) + band_extract, and wgrad_banded2d_cmajor
// (_wgrad2d_kernel) + band_extract2d on the 7x7 maps. The TPU kernels form
// the per-channel correlation matrices dA (C, s, H, H) or (C, HW, HW) on
// the MXU and fold their diagonals into taps afterwards; a GPU has no use
// for the matrices, so this kernel accumulates the taps directly. It
// equals band_extract(dA) exactly in real arithmetic: the matrices'
// entries off the band are never formed.
//
// Grid (C, batch chunks). A block owns one channel and a contiguous chunk
// of the batch; for each sample it stages the input plane (zero-padded
// along the taps' short axis) and the dy plane as fp32 in shared memory.
//
// wgrad_tiled_kernel (taps (K, 5) or (5, K)): thread u owns tap row i =
// u % K along the long axis and all 5 taps across it, for the output rows
// a = u / K, u / K + P, ... (P = 256 / K row groups): per output row it
// slides a 5-wide register window along the short axis, one dy load and
// one new x load for 5 FMAs. Rows whose input row lies outside the map are
// skipped, so taps that only ever read padding stay exactly zero. The
// (5, K) orientation stages both planes transposed and runs the same loop.
// wgrad_kernel (any other odd taps): a thread a tap and a row group.
//
// The reduction over the batch is deterministic: each block reduces its
// row groups in a fixed order in shared memory and writes one partial
// (chunk, C, kh, kw); a second launch (wgrad_reduce) sums the chunks in
// order. No atomics.
//
// What bounds it on an H100: the FMAs, one per (output, tap) that sees the
// map (as many as the forward), on the CUDA cores at 67 TFLOP/s fp32, and
// the two shared-memory loads a 5-FMA step; the bytes (x and dy read once)
// take far less.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 v) { return __bfloat162float(v); }

constexpr int kThreads = 256;
constexpr int kShort = 5;
constexpr size_t kSmemMax = 200 * 1024;

struct WArgs {
  long long N;
  int C, H, W, kh, kw;
  int per_chunk;         // samples a block
};

// Taps (K, 5) (LONG_H) or (5, K). HA: the map's extent along the taps'
// long axis, HB across it; shared: xs [HA][XP] (XP odd, 2 zero columns
// each side), ds [HA][HB], red [P][K][5].
template <typename T, bool LONG_H>
__global__ void __launch_bounds__(kThreads)
wgrad_tiled_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                   float* __restrict__ part, WArgs a) {
  extern __shared__ float smem[];
  constexpr int S = kShort, HALO = S / 2;
  const int K = LONG_H ? a.kh : a.kw;
  const int HA = LONG_H ? a.H : a.W, HB = LONG_H ? a.W : a.H;
  const int XP = (HB + S - 1) | 1;
  const int P = kThreads / K;
  float* xs = smem;
  float* ds = xs + HA * XP;
  float* red = ds + HA * HB;

  const int c = blockIdx.x, chunk = blockIdx.y;
  const long long n0 = (long long)chunk * a.per_chunk;
  const long long n1 = min(a.N, n0 + a.per_chunk);
  const long long plane = (long long)a.H * a.W;
  const int u = threadIdx.x;
  const int ti = u % K, grp = u / K;
  const bool active = grp < P;
  const int pk = K / 2;

  // zero the halo columns once; the staging loop rewrites the rest
  for (int i = u; i < HA * XP; i += kThreads) xs[i] = 0.f;
  float acc[S];
#pragma unroll
  for (int j = 0; j < S; ++j) acc[j] = 0.f;

  for (long long n = n0; n < n1; ++n) {
    const T* xp = x + (n * a.C + c) * plane;
    const T* dp = dy + (n * a.C + c) * plane;
    __syncthreads();                    // the previous sample is consumed
    for (int i = u; i < a.H * a.W; i += kThreads) {
      const int h = i / a.W, w = i - h * a.W;
      const int ra = LONG_H ? h : w, rb = LONG_H ? w : h;
      xs[ra * XP + rb + HALO] = to_f<T>(xp[i]);
      ds[ra * HB + rb] = to_f<T>(dp[i]);
    }
    __syncthreads();
    if (active) {
      for (int ra = grp; ra < HA; ra += P) {
        const int r = ra + ti - pk;
        if (r < 0 || r >= HA) continue;
        const float* xr = xs + r * XP;
        const float* dr = ds + ra * HB;
        float xv[S];
#pragma unroll
        for (int j = 0; j < S - 1; ++j) xv[j] = xr[j];
        for (int b = 0; b < HB; ++b) {
          xv[S - 1] = xr[b + S - 1];
          const float d = dr[b];
#pragma unroll
          for (int j = 0; j < S; ++j) acc[j] = fmaf(d, xv[j], acc[j]);
#pragma unroll
          for (int j = 0; j < S - 1; ++j) xv[j] = xv[j + 1];
        }
      }
    }
  }
  if (active) {
#pragma unroll
    for (int j = 0; j < S; ++j) red[(grp * K + ti) * S + j] = acc[j];
  }
  __syncthreads();
  float* dst = part + ((long long)chunk * a.C + c) * K * S;
  for (int v = u; v < K * S; v += kThreads) {
    const int i = v / S, j = v - i * S;
    float s = 0.f;
    for (int g = 0; g < P; ++g) s += red[(g * K + i) * S + j];
    dst[LONG_H ? i * S + j : j * K + i] = s;
  }
}

// Any odd taps: thread u owns tap u % ntaps and the output rows u / ntaps,
// + P, ...; shared: xs [H][W], ds [H][W], red [P * ntaps].
template <typename T>
__global__ void __launch_bounds__(kThreads)
wgrad_kernel(const T* __restrict__ x, const T* __restrict__ dy,
             float* __restrict__ part, WArgs a) {
  extern __shared__ float smem[];
  const int H = a.H, W = a.W, kh = a.kh, kw = a.kw;
  const int ntaps = kh * kw;
  const int P = ntaps >= kThreads ? 1 : kThreads / ntaps;
  float* xs = smem;
  float* ds = xs + H * W;
  float* red = ds + H * W;
  const int c = blockIdx.x, chunk = blockIdx.y;
  const long long n0 = (long long)chunk * a.per_chunk;
  const long long n1 = min(a.N, n0 + a.per_chunk);
  const long long plane = (long long)H * W;

  for (int v = threadIdx.x; v < P * ntaps; v += kThreads) red[v] = 0.f;
  for (long long n = n0; n < n1; ++n) {
    const T* xp = x + (n * a.C + c) * plane;
    const T* dp = dy + (n * a.C + c) * plane;
    __syncthreads();
    for (int i = threadIdx.x; i < H * W; i += kThreads) {
      xs[i] = to_f<T>(xp[i]);
      ds[i] = to_f<T>(dp[i]);
    }
    __syncthreads();
    for (int v = threadIdx.x; v < P * ntaps; v += kThreads) {
      const int tap = v % ntaps, grp = v / ntaps;
      const int ti = tap / kw, tj = tap - ti * kw;
      float s = red[v];
      for (int h = grp; h < H; h += P) {
        const int r = h + ti - kh / 2;
        if (r < 0 || r >= H) continue;
        for (int w = 0; w < W; ++w) {
          const int cc = w + tj - kw / 2;
          if (cc >= 0 && cc < W) s = fmaf(ds[h * W + w], xs[r * W + cc], s);
        }
      }
      red[v] = s;
    }
  }
  __syncthreads();
  float* dst = part + ((long long)chunk * a.C + c) * ntaps;
  for (int t = threadIdx.x; t < ntaps; t += kThreads) {
    float s = 0.f;
    for (int g = 0; g < P; ++g) s += red[g * ntaps + t];
    dst[t] = s;
  }
}

// dw[i] = sum over chunks of part[chunk][i], in chunk order
__global__ void wgrad_reduce(const float* __restrict__ part,
                             float* __restrict__ dw, long long n,
                             int n_chunks) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < n_chunks; ++k) s += part[k * n + i];
  dw[i] = s;
}

int variant_of(int kh, int kw) {
  if (kw == kShort && kh != kShort && kh <= kThreads) return 1;
  if (kh == kShort && kw != kShort && kw <= kThreads) return 2;
  return 0;
}

size_t smem_bytes(int variant, int H, int W, int kh, int kw) {
  if (variant == 0) {
    const int ntaps = kh * kw;
    const int P = ntaps >= kThreads ? 1 : kThreads / ntaps;
    return sizeof(float) * (2 * (size_t)H * W + (size_t)P * ntaps);
  }
  const bool long_h = variant == 1;
  const int K = long_h ? kh : kw;
  const int HA = long_h ? H : W, HB = long_h ? W : H;
  const int XP = (HB + kShort - 1) | 1;
  return sizeof(float) * ((size_t)HA * XP + (size_t)HA * HB +
                          (size_t)(kThreads / K) * K * kShort);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)kSmemMax);
}

template <typename T>
cudaError_t launch(const void* x, const void* dy, float* part, float* dw,
                   WArgs a, int n_chunks, cudaStream_t stream) {
  const int variant = variant_of(a.kh, a.kw);
  const size_t smem = smem_bytes(variant, a.H, a.W, a.kh, a.kw);
  if (smem > kSmemMax) return cudaErrorInvalidConfiguration;
  const dim3 grid(a.C, n_chunks);
  const T* xt = static_cast<const T*>(x);
  const T* dt = static_cast<const T*>(dy);
  cudaError_t e;
  if (variant == 1) {
    e = allow_smem(wgrad_tiled_kernel<T, true>, smem);
    if (e != cudaSuccess) return e;
    wgrad_tiled_kernel<T, true><<<grid, kThreads, smem, stream>>>(
        xt, dt, part, a);
  } else if (variant == 2) {
    e = allow_smem(wgrad_tiled_kernel<T, false>, smem);
    if (e != cudaSuccess) return e;
    wgrad_tiled_kernel<T, false><<<grid, kThreads, smem, stream>>>(
        xt, dt, part, a);
  } else {
    e = allow_smem(wgrad_kernel<T>, smem);
    if (e != cudaSuccess) return e;
    wgrad_kernel<T><<<grid, kThreads, smem, stream>>>(xt, dt, part, a);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long n = (long long)a.C * a.kh * a.kw;
  wgrad_reduce<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      part, dw, n, n_chunks);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x, dy: (N, C, H, W) contiguous, kh and
// kw odd; part: n_chunks * C * kh * kw float32 scratch; dw: (C, kh, kw)
// float32. The batch is split into n_chunks contiguous chunks of
// ceil(N / n_chunks) samples. Two launches; returns the cudaError_t.
extern "C" int slak_dwconv_wgrad(int dtype, const void* x, const void* dy,
                                 float* part, float* dw, long long N, int C,
                                 int H, int W, int kh, int kw, int n_chunks,
                                 void* stream) {
  if (n_chunks < 1 || kh % 2 == 0 || kw % 2 == 0)
    return (int)cudaErrorInvalidValue;
  WArgs a{N, C, H, W, kh, kw, (int)((N + n_chunks - 1) / n_chunks)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, dy, part, dw, a, n_chunks, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, dy, part, dw, a, n_chunks, s);
  return (int)cudaErrorInvalidValue;
}
