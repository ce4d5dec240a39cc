// Depthwise "same" convolution, stride 1, odd rectangular taps, NCHW.
//
// Replaces slak_tpu/ops/pallas_banded.py: dwconv_banded_cmajor
// (_fwd_kernel), the TPU kernel that runs each branch of the decomposed
// large-kernel pair as per-channel banded (H, H) matrix products. A GPU has
// no reason to build the banded matrices: this kernel runs the taps
// directly, out[n,c,h,w] = sum_{i,j} taps[c,i,j] * x[n,c,h+i-kh/2,w+j-kw/2],
// with zero padding, fp32 accumulation and a bf16 or fp32 store.
//
// One kernel serves both orientations of the pair, (K, 5) and (5, K), with
// no transposes, and the tap rows or columns along the long axis that would
// only read padding are skipped, as the TPU kernel's unpadded contraction
// does (pallas_banded.py:18-24). With `accumulate` the result is added to
// what `out` holds, so the pair runs as two launches into one output and
// needs no separate add pass.
//
// Blocks: one block covers G consecutive (n, c) planes (G > 1 on small
// maps) and a tile of TH output rows, and stages the input rows the tile
// reads, zero-padded along the short axis, as fp32 in shared memory with
// the taps of its G channels.
//
// dwconv_tiled_kernel (taps (K, 5) or (5, K)): each thread computes RB = 8
// neighbouring outputs across the short axis of the taps, so every input
// value and tap it loads from shared memory feeds 5 to 8 FMAs: per step of
// the long axis it loads RB + 4 inputs and 5 taps for 5 * RB FMAs. (Also
// blocking 4 outputs along the long axis, to reuse each input line 4 times,
// measured slower: 10.3 against 9.4 ms a forward at batch 64.)
// dwconv_kernel (any other odd taps, e.g. a merged K x K): one output per
// thread, two shared-memory loads per FMA.
//
// What bounds it on an H100: the FMAs, up to kh*kw per output on the CUDA
// cores (67 TFLOP/s fp32), and the shared-memory loads that feed them; the
// bytes (x read once, out written once) take far less at SLaK kernel sizes.
//
// Stats variant (slak_dwconv_stats) replaces pallas_banded.py:
// dwconv_banded_stats_cmajor (_fwd_stats_kernel), the train-mode forward
// that also emits each channel's BN batch sums, sum(y) and sum(y^2) in fp32,
// taken on the stored (rounded) output. The TPU kernel adds each batch
// block's sums into a resident output as its grid walks the batch in order;
// blocks here run in parallel, so the reduction is deterministic in two
// steps instead: after its stores each block reads back its G planes' tile
// (just written, so from L1/L2), reduces each plane's part of it (one block
// reduction, or a warp a plane when G > 1) and writes one (sum, sum of
// squares) pair per (plane, row tile) to a scratch buffer; a second launch
// (dwconv_stats_reduce) sums those partials per channel in a fixed order.
// No atomics: the sums are the same bits on every run. Outputs on tap rows
// that only read padding are real outputs and count like any other.
//
// Probe entry (slak_dwconv_probe) replaces tools/probe_overhead.py:
// run_variant (variant_kernel), the TPU's probe of K1's fixed cost: the
// (K, 5) tiled kernel instantiated with a tap limit, computing K1 with
// only the first ntaps of the 5 tap columns; ntaps = 0 runs no tap and
// copies the W-padded input's first W columns, as the TPU copy-only twin
// does (x_ref[i, :, 0:W, :]): out[h][w] = x[h][w - 2], zero for w < 2.
// K1's own instantiations (PROBE = false) are unchanged.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) { return __float2bfloat16(v); }

constexpr int kThreads = 256;
constexpr int kShort = 5;         // the short side of the tiled path's taps
constexpr int RB = 8;             // outputs per thread on the tiled path
constexpr size_t kSmemMax = 96 * 1024;
constexpr int kWarps = kThreads / 32;

struct Geom {
  long long planes;
  int C, H, W, kh, kw;
  int G, TH, n_row_tiles;
  int rows_in, Wp;                // shared tile of one plane
  int ntaps;                      // the probe's tap columns (K1: all)
};

template <typename T>
__device__ __forceinline__ void store(T* out, long long o, float acc,
                                      int accumulate) {
  if (accumulate) acc += to_f<T>(out[o]);
  out[o] = from_f<T>(acc);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The stats epilogue: the (sum, sum of squares) of the rows [h0, h1) of
// each of the block's planes, as stored, into part[(plane * n_row_tiles +
// row tile) * 2 + {0, 1}]. Called by every thread of the block.
template <typename T>
__device__ void stats_epilogue(const T* __restrict__ out, float* part,
                               const Geom& g, long long p0, int h0, int h1) {
  __shared__ float red[2][kWarps];
  __syncthreads();                       // the block's stores are visible
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = (h1 - h0) * g.W;
  const long long plane = (long long)g.H * g.W;
  const int row_tile = h0 / g.TH;
  if (g.G == 1) {
    if (p0 >= g.planes) return;
    const T* o = out + p0 * plane + (long long)h0 * g.W;
    float s = 0.f, q = 0.f;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const float v = to_f<T>(o[i]);
      s += v;
      q += v * v;
    }
    s = warp_sum(s);
    q = warp_sum(q);
    if (lane == 0) {
      red[0][warp] = s;
      red[1][warp] = q;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float a = 0.f, b = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        a += red[0][w];
        b += red[1][w];
      }
      float* dst = part + (p0 * g.n_row_tiles + row_tile) * 2;
      dst[0] = a;
      dst[1] = b;
    }
    return;
  }
  for (int pg = warp; pg < g.G; pg += kWarps) {       // a warp a plane
    const long long p = p0 + pg;
    if (p >= g.planes) break;
    const T* o = out + p * plane + (long long)h0 * g.W;
    float s = 0.f, q = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float v = to_f<T>(o[i]);
      s += v;
      q += v * v;
    }
    s = warp_sum(s);
    q = warp_sum(q);
    if (lane == 0) {
      float* dst = part + (p * g.n_row_tiles + row_tile) * 2;
      dst[0] = s;
      dst[1] = q;
    }
  }
}

// s1[c], s2[c] = the sums of the partials of channel c over the batch and
// the row tiles, in a fixed order: one block a channel.
__global__ void __launch_bounds__(kThreads)
dwconv_stats_reduce(const float* __restrict__ part, float* __restrict__ s1,
                    float* __restrict__ s2, long long N, int C,
                    int n_row_tiles) {
  __shared__ float red[2][kWarps];
  const int c = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long n_items = N * n_row_tiles;
  float s = 0.f, q = 0.f;
  for (long long i = threadIdx.x; i < n_items; i += kThreads) {
    const long long n = i / n_row_tiles;
    const int t = (int)(i - n * n_row_tiles);
    const float* src = part + ((n * C + c) * n_row_tiles + t) * 2;
    s += src[0];
    q += src[1];
  }
  s = warp_sum(s);
  q = warp_sum(q);
  if (lane == 0) {
    red[0][warp] = s;
    red[1][warp] = q;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = 0.f, b = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      a += red[0][w];
      b += red[1][w];
    }
    s1[c] = a;
    s2[c] = b;
  }
}

// Any odd taps: one output per thread. The tile holds the input rows
// [h0 - kh/2, h1 + kh/2) clipped to the map, padded by kw/2 columns.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dwconv_kernel(const T* __restrict__ x, const float* __restrict__ w,
              T* __restrict__ out, Geom g, int accumulate, float* part) {
  extern __shared__ float smem[];
  const int kh = g.kh, kw = g.kw, H = g.H, W = g.W, Wp = g.Wp;
  const int ph = kh / 2, pw = kw / 2;
  const int ntaps = kh * kw;
  float* taps = smem;
  float* xs = smem + g.G * ntaps;

  const long long p0 = (long long)(blockIdx.x / g.n_row_tiles) * g.G;
  const int h0 = (blockIdx.x % g.n_row_tiles) * g.TH;
  const int h1 = min(H, h0 + g.TH);
  const int r_lo = max(0, h0 - ph);
  const int nr = min(H, h1 + ph) - r_lo;
  const long long plane = (long long)H * W;

  for (int i = threadIdx.x; i < g.G * ntaps; i += kThreads) {
    const long long p = p0 + i / ntaps;
    taps[i] = p < g.planes ? w[(p % g.C) * ntaps + i % ntaps] : 0.f;
  }
  const int tile_in = nr * Wp;
  for (int i = threadIdx.x; i < g.G * tile_in; i += kThreads) {
    const int pg = i / tile_in, rem = i - pg * tile_in;
    const int r = rem / Wp, col = rem - r * Wp, wc = col - pw;
    const long long p = p0 + pg;
    float v = 0.f;
    if (p < g.planes && wc >= 0 && wc < W)
      v = to_f<T>(x[p * plane + (long long)(r_lo + r) * W + wc]);
    xs[(pg * g.rows_in + r) * Wp + col] = v;
  }
  __syncthreads();

  const int tile_out = (h1 - h0) * W;
  for (int i = threadIdx.x; i < g.G * tile_out; i += kThreads) {
    const int pg = i / tile_out, rem = i - pg * tile_out;
    const int hh = h0 + rem / W, ww = rem % W;
    const long long p = p0 + pg;
    if (p >= g.planes) continue;
    const int i_lo = max(0, ph - hh), i_hi = min(kh, H + ph - hh);
    const float* tg = taps + pg * ntaps;
    const float* xg = xs + (pg * g.rows_in + hh - ph - r_lo) * Wp + ww;
    float acc = 0.f;
    for (int ti = i_lo; ti < i_hi; ++ti)
      for (int tj = 0; tj < kw; ++tj)
        acc = fmaf(tg[ti * kw + tj], xg[ti * Wp + tj], acc);
    store<T>(out, p * plane + (long long)hh * W + ww, acc, accumulate);
  }
  if (part != nullptr) stats_epilogue<T>(out, part, g, p0, h0, h1);
}

// Taps (K, 5) (LONG_H) or (5, K). A thread owns RB outputs across the short
// axis: a row segment (hh, wb*RB + q) for (K, 5), a column segment
// (h0 + hb*RB + q, ww) for (5, K).
//   (K, 5) tile: rows [h0 - K/2, h1 + K/2) clipped to the map, each padded
//                by 2 columns and to whole RB blocks, and to an odd pitch:
//                Wp = (ceil(W/RB)*RB + 4) | 1.
//   (5, K) tile: rows h0 - 2 .. h0 + ceil(TH/RB)*RB + 2 (zero outside the
//                map), unpadded along W (Wp = W): the long axis skips the
//                taps that would read padding.
template <typename T, bool LONG_H, bool PROBE = false>
__global__ void __launch_bounds__(kThreads)
dwconv_tiled_kernel(const T* __restrict__ x, const float* __restrict__ w,
                    T* __restrict__ out, Geom g, int accumulate,
                    float* part) {
  extern __shared__ float smem[];
  constexpr int S = kShort, HALO = S / 2;
  const int H = g.H, W = g.W, Wp = g.Wp;
  const int K = LONG_H ? g.kh : g.kw;
  const int pk = K / 2;
  const int ntaps = K * S;
  float* taps = smem;
  float* xs = smem + g.G * ntaps;

  const long long p0 = (long long)(blockIdx.x / g.n_row_tiles) * g.G;
  const int h0 = (blockIdx.x % g.n_row_tiles) * g.TH;
  const int h1 = min(H, h0 + g.TH);
  const long long plane = (long long)H * W;
  // staged rows: [r_lo, r_lo + nr), with the column offset of column 0
  int r_lo, nr, c_off;
  if (LONG_H) {
    r_lo = max(0, h0 - pk);
    nr = min(H, h1 + pk) - r_lo;
    c_off = HALO;
  } else {
    r_lo = h0 - HALO;
    nr = (h1 - h0 + RB - 1) / RB * RB + S - 1;
    c_off = 0;
  }

  for (int i = threadIdx.x; i < g.G * ntaps; i += kThreads) {
    const long long p = p0 + i / ntaps;
    taps[i] = p < g.planes ? w[(p % g.C) * ntaps + i % ntaps] : 0.f;
  }
  const int tile_in = nr * Wp;
  for (int i = threadIdx.x; i < g.G * tile_in; i += kThreads) {
    const int pg = i / tile_in, rem = i - pg * tile_in;
    const int r = rem / Wp, col = rem - r * Wp;
    const int hr = r_lo + r, wc = col - c_off;
    const long long p = p0 + pg;
    float v = 0.f;
    if (p < g.planes && hr >= 0 && hr < H && wc >= 0 && wc < W)
      v = to_f<T>(x[p * plane + (long long)hr * W + wc]);
    xs[(pg * g.rows_in + r) * Wp + col] = v;
  }
  __syncthreads();

  const int nblk = LONG_H ? (W + RB - 1) / RB : (h1 - h0 + RB - 1) / RB;
  const int per_plane = LONG_H ? (h1 - h0) * nblk : nblk * W;
  for (int i = threadIdx.x; i < g.G * per_plane; i += kThreads) {
    const int pg = i / per_plane, rem = i - pg * per_plane;
    const long long p = p0 + pg;
    if (p >= g.planes) continue;
    const float* tg = taps + pg * ntaps;
    float acc[RB];
#pragma unroll
    for (int q = 0; q < RB; ++q) acc[q] = 0.f;
    if (LONG_H) {
      const int hh = h0 + rem / nblk, wb = rem % nblk;
      const int i_lo = max(0, pk - hh);
      const int i_hi = PROBE && g.ntaps == 0 ? i_lo : min(K, H + pk - hh);
      const float* xb = xs + (pg * g.rows_in + hh - pk - r_lo) * Wp + wb * RB;
      if (PROBE && g.ntaps == 0) {          // copy-only: the padded row
#pragma unroll
        for (int q = 0; q < RB; ++q) acc[q] = xb[pk * Wp + q];
      }
      for (int ti = i_lo; ti < i_hi; ++ti) {
        const float* xr = xb + ti * Wp;
        float xv[RB + S - 1], tv[S];
#pragma unroll
        for (int k = 0; k < RB + S - 1; ++k) xv[k] = xr[k];
#pragma unroll
        for (int j = 0; j < S; ++j) tv[j] = tg[ti * S + j];
#pragma unroll
        for (int q = 0; q < RB; ++q)
#pragma unroll
          for (int j = 0; j < S; ++j)
            if (!PROBE || j < g.ntaps) acc[q] = fmaf(tv[j], xv[q + j], acc[q]);
      }
      const long long o = p * plane + (long long)hh * W + wb * RB;
#pragma unroll
      for (int q = 0; q < RB; ++q)
        if (wb * RB + q < W) store<T>(out, o + q, acc[q], accumulate);
    } else {
      const int hb = rem / W, ww = rem % W;
      const int j_lo = max(0, pk - ww), j_hi = min(K, W + pk - ww);
      const float* xb = xs + (pg * g.rows_in + hb * RB) * Wp + ww - pk;
      for (int tj = j_lo; tj < j_hi; ++tj) {
        const float* xc = xb + tj;
        float xv[RB + S - 1], tv[S];
#pragma unroll
        for (int k = 0; k < RB + S - 1; ++k) xv[k] = xc[k * Wp];
#pragma unroll
        for (int j = 0; j < S; ++j) tv[j] = tg[j * K + tj];
#pragma unroll
        for (int q = 0; q < RB; ++q)
#pragma unroll
          for (int j = 0; j < S; ++j) acc[q] = fmaf(tv[j], xv[q + j], acc[q]);
      }
      const int hq = h0 + hb * RB;
#pragma unroll
      for (int q = 0; q < RB; ++q)
        if (hq + q < h1)
          store<T>(out, p * plane + (long long)(hq + q) * W + ww, acc[q],
                   accumulate);
    }
  }
  if (part != nullptr) stats_epilogue<T>(out, part, g, p0, h0, h1);
}

// Shared tile of one plane for a row tile of TH, and the work items (one
// per thread) the block's G planes hold.
void tile_shape(int variant, int H, int W, int kh, int kw, int TH,
                int* rows_in, int* Wp, int* items) {
  if (variant == 1) {             // (K, 5)
    *rows_in = H < TH + kh - 1 ? H : TH + kh - 1;
    *Wp = ((W + RB - 1) / RB * RB + kShort - 1) | 1;
    *items = TH * ((W + RB - 1) / RB);
  } else if (variant == 2) {      // (5, K)
    *rows_in = (TH + RB - 1) / RB * RB + kShort - 1;
    *Wp = W;
    *items = (TH + RB - 1) / RB * W;
  } else {
    *rows_in = H < TH + kh - 1 ? H : TH + kh - 1;
    *Wp = W + kw - 1;
    *items = TH * W;
  }
}

int variant_of(int kh, int kw) {
  return (kw == kShort && kh != kShort) ? 1
         : (kh == kShort && kw != kShort) ? 2 : 0;
}

// The launch geometry: planes a block (G), output rows a block (TH) and
// the shared memory it takes. Returns false when no tile fits.
bool make_geom(long long N, int C, int H, int W, int kh, int kw, Geom* gp,
               size_t* smem_out) {
  const int variant = variant_of(kh, kw);
  Geom g{};
  g.planes = N * C;
  g.C = C; g.H = H; g.W = W; g.kh = kh; g.kw = kw;
  int items;
  g.TH = H;
  tile_shape(variant, H, W, kh, kw, g.TH, &g.rows_in, &g.Wp, &items);
  // several planes a block where one plane has little work
  g.G = items >= 2 * kThreads ? 1 : 2 * kThreads / items;
  size_t smem = 0;
  for (;;) {
    tile_shape(variant, H, W, kh, kw, g.TH, &g.rows_in, &g.Wp, &items);
    smem = sizeof(float) * ((size_t)g.G * kh * kw +
                            (size_t)g.G * g.rows_in * g.Wp);
    if (smem <= kSmemMax) break;
    if (g.G > 1) g.G = (g.G + 1) / 2;
    else if (g.TH > 1) g.TH = (g.TH + 1) / 2;
    else return false;
  }
  g.n_row_tiles = (H + g.TH - 1) / g.TH;
  g.ntaps = kw;
  *gp = g;
  *smem_out = smem;
  return true;
}

template <typename T>
cudaError_t launch(const void* x, const float* w, void* out, long long N,
                   int C, int H, int W, int kh, int kw, int accumulate,
                   float* part, cudaStream_t stream) {
  const int variant = variant_of(kh, kw);
  Geom g;
  size_t smem;
  if (!make_geom(N, C, H, W, kh, kw, &g, &smem))
    return cudaErrorInvalidConfiguration;
  const long long blocks = (g.planes + g.G - 1) / g.G * g.n_row_tiles;
  void (*kernel)(const T*, const float*, T*, Geom, int, float*) =
      variant == 1 ? dwconv_tiled_kernel<T, true>
      : variant == 2 ? dwconv_tiled_kernel<T, false> : dwconv_kernel<T>;
  static bool raised[3] = {false, false, false};     // once a kernel
  if (smem > 48 * 1024 && !raised[variant]) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemMax);
    if (e != cudaSuccess) return e;
    raised[variant] = true;
  }
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), w, static_cast<T*>(out), g, accumulate,
      part);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x, out: (N, C, H, W) contiguous;
// w: (C, kh, kw) float32 taps, kh and kw odd. With accumulate the result
// is added to out. Returns the cudaError_t of the launch.
extern "C" int slak_dwconv(int dtype, const void* x, const float* w,
                           void* out, long long N, int C, int H, int W,
                           int kh, int kw, int accumulate, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(x, w, out, N, C, H, W, kh, kw, accumulate,
                              nullptr, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, w, out, N, C, H, W, kh, kw,
                                      accumulate, nullptr, s);
  return (int)cudaErrorInvalidValue;
}

// The probe: out = conv(x, w) with only the first ntaps (0 .. 5) of the 5
// tap columns of (K, 5) taps, 0 = copy the W-padded input (see the header).
// dtype, x, w, out as slak_dwconv; kw must be 5 and kh another odd size.
extern "C" int slak_dwconv_probe(int dtype, const void* x, const float* w,
                                 void* out, long long N, int C, int H, int W,
                                 int kh, int kw, int ntaps, void* stream) {
  if (variant_of(kh, kw) != 1 || ntaps < 0 || ntaps > kShort)
    return (int)cudaErrorInvalidValue;
  Geom g;
  size_t smem;
  if (!make_geom(N, C, H, W, kh, kw, &g, &smem))
    return (int)cudaErrorInvalidConfiguration;
  g.ntaps = ntaps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long blocks = (g.planes + g.G - 1) / g.G * g.n_row_tiles;
  cudaError_t e;
  static bool raised[2] = {false, false};             // once a dtype
  if (dtype == 0) {
    auto k = dwconv_tiled_kernel<float, true, true>;
    if (!raised[0]) {
      e = cudaFuncSetAttribute(
          k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemMax);
      if (e != cudaSuccess) return (int)e;
      raised[0] = true;
    }
    k<<<(unsigned)blocks, kThreads, smem, s>>>(
        static_cast<const float*>(x), w, static_cast<float*>(out), g, 0,
        nullptr);
  } else if (dtype == 1) {
    auto k = dwconv_tiled_kernel<__nv_bfloat16, true, true>;
    if (!raised[1]) {
      e = cudaFuncSetAttribute(
          k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemMax);
      if (e != cudaSuccess) return (int)e;
      raised[1] = true;
    }
    k<<<(unsigned)blocks, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), w,
        static_cast<__nv_bfloat16*>(out), g, 0, nullptr);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The float32 scratch the stats variant needs: 2 * N * C * row tiles
// (-1 when no tile fits).
extern "C" long long slak_dwconv_stats_scratch(long long N, int C, int H,
                                               int W, int kh, int kw) {
  Geom g;
  size_t smem;
  if (!make_geom(N, C, H, W, kh, kw, &g, &smem)) return -1;
  return 2 * N * C * (long long)g.n_row_tiles;
}

// out = conv(x, w) as slak_dwconv (no accumulate), and s1[c], s2[c] = the
// fp32 sum and sum of squares of channel c of the stored out. part:
// slak_dwconv_stats_scratch floats. Two launches.
extern "C" int slak_dwconv_stats(int dtype, const void* x, const float* w,
                                 void* out, float* part, float* s1, float* s2,
                                 long long N, int C, int H, int W, int kh,
                                 int kw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Geom g;
  size_t smem;
  if (!make_geom(N, C, H, W, kh, kw, &g, &smem))
    return (int)cudaErrorInvalidConfiguration;
  cudaError_t e;
  if (dtype == 0)
    e = launch<float>(x, w, out, N, C, H, W, kh, kw, 0, part, s);
  else if (dtype == 1)
    e = launch<__nv_bfloat16>(x, w, out, N, C, H, W, kh, kw, 0, part, s);
  else
    return (int)cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  dwconv_stats_reduce<<<C, kThreads, 0, s>>>(part, s1, s2, N, C,
                                             g.n_row_tiles);
  return (int)cudaGetLastError();
}
