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
// run_variant (variant_kernel), the TPU's probe of K1's fixed cost: K1
// with only the first ntaps of the 5 tap columns of (K, 5) taps; ntaps = 0
// runs no tap and copies the W-padded input's first W columns, as the TPU
// copy-only twin does (x_ref[i, :, 0:W, :]): out[h][w] = x[h][w - 2], zero
// for w < 2. bf16 probes the band route (below), the kernel every bf16
// (K, 5) K1 launch on maps up to 64 takes: ntaps = 5 is K1's own band
// launch (the same bits), ntaps < 5 dwconv_band_probe_kernel, the band
// kernel with the band tiles and products of taps j >= ntaps left out;
// with ntaps = 0 its accumulators take the staged operand's j = 0 rows,
// each 8 x 8 block transposed in registers by one movmatrix (the (5, K)
// store's transpose; no identity product), so the copy costs the band
// kernel's staging, stores and one fragment load a tile. fp32 probes the
// (K, 5) tiled kernel instantiated with the tap limit (PROBE = true). K1's
// own instantiations (PROBE = false) are unchanged.
//
// Band route (slak_dwconv_band, slak_dwconv_band_stats: bf16, taps (K, 5)
// or (5, K)): both map axes at most 64 (SLaK-T's four stages at 224^2)
// take dwconv_band_kernel; larger maps with K <= 65 and the long tap axis
// at most 512 (the seg crop's 128^2 stage 1, any input above 256^2) take
// dwconv_band_slice_kernel (below); other taps and maps the tiled kernels.
// Both are the same two TPU kernels in their own form, per-channel banded
// products against the batch, on the tensor cores (mma.sync m16n8k16,
// bf16 in, fp32 sums). With
// L the long tap axis of the map (H for (K, 5), W for (5, K)) and F the
// other, both orientations are one product for each tap j < 5 of the short
// axis:
//   C[m][(n, f)] += sum_k A_j[m][k] X_n[f + j - 2][k],
//   A_j[m][k] = t(k - m + K/2, j) (zero off the band),
// M = m < L, K = k < L, N = (image, f), X_n the plane with the long axis
// contiguous: (K, 5) stages it transposed (X[w][h]), (5, K) as it lies;
// C[m][(n, f)] is out[n][m][f] for (K, 5), out[n][f][m] for (5, K).
// The shift j - 2 is a row offset of the staged operand (each image has 2
// zero rows before and after its F rows, F padded to 8), which ldmatrix
// addresses freely, so the fp32 accumulators are the output tile: no
// partial product goes through shared memory. A_j is Toeplitz in 16 x 16
// tiles, tile (mt, kt) = D_j[kt - mt] (its columns beyond L meet zero
// columns of X): a block keeps 5 (2 MT - 1) tiles, MT = ceil(L / 16), and
// skips those off the band. The taps come in already rounded to bf16 by
// every bf16 caller, so the bf16 band is exact.
//
// A block takes one channel and a run of images, NB a chunk (the images
// whose tiles the 8 warps take in one round), and builds the channel's band
// tiles once. Chunks are double-buffered with one barrier a chunk: while
// chunk q's products run, chunk q + 1 (loaded into registers during chunk
// q - 1) is written to the other staged buffer and chunk q + 2 is loaded.
// A warp moves a plane in 8 x 8 blocks, a lane two neighbouring values
// (one 4-byte load, two 2-byte loads where W is odd), and the (K, 5)
// orientation transposes each block in registers with movmatrix, so the
// staged stores are 4 bytes and free of bank conflicts. The accumulators
// are stored from the fragments, two values along w a store ((5, K)
// transposes each 8 x 8 fragment block with movmatrix first, its fp32
// values as two 16-bit halves), in accumulate mode after adding what
// `out` holds (one rounding; the loads an n-tile needs issued together,
// but at MT = 1 in place). The stats variant (part != nullptr) sums the
// stored values and their squares in each thread's store order in fp32
// (separate multiply and add, so a plain version can repeat the sums) and
// writes one partial pair per (image run, channel), summed by
// dwconv_stats_reduce in a fixed order: no atomics, no re-read of `out`.
//
// What bounds it on an H100: the bytes (x read once, out written once).
// The products run well below the tensor cores' rate; what is left is
// latency: the staging, the fragment loads and the per-block set-up (the
// band build), with 16 (32 on the small maps) warps an SM.
//
// dwconv_band_slice_kernel (maps above 64). The whole-image kernel stops
// at 64: a chunk holds whole images in the lanes' staging registers (a
// 128^2 plane is 256 8 x 8 blocks against 128), a warp holds all MT
// m-tiles' accumulators and B fragments, and the block builds all 2 MT -
// 1 diagonals of band tiles, though only |d| <= DL = (K/2 + 15) / 16 are
// live (2 for K = 47-65: 5 of 15 at MT = 8). So here:
// - a chunk is an F-slice of one image: FS rows of F (a multiple of 8, as
//   few slices as the staging registers allow, of equal size) staged
//   between the 2 rows of F on each side (zero off the map), the whole
//   long axis (16 MT + 8 columns) as the products' k; the halo rows are
//   read beside the slice's blocks (value pairs, 4 a lane at most), so x
//   is read once but for them;
// - a warp's unit is (an m-band of MBR <= 4 m-tiles, 2 n-tiles): its
//   accumulators are those of the whole-image kernel at MT <= 4, and its B
//   fragments the band's k-tiles m0 - 2 .. m0 + MBR + 1;
// - only the 5 (2 DL + 1) live band tiles are built and multiplied.
// A block takes one channel and a run of chunks (image, slice), double
// buffered as above; K4's sums are one partial pair a block in each
// thread's store order, summed by dwconv_stats_reduce. The products, the
// stores and the sums' order are the whole-image kernel's.

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

// ---------------------------------------------------------------------------
// The band route (see the header).

using bf16 = __nv_bfloat16;

constexpr int kBandMax = 64;           // either map axis: at most 4 tiles
                                       // (ops/dwconv.py BAND_WHOLE_MAX)
constexpr int kBandPitch = 24;         // a band tile's row pitch (16 + 8)
constexpr int kBandTile = 16 * kBandPitch;
constexpr size_t kBandSmemMax = 200 * 1024;

struct BandGeom {
  int N, C, H, W, K, long_h;
  int L, F;            // the long tap axis of the map, the other axis
  int NTI, RPI, P;     // n-tiles an image (F to 8), staged rows an image
                       // (F to 8, + 4 halo rows), staged row pitch (L to
                       // 16, + 8)
  int BW, BPI;         // 8 x 8 blocks of a plane: across W, in all
  int HW, NB, CPB;     // plane; images a chunk; chunks a block
  int b_off, b_bytes;  // shared memory: the band tiles at 0, then the two
                       // staged buffers (b_bytes each)
};

// Per m-tile count MT (chosen by in-call A/B on the H100, PERF.md): the
// n-tiles of 8 a warp takes (MT * WN accumulator tiles), the 8 x 8 blocks
// a warp stages a chunk (its registers a lane), and the blocks an SM the
// registers are held to. The small maps (MT = 1) trade chunk size for
// occupancy; at MT = 4, three blocks an SM spill.
__host__ __device__ constexpr int band_wn(int MT) {
  return MT <= 2 ? 4 : 2;
}
__host__ __device__ constexpr int band_pre(int MT) {
  return MT == 1 ? 8 : 16;
}
__host__ __device__ constexpr int band_min_blocks(int MT) {
  return MT == 1 ? 4 : 2;
}

__device__ __forceinline__ void ldsm_x4(unsigned* r, const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// the transpose of the warp's 8 x 8 matrix of 16-bit values held as
// mma fragments (lane: row lane / 4, columns 2 (lane % 4) and + 1)
__device__ __forceinline__ unsigned movt(unsigned v) {
  unsigned d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(d) : "r"(v));
  return d;
}

// d += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float bf_lo(unsigned v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf_hi(unsigned v) {
  return __uint_as_float(v & 0xffff0000u);
}

// A chunk's 8 x 8 blocks: block b = warp + 8 i of the lane's loads and
// stores, image b / BPI; blk[b] = (its offset in the chunk's planes, its
// offset in a staged buffer, the rows and columns of the map it holds).
__device__ __forceinline__ void band_blocks(const BandGeom& g, int4* blk) {
  for (int b = threadIdx.x; b < g.NB * g.BPI; b += kThreads) {
    const int img = b / g.BPI, rem = b - img * g.BPI;
    const int bh = rem / g.BW, bw = rem - bh * g.BW;
    const int row = g.long_h ? bw : bh, col = g.long_h ? bh : bw;
    blk[b] = make_int4(img * g.C * g.HW + bh * 8 * g.W + bw * 8,
                       (img * g.RPI + 2 + row * 8) * g.P + col * 8,
                       g.H - bh * 8, g.W - bw * 8);
  }
}

// The chunk's planes (nimg images from image n, channel c) into registers,
// a block at a time: the lane's two values at (row lane / 4, columns
// 2 (lane % 4) and + 1) of the block, one 4-byte load where W is even
// (PAIR), else two 2-byte loads; zero outside the map.
template <int PRE, bool PAIR>
__device__ __forceinline__ void band_load(const BandGeom& g, const int4* blk,
                                          const bf16* x, int n, int nimg,
                                          int c, unsigned* pre) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lr = lane >> 2, lc = 2 * (lane & 3);
  const int nblk = nimg * g.BPI;
  const unsigned short* base = reinterpret_cast<const unsigned short*>(
      x + ((long long)n * g.C + c) * g.HW) + lr * g.W + lc;
#pragma unroll
  for (int i = 0; i < PRE; ++i) {
    const int b = warp + i * kWarps;
    if (b >= nblk) break;
    const int4 e = blk[b];
    const unsigned short* p = base + e.x;
    unsigned v = 0u;
    if (lr < e.z && lc < e.w) {
      if (PAIR)
        v = *reinterpret_cast<const unsigned*>(p);
      else
        v = p[0] | (lc + 1 < e.w ? (unsigned)p[1] << 16 : 0u);
    }
    pre[i] = v;
  }
}

// The registers into a staged buffer: image img's rows at img * RPI, value
// (h, w) at row 2 + w, column h for (K, 5) (each block transposed in
// registers with movmatrix) and at row 2 + h, column w for (5, K); 4-byte
// stores. The blocks' zero values outside the map fill the padding.
template <int PRE>
__device__ __forceinline__ void band_stage(const BandGeom& g, const int4* blk,
                                           bf16* bs, int nimg,
                                           const unsigned* pre) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nblk = nimg * g.BPI;
  bf16* base = bs + (lane >> 2) * g.P + 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < PRE; ++i) {
    const int b = warp + i * kWarps;
    if (b >= nblk) break;
    *reinterpret_cast<unsigned*>(base + blk[b].y) =
        g.long_h ? movt(pre[i]) : pre[i];
  }
}

// The two values `out` holds at (r, cc) and (r, cc + 1) of a plane (zero
// outside the map), as a bf16 pair.
template <bool PAIR>
__device__ __forceinline__ unsigned band_old(const BandGeom& g,
                                             const bf16* out, long long plane,
                                             int r, int cc) {
  if (r >= g.H || cc >= g.W) return 0u;
  const unsigned short* p =
      reinterpret_cast<const unsigned short*>(out + plane + r * g.W + cc);
  if (PAIR) return *reinterpret_cast<const unsigned*>(p);
  return p[0] | (cc + 1 < g.W ? (unsigned)p[1] << 16 : 0u);
}

// Two output values at (r, cc) and (r, cc + 1) of a plane: in accumulate
// mode plus what `out` holds there (`old`, or with LOAD loaded here),
// rounded once, stored where inside the map; the stats variant sums the
// stored values and their squares.
template <bool PAIR, bool LOAD>
__device__ __forceinline__ void band_put(const BandGeom& g, bf16* out,
                                         long long plane, int r, int cc,
                                         float v0, float v1, int accumulate,
                                         unsigned old, bool stats, float& s,
                                         float& q) {
  if (r >= g.H || cc >= g.W) return;
  const bool two = PAIR || cc + 1 < g.W;
  bf16* dst = out + plane + r * g.W + cc;
  if (accumulate) {
    if (LOAD) {
      if (PAIR) {
        old = *reinterpret_cast<const unsigned*>(dst);
      } else {
        old = __bfloat16_as_ushort(dst[0]);
        if (two) old |= (unsigned)__bfloat16_as_ushort(dst[1]) << 16;
      }
    }
    v0 += bf_lo(old);
    v1 += bf_hi(old);
  }
  const bf16 y0 = __float2bfloat16(v0), y1 = __float2bfloat16(v1);
  if (PAIR) {
    *reinterpret_cast<unsigned*>(dst) =
        (unsigned)__bfloat16_as_ushort(y0) |
        ((unsigned)__bfloat16_as_ushort(y1) << 16);
  } else {
    dst[0] = y0;
    if (two) dst[1] = y1;
  }
  if (stats) {
    const float a = __bfloat162float(y0), b = __bfloat162float(y1);
    s = __fadd_rn(s, a);
    q = __fadd_rn(q, __fmul_rn(a, a));
    if (two) {
      s = __fadd_rn(s, b);
      q = __fadd_rn(q, __fmul_rn(b, b));
    }
  }
}

// The products of a chunk of T n-tiles (images n ..) and their stores:
// warp tile wt = n-tiles [wt * WN, wt * WN + WN), all MT m-tiles. For each
// tap j: the B fragments of the warp's n-tiles at every k-tile (rows
// shifted by j), then each band tile D_j[d] on the band once, into every
// (m-tile, k-tile = m-tile + d). The accumulators are the output tile:
// (K, 5) stores them as they lie (row m = h, columns f = w), (5, K) after
// a movmatrix transpose of each 8 x 8 block (its fp32 values as two 16-bit
// halves), so both store value pairs along w. The probe (PROBE) runs the
// taps j < ntaps only, and with ntaps = 0 the (K, 5) copy: the j = 0 B
// fragments of each k-tile transposed into the accumulators of the m-tile
// of the same index (out[h][w] = x[h][w - 2]).
template <int MT, bool PAIR, bool PROBE = false>
__device__ __forceinline__ void band_products(
    const BandGeom& g, const bf16* band, const bf16* bs, bf16* out, int n,
    int c, int T, int accumulate, bool stats, float& s, float& q,
    int ntaps = kShort) {
  constexpr int WN = band_wn(MT), ND = 2 * MT - 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int pk = g.K / 2;
  const bf16* a_lane = band + ((lane & 7) + ((lane >> 3) & 1) * 8) *
                                  kBandPitch + (lane >> 4) * 8;
  const int WT = (T + WN - 1) / WN;
  for (int wt = warp; wt < WT; wt += kWarps) {
    float acc[MT][WN][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nn = 0; nn < WN; ++nn)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nn][i] = 0.f;
    // the lane's ldmatrix row of each pair of n-tiles (lanes 16-31: the
    // pair's second); an n-tile past the chunk reads the last one's rows
    int brow[WN / 2];
#pragma unroll
    for (int p = 0; p < WN / 2; ++p) {
      const int nt = min(wt * WN + 2 * p + (lane >> 4), T - 1);
      const int img = nt / g.NTI, f0 = (nt - img * g.NTI) * 8;
      brow[p] = (img * g.RPI + f0 + (lane & 7)) * g.P +
                ((lane >> 3) & 1) * 8;
    }
    if (PROBE && ntaps == 0) {
#pragma unroll
      for (int kt = 0; kt < MT; ++kt)
#pragma unroll
        for (int p = 0; p < WN / 2; ++p) {
          unsigned r[4];
          ldsm_x4(r, bs + brow[p] + kt * 16);
#pragma unroll
          for (int i = 0; i < 4; ++i) {    // n-tile 2 p + i / 2, half i % 2
            const unsigned v = movt(r[i]);
            acc[kt][2 * p + i / 2][2 * (i % 2)] = bf_lo(v);
            acc[kt][2 * p + i / 2][2 * (i % 2) + 1] = bf_hi(v);
          }
        }
    }
#pragma unroll
    for (int j = 0; j < kShort; ++j) {
      if (PROBE && j >= ntaps) break;
      unsigned b[MT][WN][2];
#pragma unroll
      for (int kt = 0; kt < MT; ++kt)
#pragma unroll
        for (int p = 0; p < WN / 2; ++p) {
          unsigned r[4];
          ldsm_x4(r, bs + brow[p] + j * g.P + kt * 16);
          b[kt][2 * p][0] = r[0];
          b[kt][2 * p][1] = r[1];
          b[kt][2 * p + 1][0] = r[2];
          b[kt][2 * p + 1][1] = r[3];
        }
#pragma unroll
      for (int di = 0; di < ND; ++di) {
        const int d = di - (MT - 1);
        if (16 * (d < 0 ? -d : d) - 15 > pk) continue;     // off the band
        unsigned a[4];
        ldsm_x4(a, a_lane + (j * ND + di) * kBandTile);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int kt = mt + d;
          if (kt < 0 || kt >= MT) continue;
#pragma unroll
          for (int nn = 0; nn < WN; ++nn)
            mma_bf16(acc[mt][nn], a, b[kt][nn][0], b[kt][nn][1]);
        }
      }
    }
    // the tile's stores, an n-tile at a time: output (r, cc) of fragment
    // half hf of (mt, nn); in accumulate mode what `out` holds at the
    // n-tile's outputs is loaded first, all at once (at MT = 1, where the
    // registers are held to 64, just before each store)
#pragma unroll
    for (int nn = 0; nn < WN; ++nn) {
      const int nt = wt * WN + nn;
      if (nt >= T) break;
      const int img = nt / g.NTI, f0 = (nt - img * g.NTI) * 8;
      const long long plane = ((long long)(n + img) * g.C + c) * g.HW;
      const auto r_of = [&](int mt, int hf) {
        return g.long_h ? mt * 16 + 8 * hf + gid : f0 + gid;
      };
      const auto cc_of = [&](int mt, int hf) {
        return g.long_h ? f0 + 2 * tig : mt * 16 + 8 * hf + 2 * tig;
      };
      unsigned old[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          old[mt][hf] = MT > 1 && accumulate
                            ? band_old<PAIR>(g, out, plane, r_of(mt, hf),
                                             cc_of(mt, hf)) : 0u;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float v0 = acc[mt][nn][2 * hf], v1 = acc[mt][nn][2 * hf + 1];
          if (!g.long_h) {        // (5, K): the 8 x 8 block transposed
            const unsigned u0 = __float_as_uint(v0), u1 = __float_as_uint(v1);
            const unsigned hi = movt(__byte_perm(u0, u1, 0x7632));
            const unsigned lo = movt(__byte_perm(u0, u1, 0x5410));
            v0 = __uint_as_float(__byte_perm(lo, hi, 0x5410));
            v1 = __uint_as_float(__byte_perm(lo, hi, 0x7632));
          }
          band_put<PAIR, MT == 1>(g, out, plane, r_of(mt, hf),
                                  cc_of(mt, hf), v0, v1, accumulate,
                                  old[mt][hf], stats, s, q);
        }
    }
  }
}

template <int MT, bool PAIR>
__global__ void __launch_bounds__(kThreads, band_min_blocks(MT))
dwconv_band_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
                   bf16* __restrict__ out, BandGeom g, int accumulate,
                   float* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char band_smem[];
  constexpr int ND = 2 * MT - 1, PRE = band_pre(MT);
  bf16* band = reinterpret_cast<bf16*>(band_smem);
  bf16* bsb[2] = {reinterpret_cast<bf16*>(band_smem + g.b_off),
                  reinterpret_cast<bf16*>(band_smem + g.b_off + g.b_bytes)};
  const int c = blockIdx.x % g.C, grp = blockIdx.x / g.C;
  const int n_begin = grp * g.CPB * g.NB;
  const int n_end = min(g.N, n_begin + g.CPB * g.NB);
  const int nq = (n_end - n_begin + g.NB - 1) / g.NB;
  const int pk = g.K / 2;
  const bool stats = part != nullptr;

  __shared__ int4 blk[PRE * kWarps];
  band_blocks(g, blk);
  __syncthreads();
  unsigned pre[PRE];
  band_load<PRE, PAIR>(g, blk, x, n_begin, min(g.NB, n_end - n_begin), c,
                       pre);
  // both staged buffers zeroed once (their halo rows and padding stay
  // zero), and the channel's band tiles D_j[d], d = -(MT-1) .. MT-1, 8
  // values a store (tiles off the band are never read, nor built)
  for (int i = threadIdx.x; i < 2 * g.b_bytes / 16; i += kThreads)
    reinterpret_cast<uint4*>(bsb[0])[i] = make_uint4(0u, 0u, 0u, 0u);
  const float* wc = w + (long long)c * g.K * kShort;
  for (int i = threadIdx.x; i < kShort * ND * 32; i += kThreads) {
    const int jd = i >> 5, r = (i >> 1) & 15, c0 = (i & 1) * 8;
    const int j = jd / ND, d = jd - j * ND - (MT - 1);
    if (16 * (d < 0 ? -d : d) - 15 > pk) continue;
    unsigned v[4];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int k = 16 * d + c0 + e - r + pk;
      float t = 0.f;
      if (k >= 0 && k < g.K)
        t = g.long_h ? wc[k * kShort + j] : wc[j * g.K + k];
      const unsigned h = __bfloat16_as_ushort(__float2bfloat16(t));
      v[e >> 1] = e & 1 ? v[e >> 1] | h << 16 : h;
    }
    *reinterpret_cast<uint4*>(band + jd * kBandTile + r * kBandPitch + c0) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
  __syncthreads();
  band_stage<PRE>(g, blk, bsb[0], min(g.NB, n_end - n_begin), pre);
  if (nq > 1)
    band_load<PRE, PAIR>(g, blk, x, n_begin + g.NB,
                         min(g.NB, n_end - n_begin - g.NB), c, pre);
  __syncthreads();

  // chunk qi: stage chunk qi + 1 into the other buffer and start loading
  // chunk qi + 2, then chunk qi's products and stores; one barrier
  float s = 0.f, q = 0.f;
  for (int qi = 0; qi < nq; ++qi) {
    const int n = n_begin + qi * g.NB, nimg = min(g.NB, n_end - n);
    if (qi + 1 < nq) {
      band_stage<PRE>(g, blk, bsb[(qi + 1) & 1],
                      min(g.NB, n_end - n - g.NB), pre);
      if (qi + 2 < nq)
        band_load<PRE, PAIR>(g, blk, x, n + 2 * g.NB,
                             min(g.NB, n_end - n - 2 * g.NB), c, pre);
    }
    band_products<MT, PAIR>(g, band, bsb[qi & 1], out, n, c, nimg * g.NTI,
                            accumulate, stats, s, q);
    __syncthreads();
  }
  if (stats) {
    __shared__ float red[2][kWarps];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    s = warp_sum(s);
    q = warp_sum(q);
    if (lane == 0) {
      red[0][warp] = s;
      red[1][warp] = q;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float a = 0.f, b = 0.f;
      for (int i = 0; i < kWarps; ++i) {
        a += red[0][i];
        b += red[1][i];
      }
      float* dst = part + ((long long)grp * g.C + c) * 2;
      dst[0] = a;
      dst[1] = b;
    }
  }
}

// K13 on the band route, (K, 5) taps, ntaps < 5 (see the header):
// dwconv_band_kernel's blocks, chunks, staging and stores, with the band
// tiles of the taps j < ntaps only built and multiplied; no accumulate, no
// stats.
template <int MT, bool PAIR>
__global__ void __launch_bounds__(kThreads, band_min_blocks(MT))
dwconv_band_probe_kernel(const bf16* __restrict__ x,
                         const float* __restrict__ w, bf16* __restrict__ out,
                         BandGeom g, int ntaps) {
  extern __shared__ __align__(16) unsigned char band_smem[];
  constexpr int ND = 2 * MT - 1, PRE = band_pre(MT);
  bf16* band = reinterpret_cast<bf16*>(band_smem);
  bf16* bsb[2] = {reinterpret_cast<bf16*>(band_smem + g.b_off),
                  reinterpret_cast<bf16*>(band_smem + g.b_off + g.b_bytes)};
  const int c = blockIdx.x % g.C, grp = blockIdx.x / g.C;
  const int n_begin = grp * g.CPB * g.NB;
  const int n_end = min(g.N, n_begin + g.CPB * g.NB);
  const int nq = (n_end - n_begin + g.NB - 1) / g.NB;
  const int pk = g.K / 2;

  __shared__ int4 blk[PRE * kWarps];
  band_blocks(g, blk);
  __syncthreads();
  unsigned pre[PRE];
  band_load<PRE, PAIR>(g, blk, x, n_begin, min(g.NB, n_end - n_begin), c,
                       pre);
  for (int i = threadIdx.x; i < 2 * g.b_bytes / 16; i += kThreads)
    reinterpret_cast<uint4*>(bsb[0])[i] = make_uint4(0u, 0u, 0u, 0u);
  const float* wc = w + (long long)c * g.K * kShort;
  for (int i = threadIdx.x; i < ntaps * ND * 32; i += kThreads) {
    const int jd = i >> 5, r = (i >> 1) & 15, c0 = (i & 1) * 8;
    const int j = jd / ND, d = jd - j * ND - (MT - 1);
    if (16 * (d < 0 ? -d : d) - 15 > pk) continue;
    unsigned v[4];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int k = 16 * d + c0 + e - r + pk;
      const float t = k >= 0 && k < g.K ? wc[k * kShort + j] : 0.f;
      const unsigned h = __bfloat16_as_ushort(__float2bfloat16(t));
      v[e >> 1] = e & 1 ? v[e >> 1] | h << 16 : h;
    }
    *reinterpret_cast<uint4*>(band + jd * kBandTile + r * kBandPitch + c0) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
  __syncthreads();
  band_stage<PRE>(g, blk, bsb[0], min(g.NB, n_end - n_begin), pre);
  if (nq > 1)
    band_load<PRE, PAIR>(g, blk, x, n_begin + g.NB,
                         min(g.NB, n_end - n_begin - g.NB), c, pre);
  __syncthreads();

  float s = 0.f, q = 0.f;
  for (int qi = 0; qi < nq; ++qi) {
    const int n = n_begin + qi * g.NB, nimg = min(g.NB, n_end - n);
    if (qi + 1 < nq) {
      band_stage<PRE>(g, blk, bsb[(qi + 1) & 1],
                      min(g.NB, n_end - n - g.NB), pre);
      if (qi + 2 < nq)
        band_load<PRE, PAIR>(g, blk, x, n + 2 * g.NB,
                             min(g.NB, n_end - n - 2 * g.NB), c, pre);
    }
    band_products<MT, PAIR, true>(g, band, bsb[qi & 1], out, n, c,
                                  nimg * g.NTI, 0, false, s, q, ntaps);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// The band route above 64: F-slices (see the header).

constexpr int kSliceLMax = 512;        // the long axis: 32 m-tiles
constexpr int kSliceDL = 2;            // live diagonals each side (K <= 65)
constexpr int kSliceND = 2 * kSliceDL + 1;
constexpr int kSliceMB = 4;            // m-tiles a warp's band at most
constexpr int kSliceWN = 2;            // n-tiles a warp's unit
constexpr int kSlicePre = 16;          // 8 x 8 blocks a lane stages a chunk
constexpr int kSliceHalo = 4;          // halo value pairs a lane stages

// BandGeom's fields as the slice kernel reads them: NTI n-tiles a slice,
// RPI staged rows a slice (FS + 4), P the row pitch (16 MT + 8), CPB
// chunks (image, slice) a block; NB, BW and BPI unused.
struct SliceGeom : BandGeom {
  int MT, LB;          // m-tiles (16) and 8 x 8 blocks along L
  int NS, FS;          // slices an image, rows of F a slice (8 NTI)
  int NMB, MBR, NG;    // m-bands, m-tiles a band, unit n-tile groups
  int DL;              // live diagonals on each side of the main one
};

// A slice's 8 x 8 blocks, b = fb * LB + lb (fb along F, lb along L):
// blk[b] = (its offset in the plane from the slice's first row of F, its
// offset in a staged buffer, 8 lb, 8 fb).
__device__ __forceinline__ void slice_blocks(const SliceGeom& g, int4* blk) {
  for (int b = threadIdx.x; b < g.NTI * g.LB; b += kThreads) {
    const int fb = b / g.LB, lb = b - fb * g.LB;
    blk[b] = make_int4(g.long_h ? 8 * lb * g.W + 8 * fb
                                : 8 * fb * g.W + 8 * lb,
                       (2 + 8 * fb) * g.P + 8 * lb, 8 * lb, 8 * fb);
  }
}

// Chunk q (image q / NS, slice q % NS: rows [f0, f0 + FS) of F) of
// channel c into registers: the slice's blocks as band_load reads them
// (zero outside the map), and its 4 halo rows of F (f0 - 2, f0 - 1, f0 +
// FS, f0 + FS + 1; zero outside the map) as value pairs: (K, 5) the pair
// of columns w = f0 - 2, f0 - 1 or f0 + FS, f0 + FS + 1 of row h (lane
// item t: side t / L, h = t % L), (5, K) two neighbouring values of a row
// (item t: row t / ceil(L / 2), columns 2 (t % ceil(L / 2)) and + 1).
template <bool PAIR>
__device__ __forceinline__ void slice_load(const SliceGeom& g,
                                           const int4* blk, const bf16* x,
                                           int q, int c, unsigned* pre,
                                           unsigned* hpre) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lr = lane >> 2, lc = 2 * (lane & 3);
  const int n = q / g.NS, f0 = (q - n * g.NS) * g.FS;
  const int nblk = g.NTI * g.LB;
  const unsigned short* plane = reinterpret_cast<const unsigned short*>(
      x + ((long long)n * g.C + c) * g.HW);
  const unsigned short* base =
      plane + (g.long_h ? f0 : f0 * g.W) + lr * g.W + lc;
#pragma unroll
  for (int i = 0; i < kSlicePre; ++i) {
    const int b = warp + i * kWarps;
    if (b >= nblk) break;
    const int4 e = blk[b];
    const int rows = g.long_h ? g.H - e.z : g.H - f0 - e.w;
    const int cols = g.long_h ? g.W - f0 - e.w : g.W - e.z;
    const unsigned short* p = base + e.x;
    unsigned v = 0u;
    if (lr < rows && lc < cols) {
      if (PAIR)
        v = *reinterpret_cast<const unsigned*>(p);
      else
        v = p[0] | (lc + 1 < cols ? (unsigned)p[1] << 16 : 0u);
    }
    pre[i] = v;
  }
  const int lp = (g.L + 1) / 2;
#pragma unroll
  for (int i = 0; i < kSliceHalo; ++i) {
    const int t = threadIdx.x + i * kThreads;
    unsigned v = 0u;
    if (g.long_h) {
      if (t >= 2 * g.L) break;
      const int side = t >= g.L, h = t - side * g.L;
      const int w0 = side ? f0 + g.FS : f0 - 2;
      const unsigned short* p = plane + h * g.W + w0;
      if (PAIR) {
        if (w0 >= 0 && w0 < g.W) v = *reinterpret_cast<const unsigned*>(p);
      } else {
        if (w0 >= 0 && w0 < g.W) v = p[0];
        if (w0 + 1 >= 0 && w0 + 1 < g.W) v |= (unsigned)p[1] << 16;
      }
    } else {
      if (t >= 4 * lp) break;
      const int rr = t / lp, col = 2 * (t - rr * lp);
      const int row = rr < 2 ? f0 - 2 + rr : f0 + g.FS + rr - 2;
      if (row >= 0 && row < g.H) {
        const unsigned short* p = plane + row * g.W + col;
        if (PAIR)
          v = *reinterpret_cast<const unsigned*>(p);
        else
          v = p[0] | (col + 1 < g.W ? (unsigned)p[1] << 16 : 0u);
      }
    }
    hpre[i] = v;
  }
}

// The registers into a staged buffer: value (f, k) of the slice (f from
// f0 - 2) at row f, column k; the blocks as band_stage stores them, the
// halo pairs at rows 0, 1 and FS + 2, FS + 3 ((K, 5): the pair's two
// values in two rows of column h, 2-byte stores; (5, K): 4-byte stores).
__device__ __forceinline__ void slice_stage(const SliceGeom& g,
                                            const int4* blk, bf16* bs,
                                            const unsigned* pre,
                                            const unsigned* hpre) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nblk = g.NTI * g.LB;
  bf16* base = bs + (lane >> 2) * g.P + 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < kSlicePre; ++i) {
    const int b = warp + i * kWarps;
    if (b >= nblk) break;
    *reinterpret_cast<unsigned*>(base + blk[b].y) =
        g.long_h ? movt(pre[i]) : pre[i];
  }
  const int lp = (g.L + 1) / 2;
  unsigned short* hs = reinterpret_cast<unsigned short*>(bs);
#pragma unroll
  for (int i = 0; i < kSliceHalo; ++i) {
    const int t = threadIdx.x + i * kThreads;
    if (g.long_h) {
      if (t >= 2 * g.L) break;
      const int side = t >= g.L, h = t - side * g.L;
      unsigned short* p = hs + (side ? g.FS + 2 : 0) * g.P + h;
      p[0] = (unsigned short)(hpre[i] & 0xffffu);
      p[g.P] = (unsigned short)(hpre[i] >> 16);
    } else {
      if (t >= 4 * lp) break;
      const int rr = t / lp, col = 2 * (t - rr * lp);
      *reinterpret_cast<unsigned*>(hs + (rr < 2 ? rr : g.FS + rr) * g.P +
                                   col) = hpre[i];
    }
  }
}

// The products of chunk (image n, rows [f0, f0 + FS) of F) and their
// stores. Unit wt = (m-band wt % NMB: m-tiles [m0, m0 + MBR) of L, n-tile
// group wt / NMB: n-tiles 2 (wt / NMB) and + 1 of the slice); warp w
// takes units w, w + 8, ... For each tap j: the B fragments of the unit's
// n-tiles at the k-tiles m0 - 2 .. m0 + MBR + 1 (rows shifted by j; those
// off the map or the live diagonals not loaded), then each live band tile
// D_j[d], |d| <= DL, once, into every (m-tile i, k-tile i + d) of the
// band. The accumulators are stored as band_products stores them.
template <bool PAIR>
__device__ __forceinline__ void slice_products(
    const SliceGeom& g, const bf16* band, const bf16* bs, bf16* out, int n,
    int f0, int c, int accumulate, bool stats, float& s, float& q) {
  constexpr int KW = kSliceMB + 2 * kSliceDL;     // k-tiles a band reaches
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const bf16* a_lane = band + ((lane & 7) + ((lane >> 3) & 1) * 8) *
                                  kBandPitch + (lane >> 4) * 8;
  const long long plane = ((long long)n * g.C + c) * g.HW;
  const int units = g.NMB * g.NG;
  for (int wt = warp; wt < units; wt += kWarps) {
    const int mb = wt % g.NMB, ng = wt / g.NMB;
    const int m0 = mb * g.MBR, mc = min(g.MBR, g.MT - m0);
    float acc[kSliceMB][kSliceWN][4];
#pragma unroll
    for (int i = 0; i < kSliceMB; ++i)
#pragma unroll
      for (int nn = 0; nn < kSliceWN; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][nn][e] = 0.f;
    // the lane's ldmatrix row of the unit's n-tiles (lanes 16-31: the
    // second); an n-tile past the slice reads the last one's rows
    const int nt = min(ng * kSliceWN + (lane >> 4), g.NTI - 1);
    const int brow = (8 * nt + (lane & 7)) * g.P + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int j = 0; j < kShort; ++j) {
      unsigned b[KW][kSliceWN][2];
#pragma unroll
      for (int kk = 0; kk < KW; ++kk) {
        const int kt = m0 - kSliceDL + kk;
        if (kt < 0 || kt >= g.MT || kk < kSliceDL - g.DL ||
            kk > mc - 1 + kSliceDL + g.DL)
          continue;
        unsigned r[4];
        ldsm_x4(r, bs + brow + j * g.P + kt * 16);
        b[kk][0][0] = r[0];
        b[kk][0][1] = r[1];
        b[kk][1][0] = r[2];
        b[kk][1][1] = r[3];
      }
#pragma unroll
      for (int di = 0; di < kSliceND; ++di) {
        const int d = di - kSliceDL;
        if (d < -g.DL || d > g.DL) continue;
        unsigned a[4];
        ldsm_x4(a, a_lane + (j * kSliceND + di) * kBandTile);
#pragma unroll
        for (int i = 0; i < kSliceMB; ++i) {
          const int kt = m0 + i + d;
          if (i >= mc || kt < 0 || kt >= g.MT) continue;
#pragma unroll
          for (int nn = 0; nn < kSliceWN; ++nn)
            mma_bf16(acc[i][nn], a, b[i + di][nn][0], b[i + di][nn][1]);
        }
      }
    }
    // the stores, an n-tile at a time: output (r, cc) of fragment half hf
    // of (m-tile m0 + i, n-tile); in accumulate mode what `out` holds at
    // the n-tile's outputs is loaded first, all at once
#pragma unroll
    for (int nn = 0; nn < kSliceWN; ++nn) {
      const int ntl = ng * kSliceWN + nn;
      if (ntl >= g.NTI) break;
      const int f = f0 + 8 * ntl;
      const auto r_of = [&](int mt, int hf) {
        return g.long_h ? mt * 16 + 8 * hf + gid : f + gid;
      };
      const auto cc_of = [&](int mt, int hf) {
        return g.long_h ? f + 2 * tig : mt * 16 + 8 * hf + 2 * tig;
      };
      unsigned old[kSliceMB][2];
#pragma unroll
      for (int i = 0; i < kSliceMB; ++i)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          old[i][hf] = accumulate && i < mc
                           ? band_old<PAIR>(g, out, plane, r_of(m0 + i, hf),
                                            cc_of(m0 + i, hf)) : 0u;
#pragma unroll
      for (int i = 0; i < kSliceMB; ++i) {
        if (i >= mc) continue;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float v0 = acc[i][nn][2 * hf], v1 = acc[i][nn][2 * hf + 1];
          if (!g.long_h) {        // (5, K): the 8 x 8 block transposed
            const unsigned u0 = __float_as_uint(v0), u1 = __float_as_uint(v1);
            const unsigned hi = movt(__byte_perm(u0, u1, 0x7632));
            const unsigned lo = movt(__byte_perm(u0, u1, 0x5410));
            v0 = __uint_as_float(__byte_perm(lo, hi, 0x5410));
            v1 = __uint_as_float(__byte_perm(lo, hi, 0x7632));
          }
          band_put<PAIR, false>(g, out, plane, r_of(m0 + i, hf),
                                cc_of(m0 + i, hf), v0, v1, accumulate,
                                old[i][hf], stats, s, q);
        }
      }
    }
  }
}

// Grid (C * blocks a channel): block grp of channel c takes the chunks
// [grp * CPB, grp * CPB + CPB) of the channel's N * NS, in order, double
// buffered as dwconv_band_kernel's chunks are, and builds the channel's
// live band tiles D_j[d], |d| <= DL, once.
template <bool PAIR>
__global__ void __launch_bounds__(kThreads, 2)
dwconv_band_slice_kernel(const bf16* __restrict__ x,
                         const float* __restrict__ w, bf16* __restrict__ out,
                         SliceGeom g, int accumulate,
                         float* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char band_smem[];
  bf16* band = reinterpret_cast<bf16*>(band_smem);
  bf16* bsb[2] = {reinterpret_cast<bf16*>(band_smem + g.b_off),
                  reinterpret_cast<bf16*>(band_smem + g.b_off + g.b_bytes)};
  const int c = blockIdx.x % g.C, grp = blockIdx.x / g.C;
  const int q_begin = grp * g.CPB;
  const int nq = min(g.N * g.NS - q_begin, g.CPB);
  const int pk = g.K / 2;
  const bool stats = part != nullptr;

  __shared__ int4 blk[kSlicePre * kWarps];
  slice_blocks(g, blk);
  __syncthreads();
  unsigned pre[kSlicePre], hpre[kSliceHalo];
  slice_load<PAIR>(g, blk, x, q_begin, c, pre, hpre);
  // both staged buffers zeroed once (the columns past L stay zero), and
  // the channel's live band tiles, 8 values a store
  for (int i = threadIdx.x; i < 2 * g.b_bytes / 16; i += kThreads)
    reinterpret_cast<uint4*>(bsb[0])[i] = make_uint4(0u, 0u, 0u, 0u);
  const float* wc = w + (long long)c * g.K * kShort;
  for (int i = threadIdx.x; i < kShort * kSliceND * 32; i += kThreads) {
    const int jd = i >> 5, r = (i >> 1) & 15, c0 = (i & 1) * 8;
    const int j = jd / kSliceND, d = jd - j * kSliceND - kSliceDL;
    if (d < -g.DL || d > g.DL) continue;
    unsigned v[4];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int k = 16 * d + c0 + e - r + pk;
      float t = 0.f;
      if (k >= 0 && k < g.K)
        t = g.long_h ? wc[k * kShort + j] : wc[j * g.K + k];
      const unsigned h = __bfloat16_as_ushort(__float2bfloat16(t));
      v[e >> 1] = e & 1 ? v[e >> 1] | h << 16 : h;
    }
    *reinterpret_cast<uint4*>(band + jd * kBandTile + r * kBandPitch + c0) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
  __syncthreads();
  slice_stage(g, blk, bsb[0], pre, hpre);
  if (nq > 1) slice_load<PAIR>(g, blk, x, q_begin + 1, c, pre, hpre);
  __syncthreads();

  float s = 0.f, q = 0.f;
  for (int qi = 0; qi < nq; ++qi) {
    const int qq = q_begin + qi, n = qq / g.NS;
    if (qi + 1 < nq) {
      slice_stage(g, blk, bsb[(qi + 1) & 1], pre, hpre);
      if (qi + 2 < nq)
        slice_load<PAIR>(g, blk, x, qq + 2, c, pre, hpre);
    }
    slice_products<PAIR>(g, band, bsb[qi & 1], out, n,
                         (qq - n * g.NS) * g.FS, c, accumulate, stats, s, q);
    __syncthreads();
  }
  if (stats) {
    __shared__ float red[2][kWarps];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    s = warp_sum(s);
    q = warp_sum(q);
    if (lane == 0) {
      red[0][warp] = s;
      red[1][warp] = q;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float a = 0.f, b = 0.f;
      for (int i = 0; i < kWarps; ++i) {
        a += red[0][i];
        b += red[1][i];
      }
      float* dst = part + ((long long)grp * g.C + c) * 2;
      dst[0] = a;
      dst[1] = b;
    }
  }
}

int round_up(int a, int m) { return (a + m - 1) / m * m; }

// The band route's geometry: false when the shapes do not fit it. MT =
// m-tiles of the long axis, PAIR = 4-byte loads and stores (W even, the
// pointers 4-byte aligned), bpc = blocks a channel.
bool band_geom(long long N, int C, int H, int W, int kh, int kw,
               const void* x, const void* out, BandGeom* gp, int* MT,
               bool* PAIR, int* bpc, size_t* smem_out) {
  const int variant = variant_of(kh, kw);
  if (variant == 0 || N < 1 || N > (1LL << 30) || C < 1) return false;
  BandGeom g{};
  g.N = (int)N; g.C = C; g.H = H; g.W = W;
  g.long_h = variant == 1;
  g.K = g.long_h ? kh : kw;
  g.L = g.long_h ? H : W;
  g.F = g.long_h ? W : H;
  if (g.L < 1 || g.L > kBandMax || g.F < 1 || g.F > kBandMax) return false;
  const int mt = (g.L + 15) / 16;
  const int Fn = round_up(g.F, 8);
  g.NTI = Fn / 8;
  g.RPI = Fn + 4;
  g.P = 16 * mt + 8;
  g.BW = (W + 7) / 8;
  g.BPI = (H + 7) / 8 * g.BW;
  g.HW = H * W;
  // as many images as the 8 warps' tiles take in one round, and as their
  // 8 x 8 blocks take in band_pre registers a lane
  const int pre = band_pre(mt) * kWarps;
  int nb = 8 * band_wn(mt) / g.NTI;
  if (nb > pre / g.BPI) nb = pre / g.BPI;
  if (nb > g.N) nb = g.N;
  g.NB = nb < 1 ? 1 : nb;
  if (g.NB * g.BPI > pre) return false;
  // about 1024 blocks: channels times runs of chunks
  const int chunks = (g.N + g.NB - 1) / g.NB;
  int per = (1024 + C - 1) / C;
  if (per > chunks) per = chunks;
  g.CPB = (chunks + per - 1) / per;
  g.b_off = kShort * (2 * mt - 1) * kBandTile * 2;
  g.b_bytes = round_up(g.NB * g.RPI * g.P * 2, 16);
  const size_t smem = (size_t)g.b_off + 2 * (size_t)g.b_bytes;
  if (smem > kBandSmemMax) return false;
  *gp = g;
  *MT = mt;
  *PAIR = W % 2 == 0 && (((uintptr_t)x | (uintptr_t)out) & 3) == 0;
  *bpc = (chunks + g.CPB - 1) / g.CPB;
  *smem_out = smem;
  return true;
}

// The slice kernel's geometry: false when the shapes do not fit it (taps
// other than (K, 5) / (5, K), K > 65, L > 512). F is cut into NS slices of
// FS rows, as few as the lanes' staging registers allow (FS / 8 * LB <=
// 128 blocks), of equal size to 8; L into NMB m-bands of MBR <= 4 m-tiles.
bool slice_geom(long long N, int C, int H, int W, int kh, int kw,
                const void* x, const void* out, SliceGeom* gp, bool* PAIR,
                int* bpc, size_t* smem_out) {
  const int variant = variant_of(kh, kw);
  if (variant == 0 || N < 1 || N > (1LL << 30) || C < 1 || H < 1 ||
      W < 1 || (long long)H * W > (1LL << 30))
    return false;
  SliceGeom g{};
  g.N = (int)N; g.C = C; g.H = H; g.W = W;
  g.long_h = variant == 1;
  g.K = g.long_h ? kh : kw;
  g.L = g.long_h ? H : W;
  g.F = g.long_h ? W : H;
  g.DL = (g.K / 2 + 15) / 16;
  if (g.L > kSliceLMax || g.DL > kSliceDL) return false;
  g.MT = (g.L + 15) / 16;
  g.LB = (g.L + 7) / 8;
  g.NMB = (g.MT + kSliceMB - 1) / kSliceMB;
  g.MBR = (g.MT + g.NMB - 1) / g.NMB;
  const int ftiles = (g.F + 7) / 8;
  const int max_nt = kSlicePre * kWarps / g.LB;
  g.NS = (ftiles + max_nt - 1) / max_nt;
  g.NTI = (ftiles + g.NS - 1) / g.NS;
  g.FS = 8 * g.NTI;
  g.NG = (g.NTI + kSliceWN - 1) / kSliceWN;
  if ((long long)N * g.NS > (1LL << 30)) return false;
  g.RPI = g.FS + 4;
  g.P = 16 * g.MT + 8;
  g.HW = H * W;
  g.NB = 1;
  // about 512 blocks: channels times runs of chunks (1024 and 2048, the
  // whole-image kernel's and twice it, measured 4% slower at the seg
  // crop's stage 1: tools/probe_band.py --ablate)
  const int chunks = g.N * g.NS;
  int per = (512 + C - 1) / C;
  if (per > chunks) per = chunks;
  g.CPB = (chunks + per - 1) / per;
  g.b_off = kShort * kSliceND * kBandTile * 2;
  g.b_bytes = round_up(g.RPI * g.P * 2, 16);
  const size_t smem = (size_t)g.b_off + 2 * (size_t)g.b_bytes;
  if (smem > kBandSmemMax) return false;
  *gp = g;
  *PAIR = W % 2 == 0 && (((uintptr_t)x | (uintptr_t)out) & 3) == 0;
  *bpc = (chunks + g.CPB - 1) / g.CPB;
  *smem_out = smem;
  return true;
}

template <bool PAIR>
cudaError_t launch_slice_t(const SliceGeom& g, int bpc, size_t smem,
                           const void* x, const float* w, void* out,
                           int accumulate, float* part, cudaStream_t stream) {
  auto kernel = dwconv_band_slice_kernel<PAIR>;
  static bool raised = false;                 // once an instantiation
  if (!raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kBandSmemMax);
    if (e != cudaSuccess) return e;
    raised = true;
  }
  kernel<<<(unsigned)(g.C * bpc), kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), w, static_cast<bf16*>(out), g, accumulate,
      part);
  return cudaGetLastError();
}

template <int MT, bool PAIR>
cudaError_t launch_band_t(const BandGeom& g, int bpc, size_t smem,
                          const void* x, const float* w, void* out,
                          int accumulate, float* part, cudaStream_t stream) {
  auto kernel = dwconv_band_kernel<MT, PAIR>;
  static bool raised = false;                 // once an instantiation
  if (smem > 48 * 1024 && !raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kBandSmemMax);
    if (e != cudaSuccess) return e;
    raised = true;
  }
  kernel<<<(unsigned)(g.C * bpc), kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), w, static_cast<bf16*>(out), g, accumulate,
      part);
  return cudaGetLastError();
}

template <bool PAIR>
cudaError_t launch_band_p(int MT, const BandGeom& g, int bpc, size_t smem,
                          const void* x, const float* w, void* out,
                          int accumulate, float* part, cudaStream_t stream) {
  switch (MT) {
    case 1: return launch_band_t<1, PAIR>(g, bpc, smem, x, w, out,
                                          accumulate, part, stream);
    case 2: return launch_band_t<2, PAIR>(g, bpc, smem, x, w, out,
                                          accumulate, part, stream);
    case 3: return launch_band_t<3, PAIR>(g, bpc, smem, x, w, out,
                                          accumulate, part, stream);
    case 4: return launch_band_t<4, PAIR>(g, bpc, smem, x, w, out,
                                          accumulate, part, stream);
  }
  return cudaErrorInvalidValue;
}

// One launch of the band route; *bpc_out = its blocks a channel (the
// stats variant's partials per channel): dwconv_band_kernel where both map
// axes are at most 64, else dwconv_band_slice_kernel.
cudaError_t launch_band(const void* x, const float* w, void* out,
                        long long N, int C, int H, int W, int kh, int kw,
                        int accumulate, float* part, int* bpc_out,
                        cudaStream_t stream) {
  BandGeom g;
  int MT, bpc;
  bool PAIR;
  size_t smem;
  if (H > kBandMax || W > kBandMax) {
    SliceGeom sg;
    if (!slice_geom(N, C, H, W, kh, kw, x, out, &sg, &PAIR, &bpc, &smem))
      return cudaErrorInvalidValue;
    *bpc_out = bpc;
    return PAIR ? launch_slice_t<true>(sg, bpc, smem, x, w, out, accumulate,
                                       part, stream)
                : launch_slice_t<false>(sg, bpc, smem, x, w, out, accumulate,
                                        part, stream);
  }
  if (!band_geom(N, C, H, W, kh, kw, x, out, &g, &MT, &PAIR, &bpc, &smem))
    return cudaErrorInvalidValue;
  *bpc_out = bpc;
  return PAIR ? launch_band_p<true>(MT, g, bpc, smem, x, w, out, accumulate,
                                    part, stream)
              : launch_band_p<false>(MT, g, bpc, smem, x, w, out, accumulate,
                                     part, stream);
}

template <int MT, bool PAIR>
cudaError_t launch_band_probe_t(const BandGeom& g, int bpc, size_t smem,
                                const void* x, const float* w, void* out,
                                int ntaps, cudaStream_t stream) {
  auto kernel = dwconv_band_probe_kernel<MT, PAIR>;
  static bool raised = false;                 // once an instantiation
  if (smem > 48 * 1024 && !raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kBandSmemMax);
    if (e != cudaSuccess) return e;
    raised = true;
  }
  kernel<<<(unsigned)(g.C * bpc), kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), w, static_cast<bf16*>(out), g, ntaps);
  return cudaGetLastError();
}

// K13 on the band route: ntaps = 5 is K1's band launch, ntaps < 5 the
// probe kernel on the same geometry; (K, 5) taps only.
cudaError_t launch_band_probe(const void* x, const float* w, void* out,
                              long long N, int C, int H, int W, int kh,
                              int kw, int ntaps, cudaStream_t stream) {
  if (H > kBandMax || W > kBandMax) return cudaErrorInvalidValue;
  if (ntaps == kShort) {
    int bpc;
    return launch_band(x, w, out, N, C, H, W, kh, kw, 0, nullptr, &bpc,
                       stream);
  }
  BandGeom g;
  int MT, bpc;
  bool PAIR;
  size_t smem;
  if (!band_geom(N, C, H, W, kh, kw, x, out, &g, &MT, &PAIR, &bpc, &smem))
    return cudaErrorInvalidValue;
  switch (MT * 2 + (int)PAIR) {
    case 2: return launch_band_probe_t<1, false>(g, bpc, smem, x, w, out,
                                                 ntaps, stream);
    case 3: return launch_band_probe_t<1, true>(g, bpc, smem, x, w, out,
                                                ntaps, stream);
    case 4: return launch_band_probe_t<2, false>(g, bpc, smem, x, w, out,
                                                 ntaps, stream);
    case 5: return launch_band_probe_t<2, true>(g, bpc, smem, x, w, out,
                                                ntaps, stream);
    case 6: return launch_band_probe_t<3, false>(g, bpc, smem, x, w, out,
                                                 ntaps, stream);
    case 7: return launch_band_probe_t<3, true>(g, bpc, smem, x, w, out,
                                                ntaps, stream);
    case 8: return launch_band_probe_t<4, false>(g, bpc, smem, x, w, out,
                                                 ntaps, stream);
    case 9: return launch_band_probe_t<4, true>(g, bpc, smem, x, w, out,
                                                ntaps, stream);
  }
  return cudaErrorInvalidValue;
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
// bf16 runs the whole-image band kernel and returns cudaErrorInvalidValue
// for maps above 64; fp32 runs the tiled kernel.
extern "C" int slak_dwconv_probe(int dtype, const void* x, const float* w,
                                 void* out, long long N, int C, int H, int W,
                                 int kh, int kw, int ntaps, void* stream) {
  if (variant_of(kh, kw) != 1 || ntaps < 0 || ntaps > kShort)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)launch_band_probe(x, w, out, N, C, H, W, kh, kw, ntaps, s);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  Geom g;
  size_t smem;
  if (!make_geom(N, C, H, W, kh, kw, &g, &smem))
    return (int)cudaErrorInvalidConfiguration;
  g.ntaps = ntaps;
  const long long blocks = (g.planes + g.G - 1) / g.G * g.n_row_tiles;
  auto k = dwconv_tiled_kernel<float, true, true>;
  static bool raised = false;
  if (!raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemMax);
    if (e != cudaSuccess) return (int)e;
    raised = true;
  }
  k<<<(unsigned)blocks, kThreads, smem, s>>>(
      static_cast<const float*>(x), w, static_cast<float*>(out), g, 0,
      nullptr);
  return (int)cudaGetLastError();
}

// The float32 scratch the stats variant needs on a route: band = 0, the
// tiled kernel's 2 * N * C * row tiles; band = 1, the band kernel's
// 2 * C * blocks a channel (-1 when the route does not take the shapes).
extern "C" long long slak_dwconv_stats_scratch(int band, long long N, int C,
                                               int H, int W, int kh,
                                               int kw) {
  if (band) {
    BandGeom g;
    SliceGeom sg;
    int MT, bpc;
    bool PAIR;
    size_t smem;
    const bool ok =
        H > kBandMax || W > kBandMax
            ? slice_geom(N, C, H, W, kh, kw, nullptr, nullptr, &sg, &PAIR,
                         &bpc, &smem)
            : band_geom(N, C, H, W, kh, kw, nullptr, nullptr, &g, &MT,
                        &PAIR, &bpc, &smem);
    return ok ? 2LL * C * bpc : -1;
  }
  Geom g;
  size_t smem;
  if (!make_geom(N, C, H, W, kh, kw, &g, &smem)) return -1;
  return 2 * N * C * (long long)g.n_row_tiles;
}

// out = conv(x, w) as slak_dwconv (no accumulate), and s1[c], s2[c] = the
// fp32 sum and sum of squares of channel c of the stored out. part:
// slak_dwconv_stats_scratch(0, ...) floats. Two launches.
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

// The band route (bf16 only): out = conv(x, w) (+ out with accumulate), as
// slak_dwconv, for taps (K, 5) or (5, K): both map axes at most 64 on
// dwconv_band_kernel, larger maps (K <= 65, the long axis at most 512) on
// dwconv_band_slice_kernel. Returns cudaErrorInvalidValue for shapes it
// does not take.
extern "C" int slak_dwconv_band(const void* x, const float* w, void* out,
                                long long N, int C, int H, int W, int kh,
                                int kw, int accumulate, void* stream) {
  int bpc;
  return (int)launch_band(x, w, out, N, C, H, W, kh, kw, accumulate, nullptr,
                          &bpc, static_cast<cudaStream_t>(stream));
}

// The band route's stats variant: out = conv(x, w) and s1[c], s2[c] as
// slak_dwconv_stats. part: slak_dwconv_stats_scratch(1, ...) floats (one
// pair of partials per channel and block). Two launches.
extern "C" int slak_dwconv_band_stats(const void* x, const float* w,
                                      void* out, float* part, float* s1,
                                      float* s2, long long N, int C, int H,
                                      int W, int kh, int kw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int bpc;
  const cudaError_t e = launch_band(x, w, out, N, C, H, W, kh, kw, 0, part,
                                    &bpc, s);
  if (e != cudaSuccess) return (int)e;
  dwconv_stats_reduce<<<C, kThreads, 0, s>>>(part, s1, s2, bpc, C, 1);
  return (int)cudaGetLastError();
}

// The band route's geometry as its host code computes it, for checks
// against ops/dwconv.py band_geometry: v[0..10] = (slice, MT, NTI, NS,
// NMB, MBR, NG, DL, CPB, blocks a channel, shared bytes); slice = 0 (the
// whole-image kernel) gives MT, NTI, NB (in v[3]), CPB, blocks a channel
// and shared bytes, the rest 0. Returns 0, or cudaErrorInvalidValue for
// shapes the route does not take.
extern "C" int slak_dwconv_band_geom(long long N, int C, int H, int W,
                                     int kh, int kw, long long* v) {
  int bpc, MT;
  bool PAIR;
  size_t smem;
  for (int i = 0; i < 11; ++i) v[i] = 0;
  if (H > kBandMax || W > kBandMax) {
    SliceGeom g;
    if (!slice_geom(N, C, H, W, kh, kw, nullptr, nullptr, &g, &PAIR, &bpc,
                    &smem))
      return (int)cudaErrorInvalidValue;
    const long long r[11] = {1, g.MT, g.NTI, g.NS, g.NMB, g.MBR, g.NG,
                             g.DL, g.CPB, bpc, (long long)smem};
    for (int i = 0; i < 11; ++i) v[i] = r[i];
    return 0;
  }
  BandGeom g;
  if (!band_geom(N, C, H, W, kh, kw, nullptr, nullptr, &g, &MT, &PAIR, &bpc,
                 &smem))
    return (int)cudaErrorInvalidValue;
  v[1] = MT; v[2] = g.NTI; v[3] = g.NB; v[8] = g.CPB; v[9] = bpc;
  v[10] = (long long)smem;
  return 0;
}
