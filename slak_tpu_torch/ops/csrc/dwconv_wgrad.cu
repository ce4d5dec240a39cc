// Weight gradient of the same-padded stride-1 depthwise conv, NCHW:
//   dw[c,i,j] = sum_{n,h,w} dy[n,c,h,w] * x[n,c,h+i-kh/2,w+j-kw/2]
// (x zero outside the map), fp32 accumulation, fp32 (C, kh, kw) result.
//
// Replaces slak_tpu/ops/pallas_banded.py: wgrad_banded_cmajor
// (_wgrad_kernel) + band_extract, and wgrad_banded2d_cmajor
// (_wgrad2d_kernel) + band_extract2d on the 7x7 maps. The TPU kernels form
// the per-channel correlation matrices dA (C, s, H, H) or (C, HW, HW) on
// the MXU and fold their diagonals into taps afterwards.
//
// Two kernels serve it, chosen by dtype and shape (ops/dwconv_wgrad.py
// wgrad_route).
//
// Band route (slak_dwconv_wgrad_band: bf16, taps (K, 5) or (5, K), both
// map axes at most 64, all four SLaK stages at 224^2): wgrad_band_kernel,
// the TPU kernels' decomposition laid out for the tensor cores (mma.sync
// m16n8k16, bf16 in, fp32 sums). With L the long tap axis of the map (H
// for (K, 5), W for (5, K)) and F the other, for each shift j < 5 of the
// short axis one per-channel correlation matrix over L,
//   G_j[a][r] = sum_{n, f} dy_n[f][a] x_n[f + j - 2][r],
// and the taps are its diagonals, dw[i][j] = sum_a G_j[a][a + i - K/2]
// (rows i with |i - K/2| >= L see only padding: their diagonals are empty
// and the taps exactly 0). Both operands are staged k-major, a row per
// (image, f) with L contiguous ((K, 5) transposes each plane in 8 x 8
// blocks with movmatrix; (5, K) stages it as it lies), each image's F rows
// (to 8) followed by 2 zero rows, so the shift j is an ldmatrix row offset
// of x's operand and both fragments come from ldmatrix.trans: dy's A
// fragment (a on M, 16-row m-tiles) is loaded once a k-step and serves
// the five shifted B fragments of x (r on N, 8-wide n-tiles). Tiles of G
// that lie wholly off the band (|r - a| > K/2) are skipped. mma.sync and
// not wgmma: a one-row shift inside an 8-row core matrix has no wgmma
// descriptor, wgmma's M = 64 would waste most rows at L = 14 and 7, and
// TMA needs 16-byte strides (rows here are 14 to 112 bytes).
//
// A block takes one channel and a run of images in chunks of NB (as many
// as the lanes' staging registers take), double-buffered with one barrier
// a chunk (the staging of dwconv.cu's band kernel: 8 x 8 blocks, 4-byte
// loads and stores). Its warps split the units (shift j, n-tile); at
// stage 1's MT = 4 m-tiles 16 warps in two m-groups split the m-tiles too
// (one warp holding all four m-tiles' accumulators spills), and on the
// small maps (MT = 1) four k-groups split the chunk's k-steps, each with
// its own accumulators. After the last chunk the accumulators go to
// shared memory, the k-groups' copies are summed in order and each thread
// sums one tap's diagonal in order, one partial a block; wgrad_reduce
// sums the partials in order. No atomics. The settings per MT were chosen
// by in-call A/B on an H100 (tools/probe_wgrad.py --ablate keeps the
// alternatives); copying the chunks with cp.async into a ring of raw
// buffers, staged from there, measured no faster.
//
// Tiled route (fp32, other taps, larger maps): grid (C, batch chunks). A
// block owns one channel and a contiguous chunk of the batch; for each
// sample it stages the input plane (zero-padded along the taps' short
// axis) and the dy plane as fp32 in shared memory, and accumulates the
// taps directly.
//
// wgrad_tiled_kernel (taps (K, 5) or (5, K)): thread u owns tap row i =
// u % K along the long axis and all 5 taps across it, for the output rows
// a = u / K, u / K + P, ... (P = 256 / K row groups): per output row it
// slides a 5-wide register window along the short axis, one dy load and
// one new x load for 5 FMAs. Rows whose input row lies outside the map are
// skipped, so taps that only ever read padding stay exactly zero. The
// (5, K) orientation stages both planes transposed and runs the same loop.
// A plane whose two fp32 copies exceed the shared memory (an fp32 map
// above about 158^2, detection's 200^2 stage 1) is staged in tiles of
// a.rows output rows along the long axis (with the K - 1 input rows
// around them that lie on the map); each thread still visits its output
// rows in increasing order, so the sums, and their bits, are those of
// the whole-plane staging.
// wgrad_kernel (any other odd taps, e.g. a merged K x K): a thread a tap
// and a row group. It stages row tiles the same way: a plane whose two
// fp32 copies exceed the shared memory (51x51 taps above about 155^2, 7x7
// above about 159^2) is staged in tiles of a.rows output rows with the
// kh - 1 input rows around them that lie on the map, each thread visiting
// its rows in increasing order, so the sums are those of the whole plane;
// a plane that fits is one tile.
//
// The reduction over the batch is deterministic: each block reduces its
// row groups in a fixed order in shared memory and writes one partial
// (chunk, C, kh, kw); a second launch (wgrad_reduce) sums the chunks in
// order. No atomics.
//
// What bounds it on an H100: the bytes (x and dy read once). The band
// route's products (as many as the forward's, plus the band tiles'
// padding) run on the tensor cores well below their rate; what is left is
// the staging, the fragment loads and the per-block fold. The tiled
// route's FMAs run on the CUDA cores (67 TFLOP/s fp32), with two
// shared-memory loads a 5-FMA step.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

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
  int rows;              // wgrad_tiled_kernel: output rows a staged tile
};

// Taps (K, 5) (LONG_H) or (5, K). HA: the map's extent along the taps'
// long axis, HB across it; R = a.rows output rows a tile; shared: xs
// [min(HA, R + K - 1)][XP] (XP odd, 2 zero columns each side), ds
// [R][HB], red [P][K][5].
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
  const int R = a.rows;
  const int XR = min(HA, R + K - 1);
  float* xs = smem;
  float* ds = xs + XR * XP;
  float* red = ds + R * HB;

  const int c = blockIdx.x, chunk = blockIdx.y;
  const long long n0 = (long long)chunk * a.per_chunk;
  const long long n1 = min(a.N, n0 + a.per_chunk);
  const long long plane = (long long)a.H * a.W;
  const int u = threadIdx.x;
  const int ti = u % K, grp = u / K;
  const bool active = grp < P;
  const int pk = K / 2;

  // zero the halo columns once; the staging loop rewrites the rest
  for (int i = u; i < XR * XP; i += kThreads) xs[i] = 0.f;
  float acc[S];
#pragma unroll
  for (int j = 0; j < S; ++j) acc[j] = 0.f;

  for (long long n = n0; n < n1; ++n) {
    const T* xp = x + (n * a.C + c) * plane;
    const T* dp = dy + (n * a.C + c) * plane;
   for (int r0 = 0; r0 < HA; r0 += R) {
    // output rows [r0, r1) and the input rows [x0, x1) they read
    const int r1 = min(HA, r0 + R);
    const int x0 = max(0, r0 - pk), x1 = min(HA, r1 + pk);
    __syncthreads();                    // the previous tile is consumed
    if (R >= HA) {                      // the whole plane, in plane order
      for (int i = u; i < a.H * a.W; i += kThreads) {
        const int h = i / a.W, w = i - h * a.W;
        const int ra = LONG_H ? h : w, rb = LONG_H ? w : h;
        xs[ra * XP + rb + HALO] = to_f<T>(xp[i]);
        ds[ra * HB + rb] = to_f<T>(dp[i]);
      }
    } else if (LONG_H) {                // rows [x0, x1) and [r0, r1)
      for (int i = u; i < (x1 - x0) * HB; i += kThreads) {
        const int lr = i / HB, b = i - lr * HB;
        xs[lr * XP + b + HALO] = to_f<T>(xp[(long long)(x0 + lr) * a.W + b]);
      }
      for (int i = u; i < (r1 - r0) * HB; i += kThreads) {
        const int lr = i / HB, b = i - lr * HB;
        ds[lr * HB + b] = to_f<T>(dp[(long long)(r0 + lr) * a.W + b]);
      }
    } else {                            // columns, read along each row
      const int nx = x1 - x0, nd = r1 - r0;
      for (int i = u; i < nx * HB; i += kThreads) {
        const int b = i / nx, lr = i - b * nx;
        xs[lr * XP + b + HALO] = to_f<T>(xp[(long long)b * a.W + x0 + lr]);
      }
      for (int i = u; i < nd * HB; i += kThreads) {
        const int b = i / nd, lr = i - b * nd;
        ds[lr * HB + b] = to_f<T>(dp[(long long)b * a.W + r0 + lr]);
      }
    }
    __syncthreads();
    if (active) {
      // this thread's first row of the tile: grp, grp + P, ... as before
      int ra = grp;
      if (ra < r0) ra += (r0 - ra + P - 1) / P * P;
      for (; ra < r1; ra += P) {
        const int r = ra + ti - pk;
        if (r < 0 || r >= HA) continue;
        const float* xr = xs + (r - x0) * XP;
        const float* dr = ds + (ra - r0) * HB;
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
// + P, ...; R = a.rows output rows a tile; shared: xs [min(H, R + kh -
// 1)][W], ds [R][W], red [P * ntaps].
template <typename T>
__global__ void __launch_bounds__(kThreads)
wgrad_kernel(const T* __restrict__ x, const T* __restrict__ dy,
             float* __restrict__ part, WArgs a) {
  extern __shared__ float smem[];
  const int H = a.H, W = a.W, kh = a.kh, kw = a.kw;
  const int ntaps = kh * kw;
  const int P = ntaps >= kThreads ? 1 : kThreads / ntaps;
  const int R = a.rows, ph = kh / 2;
  float* xs = smem;
  float* ds = xs + min(H, R + kh - 1) * W;
  float* red = ds + R * W;
  const int c = blockIdx.x, chunk = blockIdx.y;
  const long long n0 = (long long)chunk * a.per_chunk;
  const long long n1 = min(a.N, n0 + a.per_chunk);
  const long long plane = (long long)H * W;

  for (int v = threadIdx.x; v < P * ntaps; v += kThreads) red[v] = 0.f;
  for (long long n = n0; n < n1; ++n) {
    const T* xp = x + (n * a.C + c) * plane;
    const T* dp = dy + (n * a.C + c) * plane;
   for (int r0 = 0; r0 < H; r0 += R) {
    // output rows [r0, r1) and the input rows [x0, x1) they read
    const int r1 = min(H, r0 + R);
    const int x0 = max(0, r0 - ph), x1 = min(H, r1 + ph);
    __syncthreads();                    // the previous tile is consumed
    if (R >= H) {                       // the whole plane
      for (int i = threadIdx.x; i < H * W; i += kThreads) {
        xs[i] = to_f<T>(xp[i]);
        ds[i] = to_f<T>(dp[i]);
      }
    } else {
      const T* xt = xp + (long long)x0 * W;
      const T* dt = dp + (long long)r0 * W;
      for (int i = threadIdx.x; i < (x1 - x0) * W; i += kThreads)
        xs[i] = to_f<T>(xt[i]);
      for (int i = threadIdx.x; i < (r1 - r0) * W; i += kThreads)
        ds[i] = to_f<T>(dt[i]);
    }
    __syncthreads();
    for (int v = threadIdx.x; v < P * ntaps; v += kThreads) {
      const int tap = v % ntaps, grp = v / ntaps;
      const int ti = tap / kw, tj = tap - ti * kw;
      float s = red[v];
      // this thread's first row of the tile: grp, grp + P, ... as before
      int h = grp;
      if (h < r0) h += (r0 - h + P - 1) / P * P;
      for (; h < r1; h += P) {
        const int r = h + ti - ph;
        if (r < 0 || r >= H) continue;
        const float* dr = ds + (h - r0) * W;
        const float* xr = xs + (r - x0) * W;
        for (int w = 0; w < W; ++w) {
          const int cc = w + tj - kw / 2;
          if (cc >= 0 && cc < W) s = fmaf(dr[w], xr[cc], s);
        }
      }
      red[v] = s;
    }
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

// The shared memory of a launch whose tiles hold `rows` output rows:
// wgrad_tiled_kernel's (variant 1, 2) or wgrad_kernel's (variant 0)
size_t tile_smem(int variant, int H, int W, int kh, int kw, int rows) {
  if (variant == 0) {
    const int ntaps = kh * kw;
    const int P = ntaps >= kThreads ? 1 : kThreads / ntaps;
    const int XR = H < rows + kh - 1 ? H : rows + kh - 1;
    return sizeof(float) * ((size_t)XR * W + (size_t)rows * W +
                            (size_t)P * ntaps);
  }
  const bool long_h = variant == 1;
  const int K = long_h ? kh : kw;
  const int HA = long_h ? H : W, HB = long_h ? W : H;
  const int XP = (HB + kShort - 1) | 1;
  const int XR = HA < rows + K - 1 ? HA : rows + K - 1;
  return sizeof(float) * ((size_t)XR * XP + (size_t)rows * HB +
                          (size_t)(kThreads / K) * K * kShort);
}

// The shared memory of a launch and the output rows a tile: the whole
// extent along the rows the tiles cut (H, or W for (5, K)) where both
// planes fit, else the most that fit; rows = 0 and kSmemMax + 1 where not
// one row does
size_t smem_bytes(int variant, int H, int W, int kh, int kw, int* rows) {
  *rows = 0;
  const int HA = variant == 2 ? W : H;
  const auto bytes = [&](int r) {
    return tile_smem(variant, H, W, kh, kw, r);
  };
  int r = HA;
  while (r > 1 && bytes(r) > kSmemMax) r = (r + 1) / 2;
  if (bytes(r) > kSmemMax) return kSmemMax + 1;
  // the largest tile that fits, once halving found one
  while (r < HA && bytes(r + 1) <= kSmemMax) ++r;
  *rows = r;
  return bytes(r);
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
  const size_t smem = smem_bytes(variant, a.H, a.W, a.kh, a.kw, &a.rows);
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

// ---------------------------------------------------------------------------
// The band route (see the header).

using bf16 = __nv_bfloat16;

constexpr int kBandMax = 64;         // either map axis: at most 4 m-tiles
                                     // (ops/dwconv_wgrad.py routes by it)
constexpr int kSMs = 132;            // an H100's SMs: the waves the block
                                     // count is chosen for
constexpr int kBlockCost = 2;        // a block's set-up and fold, in chunks
constexpr int kMaxBpc = 16;          // blocks a channel at most
constexpr size_t kBandSmemMax = 200 * 1024;

// Per m-tile count MT: the m-groups (warps that split the m-tiles; 16
// warps at MT = 4, where one warp holding all four m-tiles' accumulators
// spills), the k-groups (warps that split a chunk's k-steps, each with its
// own copy of the accumulators), the unit slots a warp holds (a unit: one
// shift j and one n-tile of 8 along L, the warp's m-tiles), the 8 x 8
// staging blocks a lane holds, and the blocks an SM the registers are
// held to.
__host__ __device__ constexpr int wb_mgroups(int MT) {
  return MT == 4 ? 2 : 1;
}
__host__ __device__ constexpr int wb_warps(int MT) {
  return 8 * wb_mgroups(MT);
}
__host__ __device__ constexpr int wb_kgroups(int MT) {
  return MT == 1 ? 4 : 1;
}
__host__ __device__ constexpr int wb_slots(int MT) {
  return MT == 2 ? 3 : MT == 3 ? 4 : 5;
}
__host__ __device__ constexpr int wb_pre(int MT) {
  return MT == 1 ? 8 : 16;
}
__host__ __device__ constexpr int wb_min_blocks(int MT) {
  return MT == 1 ? 4 : MT == 2 ? 3 : MT == 3 ? 2 : 1;
}

struct WBandGeom {
  int N, C, H, W, K, long_h;
  int L, F, NT;        // the long tap axis of the map, the other axis,
                       // n-tiles of 8 along L
  int RPI, P;          // staged rows an image (F to 8, + 2 zero rows),
                       // staged row pitch (16 MT + 8)
  int BW, BPI, HW;     // 8 x 8 blocks of a plane: across W, in all; plane
  int NB, CPB;         // images a chunk, chunks a block
  int buf, GP;         // elements of one staged operand; the fold's row
                       // pitch (floats)
};

__device__ __forceinline__ void ldsm_x4_t(unsigned* r, const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x2_t(unsigned* r, const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
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

// A chunk's 8 x 8 blocks, the x planes' first (b < NB * BPI), then dy's:
// blk[b] = (its offset in the chunk's planes, its offset in a staged
// buffer (dy's operand after x's), the rows of the map it holds << 16 |
// its columns, its image | 1 << 16 for dy).
template <int NW>
__device__ __forceinline__ void wb_blocks(const WBandGeom& g, int4* blk) {
  const int half = g.NB * g.BPI;
  for (int b = threadIdx.x; b < 2 * half; b += 32 * NW) {
    const int p = b >= half, rem = b - p * half;
    const int img = rem / g.BPI, bi = rem - img * g.BPI;
    const int bh = bi / g.BW, bw = bi - bh * g.BW;
    const int row = g.long_h ? bw : bh, col = g.long_h ? bh : bw;
    blk[b] = make_int4(img * g.C * g.HW + bh * 8 * g.W + bw * 8,
                       p * g.buf + (img * g.RPI + 2 + row * 8) * g.P +
                           col * 8,
                       (g.H - bh * 8) << 16 | (g.W - bw * 8),
                       img | p << 16);
  }
}

// The chunk's x and dy planes (images n .. n + nimg - 1 of channel c)
// into registers, a block at a time: the lane's two values at (row
// lane / 4, columns 2 (lane % 4) and + 1) of the block, one 4-byte load
// where W is even (PAIR), else two 2-byte loads; zero outside the map and
// for the chunk's images past nimg (the last chunk's), so the staged
// operands hold zeros there.
template <int NW, int PRE, bool PAIR>
__device__ __forceinline__ void wb_load(const WBandGeom& g, const int4* blk,
                                        const bf16* x, const bf16* dy,
                                        int n, int nimg, int c,
                                        unsigned* pre) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lr = lane >> 2, lc = 2 * (lane & 3);
  const int nblk = 2 * g.NB * g.BPI;
  const long long off = ((long long)n * g.C + c) * g.HW + lr * g.W + lc;
  const unsigned short* xb =
      reinterpret_cast<const unsigned short*>(x) + off;
  const unsigned short* db =
      reinterpret_cast<const unsigned short*>(dy) + off;
#pragma unroll
  for (int i = 0; i < PRE; ++i) {
    const int b = warp + i * NW;
    if (b >= nblk) break;
    const int4 e = blk[b];
    const int rows = e.z >> 16, cols = e.z & 0xffff;
    unsigned v = 0u;
    if ((e.w & 0xffff) < nimg && lr < rows && lc < cols) {
      const unsigned short* p = (e.w >> 16 ? db : xb) + e.x;
      if (PAIR)
        v = *reinterpret_cast<const unsigned*>(p);
      else
        v = p[0] | (lc + 1 < cols ? (unsigned)p[1] << 16 : 0u);
    }
    pre[i] = v;
  }
}

// The registers into a staged buffer: value (h, w) of image img at row
// img * RPI + 2 + w, column h for (K, 5) (each block transposed in
// registers with movmatrix), at row img * RPI + 2 + h, column w for
// (5, K); 4-byte stores.
template <int NW, int PRE>
__device__ __forceinline__ void wb_stage(const WBandGeom& g, const int4* blk,
                                         bf16* bs, const unsigned* pre) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nblk = 2 * g.NB * g.BPI;
  bf16* base = bs + (lane >> 2) * g.P + 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < PRE; ++i) {
    const int b = warp + i * NW;
    if (b >= nblk) break;
    *reinterpret_cast<unsigned*>(base + blk[b].y) =
        g.long_h ? movt(pre[i]) : pre[i];
  }
}

// W a multiple of 8 (16-byte rows of 8 x 8 blocks): the chunk's planes
// into registers four blocks at a time, lane l one 16-byte row (l % 8)
// of block 4 q + l / 8 of the warp's quad q (a warp's load: 8 rows of 64
// contiguous bytes where the four blocks lie side by side); zero outside
// the map and for the images past nimg.
template <int NW, int NQ>
__device__ __forceinline__ void wb_load16(const WBandGeom& g,
                                          const int4* blk, const bf16* x,
                                          const bf16* dy, int n, int nimg,
                                          int c, uint4* pre) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane & 7, nblk = 2 * g.NB * g.BPI;
  const long long off = ((long long)n * g.C + c) * g.HW + r * g.W;
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    const int b0 = 4 * (warp + i * NW), b = b0 + (lane >> 3);
    if (b0 >= nblk) break;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (b < nblk) {
      const int4 e = blk[b];
      if ((e.w & 0xffff) < nimg && r < (e.z >> 16))
        v = *reinterpret_cast<const uint4*>((e.w >> 16 ? dy : x) + off +
                                            e.x);
    }
    pre[i] = v;
  }
}

// The 16-byte rows into a staged buffer: (5, K) stores each row as it
// lies; (K, 5) writes the quad's four blocks to the warp's 512-byte
// scratch and reads them back transposed with one ldmatrix.x4.trans, then
// stores as wb_stage does.
template <int NW, int NQ>
__device__ __forceinline__ void wb_stage16(const WBandGeom& g,
                                           const int4* blk, bf16* bs,
                                           const uint4* pre,
                                           uint4* scratch) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nblk = 2 * g.NB * g.BPI;
  bf16* base = bs + (lane >> 2) * g.P + 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    const int b0 = 4 * (warp + i * NW);
    if (b0 >= nblk) break;
    if (!g.long_h) {
      const int b = b0 + (lane >> 3);
      if (b < nblk)
        *reinterpret_cast<uint4*>(bs + blk[b].y + (lane & 7) * g.P) = pre[i];
      continue;
    }
    scratch[lane] = pre[i];
    __syncwarp();
    unsigned t[4];
    ldsm_x4_t(t, reinterpret_cast<const bf16*>(scratch + lane));
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (b0 + k < nblk)
        *reinterpret_cast<unsigned*>(base + blk[b0 + k].y) = t[k];
  }
}

// The products of one staged chunk, nsteps k-steps of 16 staged rows,
// k-step s taken by k-group s % KG: the A fragments of dy's rows 2 + 16 s
// .. (the warp's m-tiles, loaded once) and the B fragments of the warp's
// units, x's rows shifted by the unit's j (boff), all issued before the
// products, into the tiles on the band (live: bit u * MW + m for the
// warp's m-tile m).
template <int MT>
__device__ __forceinline__ void wb_products(
    const WBandGeom& g, const bf16* bs, int nsteps, int kg, int mg,
    const int* boff, unsigned live,
    float (&acc)[wb_slots(MT)][MT / wb_mgroups(MT)][4]) {
  constexpr int SL = wb_slots(MT), KG = wb_kgroups(MT);
  constexpr int MW = MT / wb_mgroups(MT);
  const int lane = threadIdx.x & 31;
  const bf16* xs = bs;
  const bf16* ds = bs + g.buf +
                   (2 + (lane & 7) + (lane >> 4) * 8) * g.P +
                   ((lane >> 3) & 1) * 8 + 16 * MW * mg;
  for (int s = kg; s < nsteps; s += KG) {
    const int r0 = 16 * s * g.P;
    unsigned a[MW][4], b[SL][2];
#pragma unroll
    for (int m = 0; m < MW; ++m) ldsm_x4_t(a[m], ds + r0 + 16 * m);
#pragma unroll
    for (int u = 0; u < SL; ++u)
      if ((live >> (u * MW)) & ((1u << MW) - 1u))
        ldsm_x2_t(b[u], xs + r0 + boff[u]);
#pragma unroll
    for (int u = 0; u < SL; ++u)
#pragma unroll
      for (int m = 0; m < MW; ++m)
        if ((live >> (u * MW + m)) & 1u)
          mma_bf16(acc[u][m], a[m], b[u][0], b[u][1]);
  }
}

// Grid (C * blocks a channel): block grp of channel c takes chunks of NB
// images from image grp * CPB * NB, double-buffered (while chunk q's
// products run, chunk q + 1, loaded into registers during chunk q - 1,
// is written to the other staged buffer and chunk q + 2 is loaded; one
// barrier a chunk), then folds its tiles into one partial of the taps.
// LD: the loads, 16-byte rows (8: W a multiple of 8), value pairs (2: W
// even) or single values (1).
template <int MT, int LD>
__global__ void __launch_bounds__(32 * wb_warps(MT), wb_min_blocks(MT))
wgrad_band_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                  float* __restrict__ part, WBandGeom g) {
  extern __shared__ __align__(16) unsigned char wb_smem[];
  constexpr int NW = wb_warps(MT), NTH = 32 * NW, MG = wb_mgroups(MT);
  constexpr int MW = MT / MG, SL = wb_slots(MT), KG = wb_kgroups(MT);
  constexpr int UW = NW / (KG * MG), PRE = wb_pre(MT);
  static_assert(UW * SL >= kShort * 2 * MT, "a unit group misses units");
  bf16* bsb[2] = {reinterpret_cast<bf16*>(wb_smem),
                  reinterpret_cast<bf16*>(wb_smem) + 2 * g.buf};
  const int c = blockIdx.x % g.C, grp = blockIdx.x / g.C;
  const int n_begin = grp * g.CPB * g.NB;
  const int n_end = min(g.N, n_begin + g.CPB * g.NB);
  const int nq = (n_end - n_begin + g.NB - 1) / g.NB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // warp = (k-group, m-group, unit group)
  const int kg = warp / (MG * UW), mg = warp / UW % MG, ug = warp % UW;
  const int pk = g.K / 2;

  __shared__ int4 blk[PRE * NW];
  wb_blocks<NW>(g, blk);
  // the warp's units u = ug + UW * slot: shift j = u / NT, n-tile
  // nt = u % NT; a tile (mt, nt) is live where some (a, r) in it has
  // |r - a| <= K / 2
  int boff[SL];
  unsigned live = 0u;
#pragma unroll
  for (int sl = 0; sl < SL; ++sl) {
    const int u = ug + UW * sl, j = u / g.NT, nt = u - j * g.NT;
    boff[sl] = (j + (lane & 15)) * g.P + 8 * nt;
#pragma unroll
    for (int m = 0; m < MW; ++m) {
      const int mt = MW * mg + m;
      const int gap = max(0, max(8 * nt - (16 * mt + 15),
                                 16 * mt - (8 * nt + 7)));
      if (u < kShort * g.NT && gap <= pk) live |= 1u << (sl * MW + m);
    }
  }
  float acc[SL][MW][4];
#pragma unroll
  for (int sl = 0; sl < SL; ++sl)
#pragma unroll
    for (int m = 0; m < MW; ++m)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[sl][m][i] = 0.f;

  // the staging registers and the loads and stores of a chunk
  constexpr int NP = LD == 8 ? PRE / 4 : PRE;
  typename std::conditional<LD == 8, uint4, unsigned>::type pre[NP];
  __shared__ uint4 scratch[LD == 8 ? 32 * NW : 1];
  const auto load = [&](int n, int nimg) {
    if constexpr (LD == 8)
      wb_load16<NW, NP>(g, blk, x, dy, n, nimg, c, pre);
    else
      wb_load<NW, PRE, LD == 2>(g, blk, x, dy, n, nimg, c, pre);
  };
  const auto stage = [&](bf16* bs) {
    if constexpr (LD == 8)
      wb_stage16<NW, NP>(g, blk, bs, pre, scratch + 32 * warp);
    else
      wb_stage<NW, PRE>(g, blk, bs, pre);
  };
  __syncthreads();
  load(n_begin, min(g.NB, n_end - n_begin));
  // both staged buffers zeroed once: their halo rows and the padding
  // beyond L are never written and stay zero
  for (int i = threadIdx.x; i < 4 * g.buf / 8; i += NTH)
    reinterpret_cast<uint4*>(wb_smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  stage(bsb[0]);
  if (nq > 1) load(n_begin + g.NB, min(g.NB, n_end - n_begin - g.NB));
  __syncthreads();
  for (int qi = 0; qi < nq; ++qi) {
    const int n = n_begin + qi * g.NB, nimg = min(g.NB, n_end - n);
    if (qi + 1 < nq) {
      stage(bsb[(qi + 1) & 1]);
      if (qi + 2 < nq) load(n + 2 * g.NB, min(g.NB, n_end - n - 2 * g.NB));
    }
    wb_products<MT>(g, bsb[qi & 1], (nimg * g.RPI - 2 + 15) / 16, kg, mg,
                    boff, live, acc);
    __syncthreads();
  }

  // the fold: each k-group's live tiles to G[kg][j][a][r] (over the
  // staged buffers); the k-groups' copies summed in order into G[0]; then
  // thread t sums the diagonal of tap (i, j) = (t % K, t / K) in order
  float* G = reinterpret_cast<float*>(wb_smem);
  constexpr int MR = 16 * MT;
#pragma unroll
  for (int sl = 0; sl < SL; ++sl) {
    const int u = ug + UW * sl, j = u / g.NT, nt = u - j * g.NT;
#pragma unroll
    for (int m = 0; m < MW; ++m) {
      if (!((live >> (sl * MW + m)) & 1u)) continue;
      float* t = G + ((kg * kShort + j) * MR + 16 * (MW * mg + m) +
                      (lane >> 2)) * g.GP + 8 * nt + 2 * (lane & 3);
      *reinterpret_cast<float2*>(t) =
          make_float2(acc[sl][m][0], acc[sl][m][1]);
      *reinterpret_cast<float2*>(t + 8 * g.GP) =
          make_float2(acc[sl][m][2], acc[sl][m][3]);
    }
  }
  __syncthreads();
  if (KG > 1) {
    const int copy = kShort * MR * g.GP;
    for (int e = threadIdx.x; e < copy; e += NTH) {
      float s = G[e];
#pragma unroll
      for (int q = 1; q < KG; ++q) s += G[q * copy + e];
      G[e] = s;
    }
    __syncthreads();
  }
  float* dst = part + ((long long)grp * g.C + c) * kShort * g.K;
  for (int t = threadIdx.x; t < kShort * g.K; t += NTH) {
    const int j = t / g.K, i = t - j * g.K;
    const int a0 = max(0, pk - i), a1 = min(g.L, g.L + pk - i);
    const float* d = G + j * MR * g.GP + i - pk;
    float s = 0.f;
    for (int a = a0; a < a1; ++a) s += d[a * (g.GP + 1)];
    dst[g.long_h ? i * kShort + j : j * g.K + i] = s;
  }
}

int round_up(int a, int m) { return (a + m - 1) / m * m; }

// The band route's geometry: false when the shapes do not fit it. MT =
// m-tiles of the long axis, LD = the loads (8: 16-byte rows, W a multiple
// of 8 and the pointers 16-byte aligned; 2: 4-byte pairs, W even and the
// pointers 4-byte aligned; else 1), bpc = blocks a channel (the partials
// a channel).
bool wband_geom(long long N, int C, int H, int W, int kh, int kw,
                const void* x, const void* dy, WBandGeom* gp, int* MT,
                int* LD, int* bpc, size_t* smem_out) {
  const int variant = variant_of(kh, kw);
  if (variant == 0 || N < 1 || N > (1LL << 30) || C < 1) return false;
  WBandGeom g{};
  g.N = (int)N; g.C = C; g.H = H; g.W = W;
  g.long_h = variant == 1;
  g.K = g.long_h ? kh : kw;
  g.L = g.long_h ? H : W;
  g.F = g.long_h ? W : H;
  if (g.L < 1 || g.L > kBandMax || g.F < 1 || g.F > kBandMax) return false;
  const int mt = (g.L + 15) / 16;
  g.NT = (g.L + 7) / 8;
  g.RPI = round_up(g.F, 8) + 2;
  g.P = 16 * mt + 8;
  g.BW = (W + 7) / 8;
  g.BPI = (H + 7) / 8 * g.BW;
  g.HW = H * W;
  // as many images as the lanes' staging registers take (both planes)
  int nb = wb_pre(mt) * wb_warps(mt) / (2 * g.BPI);
  if (nb > g.N) nb = g.N;
  if (nb < 1 || (long long)nb * C * g.HW > (1LL << 30)) return false;
  g.NB = nb;
  const int steps = (nb * g.RPI - 2 + 15) / 16;
  g.buf = (16 * steps + 4) * g.P;
  g.GP = 8 * g.NT + 4;
  // blocks a channel: the fewest waves of kSMs * wb_min_blocks blocks for
  // the chunks, each block costing its chunks and kBlockCost more
  const int chunks = (g.N + nb - 1) / nb;
  const long long slots = (long long)kSMs * wb_min_blocks(mt);
  long long best = -1;
  for (int b = 1; b <= kMaxBpc && b <= chunks; ++b) {
    const int cpb = (chunks + b - 1) / b;
    const int used = (chunks + cpb - 1) / cpb;
    if (used != b) continue;
    const long long cost =
        ((long long)C * b + slots - 1) / slots * (cpb + kBlockCost);
    if (best < 0 || cost < best) {
      best = cost;
      g.CPB = cpb;
    }
  }
  const size_t stage = 4 * (size_t)g.buf * sizeof(bf16);
  const size_t fold = sizeof(float) * (size_t)wb_kgroups(mt) * kShort * 16 *
                      mt * g.GP;
  const size_t smem = stage > fold ? stage : fold;
  if (smem > kBandSmemMax) return false;
  *gp = g;
  *MT = mt;
  const uintptr_t ptrs = (uintptr_t)x | (uintptr_t)dy;
  *LD = W % 8 == 0 && ptrs % 16 == 0 ? 8 : W % 2 == 0 && ptrs % 4 == 0 ? 2
                                                                   : 1;
  *bpc = (chunks + g.CPB - 1) / g.CPB;
  *smem_out = smem;
  return true;
}

template <int MT, int LD>
cudaError_t launch_wband_t(const WBandGeom& g, int bpc, size_t smem,
                           const void* x, const void* dy, float* part,
                           cudaStream_t stream) {
  auto kernel = wgrad_band_kernel<MT, LD>;
  // once an instantiation, whatever smem is: the static tables count
  // against the 48 KB a launch may take without it
  static bool raised = false;
  if (!raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kBandSmemMax);
    if (e != cudaSuccess) return e;
    raised = true;
  }
  kernel<<<(unsigned)(g.C * bpc), 32 * wb_warps(MT), smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy), part, g);
  return cudaGetLastError();
}

template <int LD>
cudaError_t launch_wband_l(int MT, const WBandGeom& g, int bpc, size_t smem,
                           const void* x, const void* dy, float* part,
                           cudaStream_t stream) {
  switch (MT) {
    case 1: return launch_wband_t<1, LD>(g, bpc, smem, x, dy, part, stream);
    case 2: return launch_wband_t<2, LD>(g, bpc, smem, x, dy, part, stream);
    case 3: return launch_wband_t<3, LD>(g, bpc, smem, x, dy, part, stream);
    case 4: return launch_wband_t<4, LD>(g, bpc, smem, x, dy, part, stream);
  }
  return cudaErrorInvalidValue;
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
  WArgs a{N, C, H, W, kh, kw, (int)((N + n_chunks - 1) / n_chunks), 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, dy, part, dw, a, n_chunks, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, dy, part, dw, a, n_chunks, s);
  return (int)cudaErrorInvalidValue;
}

// The tiled route's tile plan: the output rows a staged tile holds (along
// H, or W for (5, K) taps; the whole extent where both fp32 planes fit)
// and *smem its shared memory; 0 where not one row fits, and the launch is
// refused with cudaErrorInvalidConfiguration.
extern "C" int slak_dwconv_wgrad_tile_rows(int H, int W, int kh, int kw,
                                           long long* smem) {
  int rows;
  *smem = (long long)smem_bytes(variant_of(kh, kw), H, W, kh, kw, &rows);
  return rows;
}

// The float32 scratch the band route needs for these shapes: one partial
// of the (kh, kw) taps a channel and block, bpc * C * kh * kw, or 0 where
// one block takes a channel's whole batch and writes dw itself; -1 when
// the band route does not take them.
extern "C" long long slak_dwconv_wgrad_band_scratch(long long N, int C,
                                                    int H, int W, int kh,
                                                    int kw) {
  WBandGeom g;
  int MT, LD, bpc;
  size_t smem;
  if (!wband_geom(N, C, H, W, kh, kw, nullptr, nullptr, &g, &MT, &LD, &bpc,
                  &smem))
    return -1;
  return bpc == 1 ? 0 : (long long)bpc * C * kh * kw;
}

// The band route (bf16 only): dw as slak_dwconv_wgrad for taps (K, 5) or
// (5, K), both map axes at most 64. part: slak_dwconv_wgrad_band_scratch
// floats (unused where that is 0). Two launches, one where a block takes a
// channel's whole batch; cudaErrorInvalidValue for shapes it does not
// take.
extern "C" int slak_dwconv_wgrad_band(const void* x, const void* dy,
                                      float* part, float* dw, long long N,
                                      int C, int H, int W, int kh, int kw,
                                      void* stream) {
  WBandGeom g;
  int MT, LD, bpc;
  size_t smem;
  if (!wband_geom(N, C, H, W, kh, kw, x, dy, &g, &MT, &LD, &bpc, &smem))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = bpc == 1 ? dw : part;
  const cudaError_t e =
      LD == 8 ? launch_wband_l<8>(MT, g, bpc, smem, x, dy, dst, s)
      : LD == 2 ? launch_wband_l<2>(MT, g, bpc, smem, x, dy, dst, s)
                : launch_wband_l<1>(MT, g, bpc, smem, x, dy, dst, s);
  if (e != cudaSuccess || bpc == 1) return (int)e;
  const long long n = (long long)C * kh * kw;
  wgrad_reduce<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(part, dw, n, bpc);
  return (int)cudaGetLastError();
}
