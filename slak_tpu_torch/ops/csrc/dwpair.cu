// The decomposed large-kernel pair in one pass over x: (K, S) taps + (S, K)
// taps, stride 1, zero "same" padding, NCHW, fp32 accumulation.
//
// Replaces slak_tpu/ops/pallas_banded.py: dwpair_fused_cmajor and its four
// kernels (_pair_kernel, _pair_kernel_dualin, _pair_kernel_dualout,
// _pair_kernel_dualin_dualout), the TPU's fused LoRA1 + LoRA2 call that
// reads x once for both branches. The TPU kernels build both halos in VMEM
// and run each branch as banded matrix products; here, as in dwconv.cu
// (K1), the taps run directly on a tile of x staged in shared memory, and
// tap rows or columns that would only read padding are skipped.
//
// The four TPU modes are a 2 x 2 choice, kept as two flags:
//   dual_in:  branch 2 reads xq, x with H and W swapped ((N, C, W, H)
//             contiguous), with the transposed (K, S) taps; else it reads x
//             with the (S, K) taps;
//   raw:      branch 2's result is written to y2 in the q orientation
//             ((N, C, W, H)) and branch 1's to y1 (the dual-out modes with
//             sum_out=False); else y = y1 + y2 in one output.
// Rounding follows _pair_body: each branch is summed in fp32 and rounded to
// the compute dtype, and the sum is taken in the compute dtype:
// y = T(T(acc1) + T(acc2)).
//
// Blocks: one block covers G consecutive (n, c) planes (G > 1 on small
// maps) and a tile of TH output rows; at SLaK's 224^2 shapes a whole plane
// fits (TH = H). Larger maps take row tiles; the staged rows carry a K/2
// halo above and below for branch 1 and an S/2 halo for branch 2, and the
// dual-in tile holds every q row (the whole width) for the tile's columns,
// so a tile needs no neighbour's data. The shared tile of x is padded by
// S/2 columns on each side, and by S/2 rows beyond the map (branch 2's
// column segments). Branch 2 runs first; in the summed mode its rounded
// result waits in shared memory (fp32, TH x W a plane) until branch 1 adds
// it on the store, so the output is written once.
//
// Threads: RB = 8 outputs a thread across the short axis of the taps (K1's
// register blocking): branch 1 a row segment (h, w .. w+7), branch 2 on x
// a column segment (h .. h+7, w), branch 2 on xq a row segment of the q
// plane (w, h .. h+7), which is again contiguous in y2's q orientation.
// Per step of the long axis a thread loads RB + S - 1 inputs and S taps
// for S * RB FMAs.
//
// What bounds dwpair_kernel on an H100: the FMAs on the CUDA cores, (K * S)
// per output and branch at most (67 TFLOP/s fp32), and the shared-memory
// loads that feed them; the bytes (x once, xq once in the dual-in modes, y
// or y1 + y2 once) take far less at SLaK's kernel sizes. It serves fp32,
// the summed modes and the shapes the band route does not take.
//
// Band route (slak_dwpair_band: bf16, dualboth, raw, taps (K, 5) / (5, K)
// with K > 5, square maps of side at most 64 -- the dual eval stage's
// launch at all four SLaK-T stages): dwpair_band_kernel, both branches as
// per-channel banded products on the tensor cores (mma.sync m16n8k16, bf16
// in, fp32 sums), dwconv.cu's dwconv_band_kernel (K1) in the form the
// dual streams allow. For each tap j < 5 of the short axis,
//   C[m][(n, f)] += sum_k A_j[m][k] X_n[f + j - 2][k],
//   A_j[m][k] = t(k - m + K/2, j) (zero off the band),
// with X_n a plane whose long tap axis (k) is contiguous, and C's rows m
// along the long axis, its columns f contiguous in the output:
//   branch 1, (K, 5) taps t(i, j) = w1[i][j]: X = xq (X[w][h]), C = y1
//             (y1[h][w]);
//   branch 2, (5, K) taps t(i, j) = w2[j][i]: X = x (X[h][w]), C = y2q
//             (y2q[w][h]).
// Each branch finds its operand already in the orientation the product
// wants and stores its accumulators as they lie: K1 transposes once in
// each orientation (movmatrix while staging for (K, 5), before the store
// for (5, K)), this kernel nowhere -- the TPU's "zero in-kernel shuffles"
// of dualboth. Each output is one rounding of its fp32 sum, as in
// _pair_body's raw pair.
//
// The grid is twice K1's band grid: blocks [0, C * bpc) take branch 1,
// the rest branch 2; a block takes one channel and a run of images, builds
// that channel's 5 (2 MT - 1) Toeplitz tiles once (MT = ceil(side / 16)
// m-tiles), and walks its images in chunks, double-buffered with one
// barrier a chunk, as K1's band kernel does. A warp stages a plane in 8 x 8
// blocks as it lies (a lane two neighbouring values: one 4-byte load where
// the side is even, two 2-byte loads where it is odd) between two zero halo
// rows an image, and the shift j - 2 is an ldmatrix row offset. The
// accumulators go out two values along f a store (4 bytes where the side is
// even). Taps arrive rounded to bf16 (ops/dwpair.py), so the band is exact.
//
// What bounds dwpair_band_kernel on an H100: the bytes (xq and x read once,
// y1 and y2q written once); the products run far below the tensor cores'
// rate. What is left is latency: the staging, the fragment loads and the
// per-block band build, at 16 (32 on the small maps) warps an SM.

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
constexpr int RB = 8;
constexpr size_t kSmemMax = 96 * 1024;

struct PairGeom {
  long long planes;
  int C, H, W, K;
  int G, TH, n_row_tiles;
  int nbh, nbw;                 // RB blocks of a row tile / of a row
  int rows_x, pitch_x;          // x tile of one plane
  int pitch_q;                  // xq tile of one plane (W rows)
  int dual_in, raw;
  int plane_floats;             // shared floats a plane
};

// The rows of x a row tile [h0, h0 + TH) stages: [lo, hi).
__host__ __device__ inline void staged_rows(int h0, int TH, int H, int K,
                                            int S, int nbh, int* lo,
                                            int* hi) {
  const int pk = K / 2, ps = S / 2;
  const int h1 = h0 + TH < H ? h0 + TH : H;
  const int a = h0 - pk > 0 ? h0 - pk : 0;          // branch 1 (clipped)
  const int b = h1 + pk < H ? h1 + pk : H;
  *lo = a < h0 - ps ? a : h0 - ps;                  // branch 2 (padded)
  *hi = b > h0 + nbh * RB + ps ? b : h0 + nbh * RB + ps;
}

template <typename T, int S>
__global__ void __launch_bounds__(kThreads)
dwpair_kernel(const T* __restrict__ x, const T* __restrict__ xq,
              const float* __restrict__ w1, const float* __restrict__ w2,
              T* __restrict__ y, T* __restrict__ y2q, PairGeom g) {
  extern __shared__ float smem[];
  constexpr int ps = S / 2;
  const int H = g.H, W = g.W, K = g.K, pk = K / 2;
  const int ntaps = K * S;
  const long long p0 = (long long)(blockIdx.x / g.n_row_tiles) * g.G;
  const int h0 = (blockIdx.x % g.n_row_tiles) * g.TH;
  const int h1 = min(H, h0 + g.TH);
  const long long plane = (long long)H * W;
  int r_lo, r_hi;
  staged_rows(h0, g.TH, H, K, S, g.nbh, &r_lo, &r_hi);
  const int nr = r_hi - r_lo;
  const int qcols = g.nbh * RB + 2 * ps;            // xq tile columns used

  // per plane: taps1 [K][S] | taps2 [S][K] | x tile | xq tile | y2 tile
  const int off_x = 2 * ntaps;
  const int off_q = off_x + g.rows_x * g.pitch_x;
  const int off_y2 = off_q + (g.dual_in ? W * g.pitch_q : 0);
  for (int pg = 0; pg < g.G; ++pg) {
    const long long p = p0 + pg;
    float* base = smem + pg * g.plane_floats;
    const int c = (int)(p % g.C);
    for (int i = threadIdx.x; i < 2 * ntaps; i += kThreads)
      base[i] = p < g.planes ? (i < ntaps ? w1[(long long)c * ntaps + i]
                                          : w2[(long long)c * ntaps + i -
                                               ntaps])
                             : 0.f;
    float* xs = base + off_x;
    for (int i = threadIdx.x; i < nr * g.pitch_x; i += kThreads) {
      const int r = i / g.pitch_x, col = i - r * g.pitch_x;
      const int hr = r_lo + r, wc = col - ps;
      float v = 0.f;
      if (p < g.planes && hr >= 0 && hr < H && wc >= 0 && wc < W)
        v = to_f<T>(x[p * plane + (long long)hr * W + wc]);
      xs[i] = v;
    }
    if (g.dual_in) {
      float* qs = base + off_q;
      for (int i = threadIdx.x; i < W * qcols; i += kThreads) {
        const int wr = i / qcols, col = i - wr * qcols;
        const int hc = h0 - ps + col;
        float v = 0.f;
        if (p < g.planes && hc >= 0 && hc < H)
          v = to_f<T>(xq[p * plane + (long long)wr * H + hc]);
        qs[wr * g.pitch_q + col] = v;
      }
    }
  }
  __syncthreads();

  // branch 2: (S, K) taps on x, or the transposed taps on xq
  const int items2 = g.nbh * W;
  for (int i = threadIdx.x; i < g.G * items2; i += kThreads) {
    const int pg = i / items2, rem = i - pg * items2;
    const long long p = p0 + pg;
    if (p >= g.planes) continue;
    const float* base = smem + pg * g.plane_floats;
    const float* t2 = base + ntaps;                 // [S][K]
    const int hb = rem / W, ww = rem - hb * W;
    float acc[RB];
#pragma unroll
    for (int q = 0; q < RB; ++q) acc[q] = 0.f;
    const int j_lo = max(0, pk - ww), j_hi = min(K, W + pk - ww);
    if (!g.dual_in) {
      // column segment (h0 + hb*RB + q, ww): rows h - ps .. h + ps
      const float* xb = base + off_x +
                        (h0 + hb * RB - ps - r_lo) * g.pitch_x + ps + ww - pk;
      for (int tj = j_lo; tj < j_hi; ++tj) {
        const float* xc = xb + tj;
        float xv[RB + S - 1], tv[S];
#pragma unroll
        for (int k = 0; k < RB + S - 1; ++k) xv[k] = xc[k * g.pitch_x];
#pragma unroll
        for (int j = 0; j < S; ++j) tv[j] = t2[j * K + tj];
#pragma unroll
        for (int q = 0; q < RB; ++q)
#pragma unroll
          for (int j = 0; j < S; ++j) acc[q] = fmaf(tv[j], xv[q + j], acc[q]);
      }
    } else {
      // row segment of the q plane (ww, h0 + hb*RB + q): q rows ww - pk ..
      // ww + pk, transposed taps t2T[i][j] = t2[j][i]
      const float* xb = base + off_q + (ww - pk) * g.pitch_q + hb * RB;
      for (int ti = j_lo; ti < j_hi; ++ti) {
        const float* xr = xb + ti * g.pitch_q;
        float xv[RB + S - 1], tv[S];
#pragma unroll
        for (int k = 0; k < RB + S - 1; ++k) xv[k] = xr[k];
#pragma unroll
        for (int j = 0; j < S; ++j) tv[j] = t2[j * K + ti];
#pragma unroll
        for (int q = 0; q < RB; ++q)
#pragma unroll
          for (int j = 0; j < S; ++j) acc[q] = fmaf(tv[j], xv[q + j], acc[q]);
      }
    }
    const int hq = h0 + hb * RB;
    if (g.raw) {
      T* o = y2q + p * plane + (long long)ww * H + hq;
#pragma unroll
      for (int q = 0; q < RB; ++q)
        if (hq + q < h1) o[q] = from_f<T>(acc[q]);
    } else {
      float* y2s = const_cast<float*>(base) + off_y2;
#pragma unroll
      for (int q = 0; q < RB; ++q)
        if (hq + q < h1)
          y2s[(hq + q - h0) * W + ww] = to_f<T>(from_f<T>(acc[q]));
    }
  }
  if (!g.raw) __syncthreads();

  // branch 1: (K, S) taps on x, row segments (hh, wb*RB + q)
  const int items1 = (h1 - h0) * g.nbw;
  for (int i = threadIdx.x; i < g.G * items1; i += kThreads) {
    const int pg = i / items1, rem = i - pg * items1;
    const long long p = p0 + pg;
    if (p >= g.planes) continue;
    const float* base = smem + pg * g.plane_floats;
    const float* t1 = base;                         // [K][S]
    const int hh = h0 + rem / g.nbw, wb = rem % g.nbw;
    float acc[RB];
#pragma unroll
    for (int q = 0; q < RB; ++q) acc[q] = 0.f;
    const int i_lo = max(0, pk - hh), i_hi = min(K, H + pk - hh);
    const float* xb = base + off_x + (hh - pk - r_lo) * g.pitch_x + wb * RB;
    for (int ti = i_lo; ti < i_hi; ++ti) {
      const float* xr = xb + ti * g.pitch_x;
      float xv[RB + S - 1], tv[S];
#pragma unroll
      for (int k = 0; k < RB + S - 1; ++k) xv[k] = xr[k];
#pragma unroll
      for (int j = 0; j < S; ++j) tv[j] = t1[ti * S + j];
#pragma unroll
      for (int q = 0; q < RB; ++q)
#pragma unroll
        for (int j = 0; j < S; ++j) acc[q] = fmaf(tv[j], xv[q + j], acc[q]);
    }
    const int w0 = wb * RB;
    T* o = y + p * plane + (long long)hh * W + w0;
    const float* y2s = base + off_y2 + (hh - h0) * W + w0;
#pragma unroll
    for (int q = 0; q < RB; ++q) {
      if (w0 + q >= W) break;
      o[q] = g.raw ? from_f<T>(acc[q])
                   : from_f<T>(to_f<T>(from_f<T>(acc[q])) + y2s[q]);
    }
  }
}

int plane_floats(const PairGeom& g, int S) {
  return 2 * g.K * S + g.rows_x * g.pitch_x +
         (g.dual_in ? g.W * g.pitch_q : 0) + (g.raw ? 0 : g.TH * g.W);
}

// The launch geometry: planes a block (G), output rows a block (TH).
// Returns false when no tile fits kSmemMax.
bool make_geom(long long N, int C, int H, int W, int K, int S, int dual_in,
               int raw, PairGeom* gp, size_t* smem_out) {
  PairGeom g{};
  g.planes = N * C;
  g.C = C; g.H = H; g.W = W; g.K = K;
  g.dual_in = dual_in; g.raw = raw;
  g.nbw = (W + RB - 1) / RB;
  g.pitch_x = (g.nbw * RB + S - 1) | 1;
  g.TH = H;
  g.G = 1;
  bool first = true;
  for (;;) {
    g.nbh = (g.TH + RB - 1) / RB;
    g.n_row_tiles = (H + g.TH - 1) / g.TH;
    g.rows_x = 0;
    for (int t = 0; t < g.n_row_tiles; ++t) {
      int lo, hi;
      staged_rows(t * g.TH, g.TH, H, K, S, g.nbh, &lo, &hi);
      if (hi - lo > g.rows_x) g.rows_x = hi - lo;
    }
    g.pitch_q = (g.nbh * RB + S - 1) | 1;
    if (first) {                  // several planes a block on small maps
      const int items = g.nbh * W > H * g.nbw ? g.nbh * W : H * g.nbw;
      g.G = items >= 2 * kThreads ? 1 : 2 * kThreads / items;
      first = false;
    }
    g.plane_floats = plane_floats(g, S);
    const size_t smem = sizeof(float) * (size_t)g.G * g.plane_floats;
    if (smem <= kSmemMax) {
      *gp = g;
      *smem_out = smem;
      return true;
    }
    if (g.G > 1) g.G = (g.G + 1) / 2;
    else if (g.TH > 1) g.TH = (g.TH + 1) / 2;
    else return false;
  }
}

template <typename T, int S>
cudaError_t launch(const void* x, const void* xq, const float* w1,
                   const float* w2, void* y, void* y2q, long long N, int C,
                   int H, int W, int K, int dual_in, int raw,
                   cudaStream_t stream) {
  PairGeom g;
  size_t smem;
  if (!make_geom(N, C, H, W, K, S, dual_in, raw, &g, &smem))
    return cudaErrorInvalidConfiguration;
  static bool raised = false;                       // once an instantiation
  if (smem > 48 * 1024 && !raised) {
    cudaError_t e = cudaFuncSetAttribute(
        dwpair_kernel<T, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmemMax);
    if (e != cudaSuccess) return e;
    raised = true;
  }
  const long long blocks = (g.planes + g.G - 1) / g.G * g.n_row_tiles;
  dwpair_kernel<T, S><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(xq), w1, w2,
      static_cast<T*>(y), static_cast<T*>(y2q), g);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_s(int S, const void* x, const void* xq, const float* w1,
                     const float* w2, void* y, void* y2q, long long N, int C,
                     int H, int W, int K, int dual_in, int raw,
                     cudaStream_t stream) {
  switch (S) {
    case 3: return launch<T, 3>(x, xq, w1, w2, y, y2q, N, C, H, W, K,
                                dual_in, raw, stream);
    case 5: return launch<T, 5>(x, xq, w1, w2, y, y2q, N, C, H, W, K,
                                dual_in, raw, stream);
    case 7: return launch<T, 7>(x, xq, w1, w2, y, y2q, N, C, H, W, K,
                                dual_in, raw, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The band route (see the header).

using bf16 = __nv_bfloat16;

constexpr int kWarps = kThreads / 32;
constexpr int kBandShort = 5;          // the short side of the taps
constexpr int kBandMax = 64;           // the map's side: at most 4 tiles
                                       // (ops/dwpair.py routes by BAND_MAX)
constexpr int kBandPitch = 24;         // a band tile's row pitch (16 + 8)
constexpr int kBandTile = 16 * kBandPitch;
constexpr size_t kBandSmemMax = 200 * 1024;

struct PairBandGeom {
  int N, C, S, K;      // images, channels, the map's side (H = W), long taps
  int NTI, RPI, P;     // n-tiles an image (S to 8), staged rows an image
                       // (S to 8, + 4 halo rows), staged row pitch (S to
                       // 16, + 8)
  int BW, BPI;         // 8 x 8 blocks of a plane: across a row, in all
  int HW, NB, CPB;     // plane; images a chunk; chunks a block
  int bpc;             // blocks a channel and branch
  int b_off, b_bytes;  // shared memory: the band tiles at 0, then the two
                       // staged buffers (b_bytes each)
};

// Per m-tile count MT: the n-tiles of 8 a warp takes, the 8 x 8 blocks a
// warp stages a chunk (its registers a lane), and the blocks an SM the
// registers are held to: K1's band kernel's settings, which an in-call A/B
// on the H100 kept (tools/probe_pair_band.py --ablate, PERF.md: no other
// setting faster beyond noise at every stage).
__host__ __device__ constexpr int pair_wn(int MT) {
  return MT <= 2 ? 4 : 2;
}
__host__ __device__ constexpr int pair_pre(int MT) {
  return MT == 1 ? 8 : 16;
}
__host__ __device__ constexpr int pair_min_blocks(int MT) {
  return MT == 1 ? 4 : 2;
}

__device__ __forceinline__ void ldsm_x4(unsigned* r, const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
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

// A chunk's 8 x 8 blocks: block b = warp + 8 i of the lane's loads and
// stores, image b / BPI; blk[b] = (its offset in the chunk's planes, its
// offset in a staged buffer, the rows and columns of the plane it holds).
// Both branches' operands are S x S planes staged as they lie.
__device__ __forceinline__ void pair_blocks(const PairBandGeom& g,
                                            int4* blk) {
  for (int b = threadIdx.x; b < g.NB * g.BPI; b += kThreads) {
    const int img = b / g.BPI, rem = b - img * g.BPI;
    const int bh = rem / g.BW, bw = rem - bh * g.BW;
    blk[b] = make_int4(img * g.C * g.HW + bh * 8 * g.S + bw * 8,
                       (img * g.RPI + 2 + bh * 8) * g.P + bw * 8,
                       g.S - bh * 8, g.S - bw * 8);
  }
}

// The chunk's planes of src (nimg images from image n, channel c) into
// registers, a block at a time: the lane's two values at (row lane / 4,
// columns 2 (lane % 4) and + 1) of the block, one 4-byte load where the
// side is even (PAIR), else two 2-byte loads; zero outside the plane.
template <int PRE, bool PAIR>
__device__ __forceinline__ void pair_load(const PairBandGeom& g,
                                          const int4* blk, const bf16* src,
                                          int n, int nimg, int c,
                                          unsigned* pre) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lr = lane >> 2, lc = 2 * (lane & 3);
  const int nblk = nimg * g.BPI;
  const unsigned short* base = reinterpret_cast<const unsigned short*>(
      src + ((long long)n * g.C + c) * g.HW) + lr * g.S + lc;
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

// The registers into a staged buffer as they lie: image img's plane row f
// at row img * RPI + 2 + f, 4-byte stores; the blocks' zero values outside
// the plane fill the padding.
template <int PRE>
__device__ __forceinline__ void pair_stage(const PairBandGeom& g,
                                           const int4* blk, bf16* bs,
                                           int nimg, const unsigned* pre) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nblk = nimg * g.BPI;
  bf16* base = bs + (lane >> 2) * g.P + 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < PRE; ++i) {
    const int b = warp + i * kWarps;
    if (b >= nblk) break;
    *reinterpret_cast<unsigned*>(base + blk[b].y) = pre[i];
  }
}

// Two outputs at (r, cc) and (r, cc + 1) of an output plane (row m along
// the long axis, column f), each rounded once, stored where inside it.
template <bool PAIR>
__device__ __forceinline__ void pair_put(const PairBandGeom& g, bf16* dst,
                                         long long plane, int r, int cc,
                                         float v0, float v1) {
  if (r >= g.S || cc >= g.S) return;
  bf16* o = dst + plane + r * g.S + cc;
  const bf16 y0 = __float2bfloat16(v0), y1 = __float2bfloat16(v1);
  if (PAIR) {
    *reinterpret_cast<unsigned*>(o) =
        (unsigned)__bfloat16_as_ushort(y0) |
        ((unsigned)__bfloat16_as_ushort(y1) << 16);
  } else {
    o[0] = y0;
    if (cc + 1 < g.S) o[1] = y1;
  }
}

// The products of a chunk of T n-tiles (images n ..) and their stores:
// warp tile wt = n-tiles [wt * WN, wt * WN + WN), all MT m-tiles. For each
// tap j: the B fragments of the warp's n-tiles at every k-tile (rows
// shifted by j), then each band tile D_j[d] on the band once, into every
// (m-tile, k-tile = m-tile + d). The accumulators are the output tile
// (row m, columns f), stored as they lie.
template <int MT, bool PAIR>
__device__ __forceinline__ void pair_products(const PairBandGeom& g,
                                              const bf16* band,
                                              const bf16* bs, bf16* dst,
                                              int n, int c, int T) {
  constexpr int WN = pair_wn(MT), ND = 2 * MT - 1;
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
#pragma unroll
    for (int j = 0; j < kBandShort; ++j) {
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
    // half hf of (mt, nn)
#pragma unroll
    for (int nn = 0; nn < WN; ++nn) {
      const int nt = wt * WN + nn;
      if (nt >= T) break;
      const int img = nt / g.NTI, f0 = (nt - img * g.NTI) * 8;
      const long long plane = ((long long)(n + img) * g.C + c) * g.HW;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          pair_put<PAIR>(g, dst, plane, mt * 16 + 8 * hf + gid,
                         f0 + 2 * tig, acc[mt][nn][2 * hf],
                         acc[mt][nn][2 * hf + 1]);
    }
  }
}

template <int MT, bool PAIR>
__global__ void __launch_bounds__(kThreads, pair_min_blocks(MT))
dwpair_band_kernel(const bf16* __restrict__ x, const bf16* __restrict__ xq,
                   const float* __restrict__ w1,
                   const float* __restrict__ w2, bf16* __restrict__ y1,
                   bf16* __restrict__ y2q, PairBandGeom g) {
  extern __shared__ __align__(16) unsigned char band_smem[];
  constexpr int ND = 2 * MT - 1, PRE = pair_pre(MT);
  bf16* band = reinterpret_cast<bf16*>(band_smem);
  bf16* bsb[2] = {reinterpret_cast<bf16*>(band_smem + g.b_off),
                  reinterpret_cast<bf16*>(band_smem + g.b_off + g.b_bytes)};
  // branch 1: (K, 5) taps on xq into y1; branch 2: (5, K) taps on x into y2q
  const int per = g.C * g.bpc;
  const int branch = blockIdx.x >= per;
  const int rem = blockIdx.x - branch * per;
  const int c = rem % g.C, grp = rem / g.C;
  const bf16* src = branch ? x : xq;
  bf16* dst = branch ? y2q : y1;
  const int n_begin = grp * g.CPB * g.NB;
  const int n_end = min(g.N, n_begin + g.CPB * g.NB);
  const int nq = (n_end - n_begin + g.NB - 1) / g.NB;
  const int pk = g.K / 2;

  __shared__ int4 blk[PRE * kWarps];
  pair_blocks(g, blk);
  __syncthreads();
  unsigned pre[PRE];
  pair_load<PRE, PAIR>(g, blk, src, n_begin, min(g.NB, n_end - n_begin), c,
                       pre);
  // both staged buffers zeroed once (their halo rows and padding stay
  // zero), and the channel's band tiles D_j[d], d = -(MT-1) .. MT-1, 8
  // values a store (tiles off the band are never read, nor built)
  for (int i = threadIdx.x; i < 2 * g.b_bytes / 16; i += kThreads)
    reinterpret_cast<uint4*>(bsb[0])[i] = make_uint4(0u, 0u, 0u, 0u);
  const float* wc = (branch ? w2 : w1) + (long long)c * g.K * kBandShort;
  for (int i = threadIdx.x; i < kBandShort * ND * 32; i += kThreads) {
    const int jd = i >> 5, r = (i >> 1) & 15, c0 = (i & 1) * 8;
    const int j = jd / ND, d = jd - j * ND - (MT - 1);
    if (16 * (d < 0 ? -d : d) - 15 > pk) continue;
    unsigned v[4];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int k = 16 * d + c0 + e - r + pk;
      float t = 0.f;
      if (k >= 0 && k < g.K)
        t = branch ? wc[j * g.K + k] : wc[k * kBandShort + j];
      const unsigned h = __bfloat16_as_ushort(__float2bfloat16(t));
      v[e >> 1] = e & 1 ? v[e >> 1] | h << 16 : h;
    }
    *reinterpret_cast<uint4*>(band + jd * kBandTile + r * kBandPitch + c0) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
  __syncthreads();
  pair_stage<PRE>(g, blk, bsb[0], min(g.NB, n_end - n_begin), pre);
  if (nq > 1)
    pair_load<PRE, PAIR>(g, blk, src, n_begin + g.NB,
                         min(g.NB, n_end - n_begin - g.NB), c, pre);
  __syncthreads();

  // chunk qi: stage chunk qi + 1 into the other buffer and start loading
  // chunk qi + 2, then chunk qi's products and stores; one barrier
  for (int qi = 0; qi < nq; ++qi) {
    const int n = n_begin + qi * g.NB, nimg = min(g.NB, n_end - n);
    if (qi + 1 < nq) {
      pair_stage<PRE>(g, blk, bsb[(qi + 1) & 1],
                      min(g.NB, n_end - n - g.NB), pre);
      if (qi + 2 < nq)
        pair_load<PRE, PAIR>(g, blk, src, n + 2 * g.NB,
                             min(g.NB, n_end - n - 2 * g.NB), c, pre);
    }
    pair_products<MT, PAIR>(g, band, bsb[qi & 1], dst, n, c,
                            nimg * g.NTI);
    __syncthreads();
  }
}

int round_up(int a, int m) { return (a + m - 1) / m * m; }

// The band route's geometry: false when the shapes do not fit it (see
// slak_dwpair_band_ok). MT = m-tiles of the side.
bool pair_band_geom(long long N, int C, int H, int W, int K, int S,
                    PairBandGeom* gp, int* MT, size_t* smem_out) {
  if (S != kBandShort || K <= S || K % 2 == 0 || H != W) return false;
  if (N < 1 || N > (1LL << 30) || C < 1 || H < 1 || H > kBandMax)
    return false;
  PairBandGeom g{};
  g.N = (int)N; g.C = C; g.S = H; g.K = K;
  const int mt = (H + 15) / 16;
  const int Fn = round_up(H, 8);
  g.NTI = Fn / 8;
  g.RPI = Fn + 4;
  g.P = 16 * mt + 8;
  g.BW = (H + 7) / 8;
  g.BPI = g.BW * g.BW;
  g.HW = H * H;
  // as many images as the 8 warps' tiles take in one round, and as their
  // 8 x 8 blocks take in pair_pre registers a lane
  const int pre = pair_pre(mt) * kWarps;
  int nb = 8 * pair_wn(mt) / g.NTI;
  if (nb > pre / g.BPI) nb = pre / g.BPI;
  if (nb > g.N) nb = g.N;
  g.NB = nb < 1 ? 1 : nb;
  if (g.NB * g.BPI > pre) return false;
  // about 1024 blocks a branch: channels times runs of chunks
  const int chunks = (g.N + g.NB - 1) / g.NB;
  int per = (1024 + C - 1) / C;
  if (per > chunks) per = chunks;
  g.CPB = (chunks + per - 1) / per;
  g.bpc = (chunks + g.CPB - 1) / g.CPB;
  g.b_off = kBandShort * (2 * mt - 1) * kBandTile * 2;
  g.b_bytes = round_up(g.NB * g.RPI * g.P * 2, 16);
  const size_t smem = (size_t)g.b_off + 2 * (size_t)g.b_bytes;
  if (smem > kBandSmemMax) return false;
  *gp = g;
  *MT = mt;
  *smem_out = smem;
  return true;
}

template <int MT, bool PAIR>
cudaError_t launch_pair_band_t(const PairBandGeom& g, size_t smem,
                               const void* x, const void* xq,
                               const float* w1, const float* w2, void* y1,
                               void* y2q, cudaStream_t stream) {
  auto kernel = dwpair_band_kernel<MT, PAIR>;
  static bool raised = false;                 // once an instantiation
  if (smem > 48 * 1024 && !raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kBandSmemMax);
    if (e != cudaSuccess) return e;
    raised = true;
  }
  kernel<<<(unsigned)(2 * g.C * g.bpc), kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(xq), w1, w2,
      static_cast<bf16*>(y1), static_cast<bf16*>(y2q), g);
  return cudaGetLastError();
}

template <bool PAIR>
cudaError_t launch_pair_band_p(int MT, const PairBandGeom& g, size_t smem,
                               const void* x, const void* xq,
                               const float* w1, const float* w2, void* y1,
                               void* y2q, cudaStream_t stream) {
  switch (MT) {
    case 1: return launch_pair_band_t<1, PAIR>(g, smem, x, xq, w1, w2, y1,
                                               y2q, stream);
    case 2: return launch_pair_band_t<2, PAIR>(g, smem, x, xq, w1, w2, y1,
                                               y2q, stream);
    case 3: return launch_pair_band_t<3, PAIR>(g, smem, x, xq, w1, w2, y1,
                                               y2q, stream);
    case 4: return launch_pair_band_t<4, PAIR>(g, smem, x, xq, w1, w2, y1,
                                               y2q, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// 1 when slak_dwpair takes these shapes (S in {3, 5, 7}, K >= S, both odd,
// and a tile fits shared memory), else 0.
extern "C" int slak_dwpair_ok(long long N, int C, int H, int W, int K, int S,
                              int dual_in, int raw) {
  if (S != 3 && S != 5 && S != 7) return 0;
  if (K < S || K % 2 == 0) return 0;
  PairGeom g;
  size_t smem;
  return make_geom(N, C, H, W, K, S, dual_in, raw, &g, &smem) ? 1 : 0;
}

// dtype: 0 = float32, 1 = bfloat16. x: (N, C, H, W) contiguous; xq: (N, C,
// W, H), read when dual_in; w1: (C, K, S) and w2: (C, S, K) float32 taps.
// raw: y <- branch 1, y2q (N, C, W, H) <- branch 2; else y <- the rounded
// sum. Returns the cudaError_t of the launch.
extern "C" int slak_dwpair(int dtype, const void* x, const void* xq,
                           const float* w1, const float* w2, void* y,
                           void* y2q, long long N, int C, int H, int W, int K,
                           int S, int dual_in, int raw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K < S || K % 2 == 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch_s<float>(S, x, xq, w1, w2, y, y2q, N, C, H, W, K,
                                dual_in, raw, s);
  if (dtype == 1)
    return (int)launch_s<__nv_bfloat16>(S, x, xq, w1, w2, y, y2q, N, C, H,
                                        W, K, dual_in, raw, s);
  return (int)cudaErrorInvalidValue;
}

// 1 when slak_dwpair_band takes these shapes: taps (K, 5) / (5, K) with K
// > 5 odd (S = 5), a square map (H = W) of side at most 64, else 0.
extern "C" int slak_dwpair_band_ok(long long N, int C, int H, int W, int K,
                                   int S) {
  PairBandGeom g;
  int MT;
  size_t smem;
  return pair_band_geom(N, C, H, W, K, S, &g, &MT, &smem) ? 1 : 0;
}

// The band route's launch geometry into out[0..7]: MT, NTI, RPI, NB, CPB,
// bpc (blocks a channel and branch), blocks, shared bytes. Returns
// cudaErrorInvalidValue for shapes it does not take.
extern "C" int slak_dwpair_band_geom(long long N, int C, int H, int W,
                                     int K, int S, long long* out) {
  PairBandGeom g;
  int MT;
  size_t smem;
  if (!pair_band_geom(N, C, H, W, K, S, &g, &MT, &smem))
    return (int)cudaErrorInvalidValue;
  const long long v[8] = {MT, g.NTI, g.RPI, g.NB, g.CPB, g.bpc,
                          2LL * g.C * g.bpc, (long long)smem};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

// The band route (bf16, dualboth, raw): y1 <- conv(x, w1) with w1 (C, K, 5)
// read from xq, y2q (N, C, W, H) <- conv(x, w2) with w2 (C, 5, K) read from
// x, in the q orientation; x (N, C, H, W) and xq (N, C, W, H) contiguous,
// taps float32 rounded to bf16. Returns the cudaError_t of the launch,
// cudaErrorInvalidValue for shapes it does not take.
extern "C" int slak_dwpair_band(const void* x, const void* xq,
                                const float* w1, const float* w2, void* y1,
                                void* y2q, long long N, int C, int H, int W,
                                int K, int S, void* stream) {
  PairBandGeom g;
  int MT;
  size_t smem;
  if (!pair_band_geom(N, C, H, W, K, S, &g, &MT, &smem))
    return (int)cudaErrorInvalidValue;
  const bool pair = W % 2 == 0 &&
      (((uintptr_t)x | (uintptr_t)xq | (uintptr_t)y1 | (uintptr_t)y2q) & 3)
          == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(pair ? launch_pair_band_p<true>(MT, g, smem, x, xq, w1, w2,
                                               y1, y2q, s)
                    : launch_pair_band_p<false>(MT, g, smem, x, xq, w1, w2,
                                                y1, y2q, s));
}
