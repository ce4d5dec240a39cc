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
// What bounds it on an H100: the FMAs on the CUDA cores, (K * S) per output
// and branch at most (67 TFLOP/s fp32), and the shared-memory loads that
// feed them; the bytes (x once, xq once in the dual-in modes, y or y1 + y2
// once) take far less at SLaK's kernel sizes.

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
