// Depthwise "same" convolution, stride 1, float32, taps (K, 5) or (5, K)
// with K != 5, NCHW: the float32 route of K1 (the forward and, on taps
// flipped on both axes, the input gradient), as per-channel banded
// products on the tensor cores in 3xTF32.
//
// Replaces slak_tpu/ops/pallas_banded.py: dwconv_banded_cmajor
// (_fwd_kernel) in float32, which runs each branch of the decomposed
// large-kernel pair as per-channel banded (H, H) matrix products at
// Precision.HIGHEST (exact fp32 products). dwconv.cu's band kernel does the
// same in bf16; this kernel carries the products to fp32.
//
// The product. With L the long tap axis of the map (H for (K, 5), W for
// (5, K)), F the other, pk = K / 2 and t(u, j) the tap at long index u and
// short index j, for each j < 5
//   C[f][m] += sum_k X[f + j - 2][k] T_j[k][m],  T_j[k][m] = t(k - m + pk, j)
// (zero off the taps), rows f (F, the images stacked on the small maps),
// columns m (L): C is the output tile. One mma.sync.m16n8k8 (TF32 in, fp32
// sums) takes a 16 x 8 tile of X as A and an 8 x 8 tile of T_j as B: x is
// A so that an n-tile is 8 outputs along L, whose band reaches 8 + K - 1
// inputs. The k-tiles of 8 start at k = 8 kt - s: with the shift s = pk
// mod 8 the band of an n-tile starts on a tile boundary and takes ceil((K
// + 7) / 8) of them, 8 at K = 51 (64 products an output for 51 taps; 9
// unshifted, 10 with taps as A on 16-row m-tiles). T_j is Toeplitz in 8 x 8
// tiles: tile (kt, nt) is D_j[kt - nt], and only ND diagonals e = kt - nt
// in [e_lo, e_lo + ND) are live (fewer where the map is shorter than the
// taps; the host takes the shift with the fewest).
//
// 3xTF32. fp32 taps are not exact in TF32, nor is x, so both operands are
// split, big = v rounded to TF32 (to nearest, ties away) and small = (v -
// big) rounded the same way, and each product is small A x big B + big A x
// small B + big A x big B (small x small, 2^-22 of the product, dropped):
// as accurate as fp32 FFMA; one TF32 pass is about 3e-4 off. The tensor
// cores truncate their fp32 sums (tf32_gemm.cuh measured the error growing
// with the products summed in one accumulator), so each tap j's 3 ND
// products of an output tile go into a fresh partial, added into the sums
// with fp32 adds.
//
// A block takes one channel and a tile of the map: rows (an F slice of one
// image, or NB whole images stacked along F with 2 zero rows between them,
// where F is small) and a run of n-tiles along L, in warp tiles of 2
// f-tiles of 16 rows x MW = 4 n-tiles of 8 (32 x 32 outputs, one warp
// each, at most 8 a block; MW = 1 or 2 where L has only as many n-tiles).
// It stages, with cp.async (4 bytes, zero-filled outside the map), the
// rows its outputs read (2 above, 2 below: the shift j is a row offset of
// the staged operand, so the accumulators stay the output tile) and the
// k-tiles its band reaches (its n-tiles' ND diagonals, not the whole map),
// in the map's own layout: (5, K) rows f with k contiguous (pitch = 4 mod
// 32 words), (K, 5) rows k with f contiguous (pitch = 8 mod 32): either
// way a fragment's 32 lanes (row lane / 4, column lane % 4) read 32 banks
// with plain 4-byte loads, and the staged copies are 4-byte, coalesced and
// conflict-free. x is split per fragment (two integer ops a plane). The
// taps' band, split into its two planes, is a table of 8 ND + 8 values a
// tap j and plane: lane (g, t) reads the B fragment of D_j[e] at 8 (e -
// e_lo) + t - g + 7 and + 4, and holds the ND fragments of the tap j in
// registers. Sums in a fixed order, no atomics: two launches give the same
// bits. In accumulate mode the tile is added to what `out` holds (one fp32
// add a value).
//
// K4 (slak_dwconv_band_f32_stats) is the same kernel with STATS set: it
// also replaces pallas_banded.py dwconv_banded_stats_cmajor
// (_fwd_stats_kernel) in float32, the conv plus the per-channel (sum y,
// sum y^2) of the stored y for the train-mode BN. Each thread adds the
// values it stores and their squares (rounded adds and products, no
// contraction into FMAs) in its store order; the rows between stacked
// images and past the map are never stored, so never summed. Then a
// butterfly over the warp's lanes, the warps' sums in order, one (s1, s2)
// partial a block; band_f32_stats_reduce sums a channel's partials in
// order, one block a channel (where a channel has one block, its partial
// is the channel's sums, written in place, and no reduce runs). No
// atomics: two launches give the same bits.
// The stats instantiations are template instances of their own, so every
// K1 instantiation keeps its code.
//
// What bounds it on an H100: the bytes (x read once, out written once, and
// read too in accumulate mode) against the 3xTF32 products (three TF32
// passes of the MACs the taps need, at 495 TFLOP/s): at the ERF's 1024^2
// stage maps the two are close. mma.sync is the legacy path to the tensor
// cores (wgmma is the full-rate one), but a one-row shift inside an 8-row
// core matrix has no wgmma descriptor, and wgmma's M = 64 rows would go
// mostly unused on the small maps. The time goes to the mma.sync
// instructions of the three passes first, then to the staging, which no
// other block hides at two blocks an SM (the registers: 128 a thread); the
// settings were chosen by in-call A/B on an H100 (tools/probe_band_f32.py
// --ablate keeps the alternatives). Persistent blocks that copy the next
// tile during a tile's products, and x split once in shared memory after
// the copies, measured no faster.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kShort = 5;
constexpr int kFW = 2;            // f-tiles of 16 rows a warp tile
constexpr int kRows = 16 * kFW;   // rows a warp tile
constexpr int kMaxWarps = 8;
constexpr int kNdMax = 9;         // ops/dwconv.py routes by F32_ND_MAX
constexpr size_t kSmemMax = 200 * 1024;

struct F32Geom {
  int N, C, H, W, K;
  int L, F, LT;        // the long tap axis of the map, the other, n-tiles
                       // of 8 along L
  int s, e_lo, LTs;    // the k-tiles' shift, the first live diagonal, the
                       // k-tiles of the map
  int MW;              // n-tiles of 8 along L a warp tile: 4, or LT below
  int WL, WF;          // warp tiles a block along L and along the rows
  int lblocks, fblocks, gblocks;   // blocks along L, along F, image groups
  int stack, NB, RPI;  // NB images stacked, RPI = F + 2 rows an image
  int BF;              // not stacked: rows of F a block
  int SR, KC, P;       // staged rows, k columns (at most), pitch (floats)
  int tab;             // the taps' table: floats a tap j and plane
  int x_off;           // floats before the staged tile
};

// v rounded to TF32 (to nearest, ties away from zero), its low 13 bits
// cleared: tf32_gemm.cuh's tf32_big in two integer ops
__device__ __forceinline__ uint32_t tf32_bits(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float v, uint32_t& big,
                                      uint32_t& small) {
  big = tf32_bits(v);
  small = tf32_bits(v - __uint_as_float(big));
}

// d += a (16 x 8, row) * b (8 x 8, col), TF32 in, fp32 sums
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int ND, int MW, bool LONG_H, bool STATS = false>
__global__ void __launch_bounds__(kMaxWarps * 32, 2)
dwconv_band_f32_kernel(const float* __restrict__ x,
                       const float* __restrict__ w, float* __restrict__ out,
                       F32Geom g, int accumulate, float* __restrict__ part,
                       float* __restrict__ s1s, float* __restrict__ s2s) {
  extern __shared__ __align__(16) float f32_smem[];
  constexpr int TAB = 8 * ND + 8;
  float* tab = f32_smem;                    // [j][big, small][TAB]
  float* xs = f32_smem + g.x_off;
  int b = blockIdx.x;
  const int lb = b % g.lblocks;
  b /= g.lblocks;
  const int fb = b % g.fblocks;
  b /= g.fblocks;
  const int gb = b % g.gblocks;
  const int c = b / g.gblocks;
  const int nthreads = blockDim.x;

  // the block's n-tiles [nt_lo, nt_hi) along L and the staged k-tiles:
  // k-tile kt holds k = 8 kt - s + [0, 8)
  const int nt_lo = lb * g.WL * MW;
  const int nt_hi = min(g.LT, nt_lo + g.WL * MW);
  const int kt_lo = max(0, nt_lo + g.e_lo);
  const int kt_hi = min(g.LTs, nt_hi + g.e_lo + ND - 1);
  const int kc = (kt_hi - kt_lo) * 8, k0 = kt_lo * 8 - g.s;
  // the block's rows: output row r is image n0 + r / RPI, f = r % RPI
  // (stacked), or image n0, f = f_lo + r
  int n0, nimg, f_lo, rows;
  if (g.stack) {
    n0 = gb * g.NB;
    nimg = min(g.NB, g.N - n0);
    f_lo = 0;
    rows = nimg * g.RPI - 2;
  } else {
    n0 = gb;
    nimg = 1;
    f_lo = fb * g.BF;
    rows = min(g.BF, g.F - f_lo);
  }
  const long long HW = (long long)g.H * g.W;

  // staged row s holds output-row coordinate r = s - 2: zero outside the
  // map, between stacked images and past the last image
  const int sr = g.SR, total = sr * kc;
  for (int i = threadIdx.x; i < total; i += nthreads) {
    int s, kk;
    if (LONG_H) {
      kk = i / sr;
      s = i - kk * sr;
    } else {
      s = i / kc;
      kk = i - s * kc;
    }
    const int r = s - 2;
    int img = 0, f = f_lo + r;
    if (g.stack) {
      img = r < 0 ? -1 : r / g.RPI;
      f = r - img * g.RPI;
    }
    const int k = k0 + kk;
    const bool ok = img >= 0 && img < nimg && f >= 0 && f < g.F && k >= 0 &&
                    k < g.L;
    const long long plane = ((long long)(n0 + img) * g.C + c) * HW;
    const float* src = ok ? x + plane + (LONG_H ? (long long)k * g.W + f
                                                : (long long)f * g.W + k)
                          : x;
    cp_async4(xs + (LONG_H ? kk * g.P + s : s * g.P + kk), src, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  // the taps' band: entry u of tap j is t(u + 8 e_lo - 7 + pk - s, j),
  // split
  const int t0 = 8 * g.e_lo - 7 + g.K / 2 - g.s;
  const float* wc = w + (long long)c * g.K * kShort;
  for (int i = threadIdx.x; i < kShort * TAB; i += nthreads) {
    const int j = i / TAB, u = i - j * TAB;
    const int ti = u + t0;
    float t = 0.f;
    if (ti >= 0 && ti < g.K) t = LONG_H ? wc[ti * kShort + j] : wc[j * g.K + ti];
    uint32_t big, small;
    split(t, big, small);
    tab[(2 * j) * TAB + u] = __uint_as_float(big);
    tab[(2 * j + 1) * TAB + u] = __uint_as_float(small);
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wf = warp / g.WL, wl = warp - wf * g.WL;
  const int nt0 = nt_lo + wl * MW, r0 = wf * kRows;
  // an idle warp of the stats variant stays for the block's reduction: it
  // forms no product (the guards below) and stores nothing (its rows are
  // past the block's, or its columns past the map)
  if (!STATS && (nt0 >= nt_hi || r0 >= rows)) return;
  // a fragment value (row s, column kk) of the staged operand
  const int sF = LONG_H ? 1 : g.P, sK = LONG_H ? g.P : 1;
  const float* xa = xs + (r0 + gid) * sF + tig * sK;
  const float* tb = tab + tig - gid + 7;

  float acc[kFW][MW][4];
#pragma unroll
  for (int ft = 0; ft < kFW; ++ft)
#pragma unroll
    for (int nt = 0; nt < MW; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[ft][nt][e] = 0.f;

#pragma unroll 1
  for (int j = 0; j < kShort; ++j) {
    uint32_t bb[ND][2], bs[ND][2];
    const float* tj = tb + 2 * j * TAB;
#pragma unroll
    for (int dd = 0; dd < ND; ++dd) {
      bb[dd][0] = __float_as_uint(tj[8 * dd]);
      bb[dd][1] = __float_as_uint(tj[8 * dd + 4]);
      bs[dd][0] = __float_as_uint(tj[TAB + 8 * dd]);
      bs[dd][1] = __float_as_uint(tj[TAB + 8 * dd + 4]);
    }
    float part[kFW][MW][4];
#pragma unroll
    for (int ft = 0; ft < kFW; ++ft)
#pragma unroll
      for (int nt = 0; nt < MW; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[ft][nt][e] = 0.f;
    const float* xj = xa + j * sF;
#pragma unroll
    for (int kk = 0; kk < MW + ND - 1; ++kk) {
      const int kt = nt0 + g.e_lo + kk;
      if (kt < kt_lo || kt >= kt_hi) continue;        // outside the map
      const float* xk = xj + (kt - kt_lo) * 8 * sK;
      uint32_t ab[kFW][4], as[kFW][4];
#pragma unroll
      for (int ft = 0; ft < kFW; ++ft) {
        const float* p = xk + ft * 16 * sF;
        split(p[0], ab[ft][0], as[ft][0]);
        split(p[8 * sF], ab[ft][1], as[ft][1]);
        split(p[4 * sK], ab[ft][2], as[ft][2]);
        split(p[8 * sF + 4 * sK], ab[ft][3], as[ft][3]);
      }
#pragma unroll
      for (int nt = 0; nt < MW; ++nt) {
        const int dd = kk - nt;                       // e - e_lo
        if (dd < 0 || dd >= ND || nt0 + nt >= nt_hi) continue;
#pragma unroll
        for (int ft = 0; ft < kFW; ++ft) {
          if (r0 + 16 * ft >= rows) continue;
          float* d = part[ft][nt];
          mma_tf32(d, as[ft], bb[dd][0], bb[dd][1]);
          mma_tf32(d, ab[ft], bs[dd][0], bs[dd][1]);
          mma_tf32(d, ab[ft], bb[dd][0], bb[dd][1]);
        }
      }
    }
#pragma unroll
    for (int ft = 0; ft < kFW; ++ft)
#pragma unroll
      for (int nt = 0; nt < MW; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[ft][nt][e] += part[ft][nt][e];
  }

  // the stores: value e of (ft, nt) at row r0 + 16 ft + gid (+ 8 for e >=
  // 2), column m = 8 (nt0 + nt) + 2 tig + (e & 1)
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int ft = 0; ft < kFW; ++ft)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = r0 + 16 * ft + 8 * hf + gid;
      if (r >= rows) continue;
      int img = 0, f = f_lo + r;
      if (g.stack) {
        img = r / g.RPI;
        f = r - img * g.RPI;
        if (f >= g.F) continue;                       // between images
      }
      float* o = out + ((long long)(n0 + img) * g.C + c) * HW;
#pragma unroll
      for (int nt = 0; nt < MW; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = 8 * (nt0 + nt) + 2 * tig + e;
          if (m >= g.L) continue;
          float* dst = o + (LONG_H ? (long long)m * g.W + f
                                   : (long long)f * g.W + m);
          const float v = acc[ft][nt][2 * hf + e];
          *dst = accumulate ? *dst + v : v;
          if (STATS) {
            s1 = __fadd_rn(s1, v);
            s2 = __fadd_rn(s2, __fmul_rn(v, v));
          }
        }
    }
  if constexpr (STATS) {
    __shared__ float red[2][kMaxWarps];
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      red[0][warp] = s1;
      red[1][warp] = s2;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float a = 0.f, q = 0.f;
      for (int i = 0; i < (int)(blockDim.x >> 5); ++i) {
        a += red[0][i];
        q += red[1][i];
      }
      if (g.gblocks * g.fblocks * g.lblocks == 1) {   // the channel's own
        s1s[c] = a;
        s2s[c] = q;
      } else {
        part[2LL * blockIdx.x] = a;
        part[2LL * blockIdx.x + 1] = q;
      }
    }
  }
}

// s1[c], s2[c] = the sums of channel c's bpc partials (blocks c bpc ..),
// in a fixed order: thread t the partials t, t + 256, .., then a butterfly
// over each warp's lanes and the warps' sums in order. One block a channel.
constexpr int kRedThreads = 256;

__global__ void __launch_bounds__(kRedThreads)
band_f32_stats_reduce(const float* __restrict__ part, float* __restrict__ s1,
                      float* __restrict__ s2, int bpc) {
  __shared__ float red[2][kRedThreads / 32];
  const int c = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* p = part + 2LL * c * bpc;
  float s = 0.f, q = 0.f;
  for (int i = threadIdx.x; i < bpc; i += kRedThreads) {
    s += p[2 * i];
    q += p[2 * i + 1];
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
    for (int i = 0; i < kRedThreads / 32; ++i) {
      a += red[0][i];
      b += red[1][i];
    }
    s1[c] = a;
    s2[c] = b;
  }
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

// the smallest v' >= v with v' = res (mod 32)
int pitch(int v, int res) { return v + ((res - v) % 32 + 32) % 32; }

// The launch geometry (ops/dwconv.py band_f32_geometry repeats it): false
// when the shapes do not fit the route.
bool f32_geom(long long N, int C, int H, int W, int kh, int kw, F32Geom* gp,
              int* ndiag, int* warps, long long* blocks, size_t* smem) {
  const bool long_h = kw == kShort && kh != kShort;
  if (!long_h && !(kh == kShort && kw != kShort)) return false;
  if (N < 1 || N > (1LL << 30) || C < 1 || H < 1 || W < 1) return false;
  if (kh % 2 == 0 || kw % 2 == 0) return false;
  F32Geom g{};
  g.N = (int)N; g.C = C; g.H = H; g.W = W;
  g.K = long_h ? kh : kw;
  g.L = long_h ? H : W;
  g.F = long_h ? W : H;
  g.LT = cdiv(g.L, 8);
  // the shift with the fewest live diagonals (the first of equals): the
  // band of n-tile nt reaches k-tiles nt + [(s - pk) / 8, (7 + pk + s) / 8]
  // (floor), within the map's k-tiles
  const int pk = g.K / 2;
  int nd = 0;
  for (int s = 0; s < 8; ++s) {
    const int lts = (g.L - 1 + s) / 8 + 1;
    // (s - pk - 7) / 8 is floor((s - pk) / 8) here (s - pk < 8)
    const int lo = std::max((s - pk - 7) / 8, 1 - g.LT);
    const int hi = std::min((7 + pk + s) / 8, lts - 1);
    if (nd == 0 || hi - lo + 1 < nd) {
      nd = hi - lo + 1;
      g.s = s;
      g.e_lo = lo;
      g.LTs = lts;
    }
  }
  if (nd > kNdMax) return false;
  g.MW = g.LT == 1 ? 1 : g.LT == 2 ? 2 : 4;
  g.WL = std::min(cdiv(g.LT, g.MW), kMaxWarps);
  g.lblocks = cdiv(g.LT, g.MW * g.WL);
  const int wf_max = std::max(1, kMaxWarps / g.WL);
  const long long nb =
      std::min(N, (long long)(kRows * wf_max + 2) / (g.F + 2));
  if (nb >= 2) {                       // whole images stacked along F
    g.stack = 1;
    g.NB = (int)nb;
    g.RPI = g.F + 2;
    g.WF = cdiv(g.NB * g.RPI - 2, kRows);
    g.BF = g.F;
    g.fblocks = 1;
    g.gblocks = (int)((N + nb - 1) / nb);
  } else {                             // slices of F, one image
    g.NB = 1;
    g.WF = std::min(wf_max, cdiv(g.F, kRows));
    g.BF = kRows * g.WF;
    g.fblocks = cdiv(g.F, g.BF);
    g.gblocks = g.N;
  }
  g.SR = kRows * g.WF + 4;
  g.KC = 8 * std::min(g.LTs, g.MW * g.WL + nd - 1);
  g.P = long_h ? pitch(g.SR, 8) : pitch(g.KC, 4);
  g.tab = 8 * nd + 8;
  g.x_off = (2 * kShort * g.tab + 31) / 32 * 32;
  const size_t bytes =
      sizeof(float) * ((size_t)g.x_off + (size_t)(long_h ? g.KC : g.SR) * g.P);
  if (bytes > kSmemMax) return false;
  const long long nblk = (long long)C * g.gblocks * g.fblocks * g.lblocks;
  if (nblk > 0x7fffffffLL) return false;
  *gp = g;
  *ndiag = nd;
  *warps = g.WF * g.WL;
  *blocks = nblk;
  *smem = bytes;
  return true;
}

template <int ND, int MW, bool LONG_H, bool STATS>
cudaError_t launch_t(const F32Geom& g, int warps, long long blocks,
                     size_t smem, const float* x, const float* w, float* out,
                     int accumulate, float* part, float* s1, float* s2,
                     cudaStream_t stream) {
  auto kernel = dwconv_band_f32_kernel<ND, MW, LONG_H, STATS>;
  static bool raised = false;                 // once an instantiation
  if (smem > 48 * 1024 && !raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemMax);
    if (e != cudaSuccess) return e;
    raised = true;
  }
  kernel<<<(unsigned)blocks, warps * 32, smem, stream>>>(
      x, w, out, g, accumulate, part, s1, s2);
  return cudaGetLastError();
}

// The instantiations: MW = 4 with ND = 1 .. 9; the maps of one or two
// n-tiles along L (MW = 1, 2) have at most 2 MW - 1 live diagonals (at
// shift 0: e = kt - nt with both tiles in the map).
template <bool LONG_H, bool STATS>
cudaError_t launch_o(int nd, const F32Geom& g, int warps, long long blocks,
                     size_t smem, const float* x, const float* w, float* out,
                     int accumulate, float* part, float* s1, float* s2,
                     cudaStream_t stream) {
#define F32_CASE(n, mw)                                                  \
  if (nd == n && g.MW == mw)                                             \
    return launch_t<n, mw, LONG_H, STATS>(g, warps, blocks, smem, x, w,  \
                                          out, accumulate, part, s1, s2, \
                                          stream);
  F32_CASE(1, 1)
  F32_CASE(1, 2) F32_CASE(2, 2) F32_CASE(3, 2)
  F32_CASE(1, 4) F32_CASE(2, 4) F32_CASE(3, 4) F32_CASE(4, 4) F32_CASE(5, 4)
  F32_CASE(6, 4) F32_CASE(7, 4) F32_CASE(8, 4) F32_CASE(9, 4)
#undef F32_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// out = conv(x, w) (+ out with accumulate). x, out: (N, C, H, W) float32,
// contiguous; w: (C, kh, kw) float32 taps, (K, 5) or (5, K), K odd and not
// 5, with at most 9 live diagonals (every K up to 65; any K where the long
// axis of the map is at most 40). Returns the cudaError_t of the launch,
// cudaErrorInvalidValue for shapes the route does not take.
extern "C" int slak_dwconv_band_f32(const float* x, const float* w,
                                    float* out, long long N, int C, int H,
                                    int W, int kh, int kw, int accumulate,
                                    void* stream) {
  F32Geom g;
  int nd, warps;
  long long blocks;
  size_t smem;
  if (!f32_geom(N, C, H, W, kh, kw, &g, &nd, &warps, &blocks, &smem))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(kw == kShort
                   ? launch_o<true, false>(nd, g, warps, blocks, smem, x, w,
                                           out, accumulate, nullptr, nullptr,
                                           nullptr, s)
                   : launch_o<false, false>(nd, g, warps, blocks, smem, x, w,
                                            out, accumulate, nullptr, nullptr,
                                            nullptr, s));
}

// The float32 scratch of slak_dwconv_band_f32_stats: one (s1, s2) partial
// a block, 2 * blocks floats (none where a channel has one block); -1 for
// shapes the route does not take.
extern "C" long long slak_dwconv_band_f32_stats_scratch(long long N, int C,
                                                        int H, int W, int kh,
                                                        int kw) {
  F32Geom g;
  int nd, warps;
  long long blocks;
  size_t smem;
  if (!f32_geom(N, C, H, W, kh, kw, &g, &nd, &warps, &blocks, &smem))
    return -1;
  return blocks == C ? 0 : 2 * blocks;
}

// K4: out = conv(x, w) as slak_dwconv_band_f32 (never added into out), and
// s1[c], s2[c] = the fp32 sum and sum of squares of channel c of the stored
// out. part: slak_dwconv_band_f32_stats_scratch floats. Two launches, one
// where a channel has one block.
// Returns the first failing cudaError_t, cudaErrorInvalidValue for shapes
// the route does not take.
extern "C" int slak_dwconv_band_f32_stats(const float* x, const float* w,
                                          float* out, float* part, float* s1,
                                          float* s2, long long N, int C, int H,
                                          int W, int kh, int kw,
                                          void* stream) {
  F32Geom g;
  int nd, warps;
  long long blocks;
  size_t smem;
  if (!f32_geom(N, C, H, W, kh, kw, &g, &nd, &warps, &blocks, &smem))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      kw == kShort ? launch_o<true, true>(nd, g, warps, blocks, smem, x, w,
                                          out, 0, part, s1, s2, s)
                   : launch_o<false, true>(nd, g, warps, blocks, smem, x, w,
                                           out, 0, part, s1, s2, s);
  if (e != cudaSuccess || blocks == C) return (int)e;
  band_f32_stats_reduce<<<C, kRedThreads, 0, s>>>(part, s1, s2,
                                                  (int)(blocks / C));
  return (int)cudaGetLastError();
}

// The launch geometry of slak_dwconv_band_f32 for these shapes, for the
// plain mirror to hold itself to: geom[0..9] = blocks, warps a block, ND,
// shared bytes, stacked, NB, the blocks along F, along L, the k-tiles'
// shift s, the first live diagonal e_lo. Returns 0, or -1 for shapes the
// route does not take.
extern "C" int slak_dwconv_band_f32_geom(long long N, int C, int H, int W,
                                         int kh, int kw, long long* geom) {
  F32Geom g;
  int nd, warps;
  long long blocks;
  size_t smem;
  if (!f32_geom(N, C, H, W, kh, kw, &g, &nd, &warps, &blocks, &smem))
    return -1;
  const long long v[10] = {blocks, warps, nd, (long long)smem, g.stack,
                           g.NB, g.fblocks, g.lblocks, g.s, g.e_lo};
  for (int i = 0; i < 10; ++i) geom[i] = v[i];
  return 0;
}
