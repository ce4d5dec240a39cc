// Depthwise "same" convolution, stride 1, odd taps (kh, kw), NCHW, as
// per-channel banded matrix products with g taps stacked along M and a
// shift-add: K1's function (dwconv.cu), computed the TPU's banded way.
//
// Replaces slak_tpu/ops/pallas_banded.py: dwconv_banded_stacked_cmajor
// (_fwd_stacked_kernel, build_banded_stacked). For one (n, c) plane and tap
// column j, the banded matrix A_j[h][h2] = w[h2 - h + kh/2][j] (zero
// outside the band) over the unpadded height turns the conv into
//   Z_j = A_j (H x H) @ Xp (H x Wp),   out[h][w] = sum_j Z_j[h][w + j],
// with Xp the plane padded by kw/2 zero columns on each side. g tap columns
// are stacked along M, [A_qg; ..; A_qg+g-1] (g*H x H), so one product
// covers g of them; nc = ceil(kw / g) chunks cover all. The TPU picked
// g = 128 / H, its lane width; here g = min(kw, 64 / H), so that a chunk's
// g*H rows fill one 64-row tile (four m16 tiles of the tensor cores): at
// SLaK-T's 224^2 maps g = 1, 2, 4, 5 for H = 56, 28, 14, 7.
//
// bfloat16: stacked_band_kernel, on the tensor cores (mma.sync m16n8k16,
// bf16 in, fp32 sums, ldmatrix fragments), with the blocks, staging and
// stores of K1's band kernel (dwconv.cu dwconv_band_kernel; copied, not
// shared, so that dwconv.cu's kernels keep their machine code):
//  - N = (image, padded column u): each plane is staged transposed, row
//    u = map column u - kw/2 (zero outside the map), its H values
//    contiguous and padded to 16, the images one after another, so that
//    ldmatrix feeds B as it lies. A block takes one channel and runs of NB
//    images (a chunk), double-buffered with one barrier a chunk: chunk
//    q + 1 is staged (its 8 x 8 blocks transposed by movmatrix) and chunk
//    q + 2 loaded into registers while chunk q computes. The rows of the
//    28-, 14- and 7-wide planes are not 16-byte aligned, so neither TMA nor
//    cp.async can stage them.
//  - A = a chunk's stacked band, row t*H + h = tap column q*g + t (zero for
//    the dead taps q*g + t >= kw), built once a block in shared memory
//    from the taps as 16 x 16 tiles; a mask a chunk marks the tiles on the
//    band with a live row, and no other tile is built or read.
//  - The chunk's shift q*g is a row offset of the staged operand, so every
//    chunk's products add into one set of fp32 accumulators,
//    Z[t*H + h][u] = sum_q (A_{qg+t} X shifted by q*g)[h][u], and each
//    k-tile's B fragment feeds all g taps' m-tiles: g times fewer B loads
//    than the band kernel, which reloads B for each of its 5 taps.
//  - The shift-add out[h][w] = sum_t Z[t*H + h][w + t] is warp-local, once
//    a warp tile after its last chunk: the rows of the taps t >= 1 go to
//    the warp's own fp32 tile in shared memory behind __syncwarp, and each
//    lane adds them, t = 1, 2, .. in order, to its accumulators of the
//    rows h < H (t = 0, in place), rounds once and stores value pairs along
//    w. No block barrier between the products and the stores; the same
//    bits on every run.
// A warp tile is WZ n-tiles of one image: the whole image for g > 1 (an
// output reads Z up to g - 1 columns to its right), any WZ of them for
// g = 1. At g = 1 (stage 1) a chunk is one tap and there is no shift-add:
// the kernel is K1's band kernel, A's tiles Toeplitz (TOEP: one tile a
// diagonal, built and loaded once for every m-tile it serves); the dense
// tiles of g > 1 measured 1.44x slower there (PERF.md). wgmma's m64 would
// fit g*H <= 64, but a tap's H rows would cross the warps of the warpgroup
// and the shift-add would go through shared memory block-wide: not taken.
//
// float32: stacked_f32_kernel, a simple version: one plane's products at a
// time, CUDA-core FMAs through simt_tile.cuh's 64 x 64 tile product (no
// TF32, as the JAX kernel's Precision.HIGHEST), the band read from the
// taps in shared memory; each chunk's Z goes to shared memory (fp32) and
// is added into the plane's output accumulator (fp32, shared), each output
// from one thread, taps in order; the output is stored once.
//
// What bounds it on an H100: the bytes (x read once, out written once). In
// bf16 the products are the band kernel's, with the padding of g*H to 16
// rows and of W + g - 1 to 8 columns wasted; what is left is latency: the
// staging, the fragment loads, the band build and the shift-add's shared
// memory traffic. In fp32 the FMAs on the CUDA cores bound it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "simt_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = simt_tile::kThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kM = simt_tile::kTile;     // rows of a chunk's tile
constexpr size_t kSmemMax = 200 * 1024;

int round_up(int a, int m) { return (a + m - 1) / m * m; }

cudaError_t allow(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemMax);
}

// ---------------------------------------------------------------------------
// float32

struct Geom {
  int N, C, H, W, kh, kw;
  int g, nc;           // taps a chunk, chunks
  int NB;              // images a block
  int Mq;              // rows of a chunk's Z (kM)
  int Np, LDZ;         // columns of Z (W + kw - 1, to kM), pitch
  int band_off, z_off, acc_off;   // byte offsets in shared memory
};

// acc[h][w] += sum over the chunk's taps t of Z[t*H + h][w + q*g + t]
// (each output from one thread; Z rows per tap: H).
__device__ void shift_add(const Geom& g, int q, const float* zs,
                          float* acc) {
  const int HW = g.H * g.W;
  for (int o = threadIdx.x; o < HW; o += kThreads) {
    const int h = o / g.W, w = o - h * g.W;
    float s = acc[o];
    for (int t = 0; t < g.g; ++t) {
      const int j = q * g.g + t;
      if (j >= g.kw) break;
      s += zs[(t * g.H + h) * g.LDZ + w + j];
    }
    acc[o] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
stacked_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ out, Geom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* taps = reinterpret_cast<float*>(smem + g.band_off);  // [kh][kw]
  float* zs = reinterpret_cast<float*>(smem + g.z_off);       // [Mq][LDZ]
  float* acc = reinterpret_cast<float*>(smem + g.acc_off);    // [H*W]
  const int c = blockIdx.x % g.C;
  const int n0 = (blockIdx.x / g.C) * g.NB;
  const int n1 = min(g.N, n0 + g.NB);
  const int H = g.H, W = g.W, pk = g.kh / 2, ps = g.kw / 2;
  for (int i = threadIdx.x; i < g.kh * g.kw; i += kThreads)
    taps[i] = w[(long long)c * g.kh * g.kw + i];
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  const long long plane = (long long)H * W;
  for (int n = n0; n < n1; ++n) {
    const float* xp = x + ((long long)n * g.C + c) * plane;
    __syncthreads();
    for (int o = threadIdx.x; o < H * W; o += kThreads) acc[o] = 0.f;
    for (int q = 0; q < g.nc; ++q) {
      for (int c0 = 0; c0 < g.Np; c0 += kM) {
        float d[4][4] = {};
        // A (row r = t*H + h, k = h2): the band; B (column col, k = h2):
        // the padded plane, x[h2][col - ps]
        simt_tile::product<16, true, false>(
            [&](int r, long long k) {
              const int t = r / H, h = r - t * H, j = q * g.g + t;
              const int i = (int)k - h + pk;
              return t < g.g && j < g.kw && k < H && i >= 0 && i < g.kh
                         ? taps[i * g.kw + j] : 0.f;
            },
            [&](int col, long long k) {
              const int wc_ = c0 + col - ps;
              return k < H && wc_ >= 0 && wc_ < W ? xp[k * W + wc_] : 0.f;
            },
            0, H, d);
        for (int i = 0; i < 4; ++i)
          for (int j = 0; j < 4; ++j)
            zs[(tr * 4 + i) * g.LDZ + c0 + tc * 4 + j] = d[i][j];
      }
      __syncthreads();
      shift_add(g, q, zs, acc);
      __syncthreads();
    }
    float* op = out + ((long long)n * g.C + c) * plane;
    for (int o = threadIdx.x; o < H * W; o += kThreads) op[o] = acc[o];
  }
}

// The float32 geometry and the shared memory a block needs; false when it
// does not fit (maps above 64 rows, or a plane too large).
bool make_geom(int N, int C, int H, int W, int kh, int kw, Geom* gp,
               size_t* smem_out) {
  if (H > kM) return false;
  Geom g{};
  g.N = N; g.C = C; g.H = H; g.W = W; g.kh = kh; g.kw = kw;
  g.g = kM / H < kw ? kM / H : kw;
  g.nc = (kw + g.g - 1) / g.g;
  // about 1024 blocks: channels times image groups
  int groups = (1024 + C - 1) / C;
  if (groups > N) groups = N;
  g.NB = (N + groups - 1) / groups;
  g.Mq = kM;
  g.Np = round_up(W + kw - 1, kM);
  g.band_off = 0;
  size_t off = (size_t)kh * kw * 4;
  g.LDZ = g.Np + 4;
  g.z_off = (int)round_up((int)off, 16);
  off = g.z_off + (size_t)g.Mq * g.LDZ * 4;
  g.acc_off = (int)round_up((int)off, 16);
  off = g.acc_off + (size_t)H * W * 4;
  if (off > kSmemMax) return false;
  *gp = g;
  *smem_out = off;
  return true;
}

// ---------------------------------------------------------------------------
// bfloat16: stacked_band_kernel (see the header)

constexpr int kBandMax = 64;           // H and W
constexpr int kTileP = 24;             // a band tile's row pitch (16 + 8)
constexpr int kTileE = 16 * kTileP;    // bf16 values a band tile

struct BandGeom {
  int N, C, H, W, kh, kw;
  int g, nc;           // taps a chunk, chunks
  int MQ, KT;          // m-tiles a chunk (g*H to 16), k-tiles (H to 16)
  int NZ, WZ, TPI;     // n-tiles of Z an image (W + g - 1 to 8), n-tiles a
                       // warp tile, warp tiles an image
  int RPI, P;          // staged rows an image, staged row pitch (bf16)
  int BW, BPI, HW;     // 8 x 8 blocks across W and in a plane; plane
  int NB, CPB;         // images a chunk, chunks a block
  int ZR, ZP;          // a warp's Z tile: rows ((g - 1) H), pitch (floats)
  int mask_off, b_off, b_bytes, z_off;   // shared memory (bytes): the band
                       // tiles at 0, the chunk masks, the two staged
                       // buffers (b_bytes each), the warps' Z tiles
};

// Staging registers a lane (8 x 8 blocks a warp and chunk).
__host__ __device__ constexpr int stacked_pre(int MQ) {
  return MQ == 1 ? 8 : 16;
}

__device__ __forceinline__ void ldsm_x4(unsigned* r, const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// the transpose of the warp's 8 x 8 matrix of 16-bit values held as mma
// fragments (lane: row lane / 4, columns 2 (lane % 4) and + 1)
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

// Whether the integers [a, b) meet [lo, hi].
__device__ __forceinline__ bool meets(int a, int b, int lo, int hi) {
  return a < b && a <= hi && b > lo;
}

// Chunk q's live band tiles, bit 4 mt + kt: the tiles with a row t*H + h
// of a live tap (q*g + t < kw) and a column k < H with |k - h| <= kh / 2.
// An m-tile's n live rows hold h = h0, h0 + 1, .. wrapped at H.
__device__ unsigned live_mask(const BandGeom& g, int q) {
  const int pk = g.kh / 2;
  const int rows = min(g.g, g.kw - q * g.g) * g.H;
  unsigned m = 0u;
  for (int mt = 0; mt < g.MQ; ++mt) {
    const int n = min(16 * mt + 16, rows) - 16 * mt, h0 = 16 * mt % g.H;
    for (int kt = 0; kt < g.KT && n > 0; ++kt) {
      const int lo = 16 * kt - pk, hi = min(16 * kt + 15, g.H - 1) + pk;
      if (n >= g.H || meets(h0, min(g.H, h0 + n), lo, hi) ||
          meets(0, h0 + n - g.H, lo, hi))
        m |= 1u << (4 * mt + kt);
    }
  }
  return m;
}

// A chunk's 8 x 8 blocks: block b = warp + 8 i of the lane's loads and
// stores, image b / BPI; blk[b] = (its offset in the chunk's planes, its
// offset in a staged buffer, the rows and columns of the map it holds).
// Map value (h, w) of image img is staged at row img * RPI + kw/2 + w,
// column h.
__device__ __forceinline__ void stacked_blocks(const BandGeom& g, int4* blk) {
  for (int b = threadIdx.x; b < g.NB * g.BPI; b += kThreads) {
    const int img = b / g.BPI, rem = b - img * g.BPI;
    const int bh = rem / g.BW, bw = rem - bh * g.BW;
    blk[b] = make_int4(img * g.C * g.HW + bh * 8 * g.W + bw * 8,
                       (img * g.RPI + g.kw / 2 + bw * 8) * g.P + bh * 8,
                       g.H - bh * 8, g.W - bw * 8);
  }
}

// The chunk's planes (nimg images from image n, channel c) into registers,
// a block at a time: the lane's two values at (row lane / 4, columns
// 2 (lane % 4) and + 1) of the block, one 4-byte load where W is even
// (PAIR), else two 2-byte loads; zero outside the map.
template <int PRE, bool PAIR>
__device__ __forceinline__ void stacked_load(const BandGeom& g,
                                             const int4* blk, const bf16* x,
                                             int n, int nimg, int c,
                                             unsigned* pre) {
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

// The registers into a staged buffer, each block transposed in registers
// with movmatrix; 4-byte stores. The blocks' zero values outside the map
// fill the padding.
template <int PRE>
__device__ __forceinline__ void stacked_stage(const BandGeom& g,
                                              const int4* blk, bf16* bs,
                                              int nimg, const unsigned* pre) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nblk = nimg * g.BPI;
  bf16* base = bs + (lane >> 2) * g.P + 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < PRE; ++i) {
    const int b = warp + i * kWarps;
    if (b >= nblk) break;
    *reinterpret_cast<unsigned*>(base + blk[b].y) = movt(pre[i]);
  }
}

// Output values (h, w) and (h, w + 1) of a plane, rounded once; the second
// only inside the map.
template <bool PAIR>
__device__ __forceinline__ void stacked_put(const BandGeom& g, bf16* out,
                                            long long plane, int h, int w,
                                            float v0, float v1) {
  bf16* dst = out + plane + h * g.W + w;
  const bf16 y0 = __float2bfloat16(v0), y1 = __float2bfloat16(v1);
  if (PAIR) {
    *reinterpret_cast<unsigned*>(dst) =
        (unsigned)__bfloat16_as_ushort(y0) |
        ((unsigned)__bfloat16_as_ushort(y1) << 16);
  } else {
    dst[0] = y0;
    if (w + 1 < g.W) dst[1] = y1;
  }
}

// A chunk of nimg images (from image n): each warp tile's products over
// every chunk of taps, its shift-add and its stores. Warp tile wt = image
// wt / TPI, Z n-tiles z0 .. z0 + nz - 1 (columns u = 8 z ..). Band tile
// (q, mt, kt) at ((q MQ + mt) KT + kt) kTileE; with TOEP (g = 1, one tap a
// chunk: A is Toeplitz in 16 x 16 tiles, tile (mt, kt) = D_q[kt - mt])
// tile D_q[d] at (q (2 MQ - 1) + d + MQ - 1) kTileE, K1's band kernel's.
template <int MQ, int WZ, bool PAIR, bool TOEP>
__device__ __forceinline__ void stacked_tiles(
    const BandGeom& g, const bf16* band, const unsigned* mask,
    const bf16* bs, float* zw, bf16* out, int n, int c, int nimg) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const bf16* a_lane = band + ((lane & 7) + ((lane >> 3) & 1) * 8) * kTileP +
                       (lane >> 4) * 8;
  const int WT = nimg * g.TPI;
  for (int wt = warp; wt < WT; wt += kWarps) {
    const int img = wt / g.TPI, z0 = (wt - img * g.TPI) * WZ;
    const int nz = min(WZ, g.NZ - z0);
    float acc[MQ][WZ][4];
#pragma unroll
    for (int mt = 0; mt < MQ; ++mt)
#pragma unroll
      for (int nn = 0; nn < WZ; ++nn)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nn][i] = 0.f;
    // the lane's ldmatrix row of each pair of n-tiles (lanes 16-31: the
    // pair's second); an n-tile past the image reads its last one's rows
    int brow[WZ / 2];
#pragma unroll
    for (int p = 0; p < WZ / 2; ++p) {
      const int z = min(z0 + 2 * p + (lane >> 4), g.NZ - 1);
      brow[p] = (img * g.RPI + 8 * z + (lane & 7)) * g.P +
                ((lane >> 3) & 1) * 8;
    }
    for (int q = 0; q < g.nc; ++q) {
      const unsigned live = mask[q];
      const bf16* bq = bs + q * g.g * g.P;           // the rows shifted by q g
      if (TOEP) {
        // g = 1: the B fragments of every k-tile, then each diagonal's
        // tile once, into every (m-tile, k-tile = m-tile + d) on the band
        constexpr int ND = 2 * MQ - 1;
        unsigned b[MQ][WZ][2];
#pragma unroll
        for (int kt = 0; kt < MQ; ++kt)
#pragma unroll
          for (int p = 0; p < WZ / 2; ++p) {
            unsigned r[4];
            ldsm_x4(r, bq + brow[p] + kt * 16);
            b[kt][2 * p][0] = r[0];
            b[kt][2 * p][1] = r[1];
            b[kt][2 * p + 1][0] = r[2];
            b[kt][2 * p + 1][1] = r[3];
          }
#pragma unroll
        for (int di = 0; di < ND; ++di) {
          const int d = di - (MQ - 1);
          if (16 * (d < 0 ? -d : d) - 15 > g.kh / 2) continue;
          unsigned a[4];
          ldsm_x4(a, a_lane + (q * ND + di) * kTileE);
#pragma unroll
          for (int mt = 0; mt < MQ; ++mt) {
            const int kt = mt + d;
            if (kt < 0 || kt >= MQ) continue;
#pragma unroll
            for (int nn = 0; nn < WZ; ++nn)
              if (nn < nz)
                mma_bf16(acc[mt][nn], a, b[kt][nn][0], b[kt][nn][1]);
          }
        }
        continue;
      }
      const bf16* aq = a_lane + q * MQ * g.KT * kTileE;
#pragma unroll
      for (int kt = 0; kt < MQ; ++kt) {
        if (kt >= g.KT) break;
        unsigned b[WZ][2];
#pragma unroll
        for (int p = 0; p < WZ / 2; ++p) {
          unsigned r[4];
          ldsm_x4(r, bq + brow[p] + kt * 16);
          b[2 * p][0] = r[0];
          b[2 * p][1] = r[1];
          b[2 * p + 1][0] = r[2];
          b[2 * p + 1][1] = r[3];
        }
#pragma unroll
        for (int mt = 0; mt < MQ; ++mt) {
          if (!((live >> (4 * mt + kt)) & 1u)) continue;
          unsigned a[4];
          ldsm_x4(a, aq + (mt * g.KT + kt) * kTileE);
#pragma unroll
          for (int nn = 0; nn < WZ; ++nn)
            if (nn < nz) mma_bf16(acc[mt][nn], a, b[nn][0], b[nn][1]);
        }
      }
    }
    // the shift-add: the rows t*H + h of the taps t >= 1 through the warp's
    // Z tile (row (t - 1) H + h), added in order to the rows h < H
    if (g.g > 1) {
#pragma unroll
      for (int mt = 0; mt < MQ; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int m = 16 * mt + 8 * hf + gid;
          if (m < g.H || m >= g.g * g.H) continue;
#pragma unroll
          for (int nn = 0; nn < WZ; ++nn)
            if (nn < nz)
              *reinterpret_cast<float2*>(zw + (m - g.H) * g.ZP + 8 * nn +
                                         2 * tig) =
                  make_float2(acc[mt][nn][2 * hf], acc[mt][nn][2 * hf + 1]);
        }
      __syncwarp();
    }
    const long long plane = ((long long)(n + img) * g.C + c) * g.HW;
#pragma unroll
    for (int mt = 0; mt < MQ; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int h = 16 * mt + 8 * hf + gid;
        if (h >= g.H) continue;
#pragma unroll
        for (int nn = 0; nn < WZ; ++nn) {
          const int w = 8 * (z0 + nn) + 2 * tig;
          if (nn >= nz || w >= g.W) continue;
          float v0 = acc[mt][nn][2 * hf], v1 = acc[mt][nn][2 * hf + 1];
          const float* zr = zw + h * g.ZP + 8 * nn + 2 * tig;
          for (int t = 1; t < g.g; ++t, zr += g.H * g.ZP) {
            v0 += zr[t];
            v1 += zr[t + 1];
          }
          stacked_put<PAIR>(g, out, plane, h, w, v0, v1);
        }
      }
    if (g.g > 1) __syncwarp();      // the Z tile read before it is reused
  }
}

template <int MQ, int WZ, bool PAIR, bool TOEP>
__global__ void __launch_bounds__(kThreads, 2)
stacked_band_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
                    bf16* __restrict__ out, BandGeom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int PRE = stacked_pre(MQ);
  bf16* band = reinterpret_cast<bf16*>(smem);
  unsigned* mask = reinterpret_cast<unsigned*>(smem + g.mask_off);
  bf16* bsb[2] = {reinterpret_cast<bf16*>(smem + g.b_off),
                  reinterpret_cast<bf16*>(smem + g.b_off + g.b_bytes)};
  float* zw = reinterpret_cast<float*>(smem + g.z_off) +
              (threadIdx.x >> 5) * g.ZR * g.ZP;
  const int c = blockIdx.x % g.C, grp = blockIdx.x / g.C;
  const int n_begin = grp * g.CPB * g.NB;
  const int n_end = min(g.N, n_begin + g.CPB * g.NB);
  const int nq = (n_end - n_begin + g.NB - 1) / g.NB;
  const int pk = g.kh / 2;

  __shared__ int4 blk[PRE * kWarps];
  stacked_blocks(g, blk);
  for (int q = threadIdx.x; q < (TOEP ? 0 : g.nc); q += kThreads)
    mask[q] = live_mask(g, q);
  __syncthreads();
  unsigned pre[PRE];
  stacked_load<PRE, PAIR>(g, blk, x, n_begin, min(g.NB, n_end - n_begin), c,
                          pre);
  // both staged buffers zeroed once (their halo rows and padding stay
  // zero), and the live band tiles, 8 values a store
  for (int i = threadIdx.x; i < 2 * g.b_bytes / 16; i += kThreads)
    reinterpret_cast<uint4*>(bsb[0])[i] = make_uint4(0u, 0u, 0u, 0u);
  const float* wc = w + (long long)c * g.kh * g.kw;
  for (int i = threadIdx.x; i < (TOEP ? g.nc * (2 * MQ - 1) * 32 : 0);
       i += kThreads) {
    const int tile = i >> 5, r = (i >> 1) & 15, c0 = (i & 1) * 8;
    const int q = tile / (2 * MQ - 1), d = tile - q * (2 * MQ - 1) - MQ + 1;
    if (16 * (d < 0 ? -d : d) - 15 > pk) continue;
    unsigned v[4];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int i2 = 16 * d + c0 + e - r + pk;
      const float tv = i2 >= 0 && i2 < g.kh ? wc[i2 * g.kw + q] : 0.f;
      const unsigned hv = __bfloat16_as_ushort(__float2bfloat16(tv));
      v[e >> 1] = e & 1 ? v[e >> 1] | hv << 16 : hv;
    }
    *reinterpret_cast<uint4*>(band + tile * kTileE + r * kTileP + c0) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
  for (int i = threadIdx.x; i < (TOEP ? 0 : g.nc * MQ * g.KT * 32);
       i += kThreads) {
    const int tile = i >> 5, r = (i >> 1) & 15, c0 = (i & 1) * 8;
    const int q = tile / (MQ * g.KT), mk = tile - q * MQ * g.KT;
    const int mt = mk / g.KT, kt = mk - mt * g.KT;
    if (!((mask[q] >> (4 * mt + kt)) & 1u)) continue;
    const int m = 16 * mt + r, t = m / g.H, h = m - t * g.H;
    const int j = q * g.g + t;
    const bool row = t < g.g && j < g.kw;
    unsigned v[4];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int k = 16 * kt + c0 + e, i2 = k - h + pk;
      const float tv = row && k < g.H && i2 >= 0 && i2 < g.kh
                           ? wc[i2 * g.kw + j] : 0.f;
      const unsigned hv = __bfloat16_as_ushort(__float2bfloat16(tv));
      v[e >> 1] = e & 1 ? v[e >> 1] | hv << 16 : hv;
    }
    *reinterpret_cast<uint4*>(band + tile * kTileE + r * kTileP + c0) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
  __syncthreads();
  stacked_stage<PRE>(g, blk, bsb[0], min(g.NB, n_end - n_begin), pre);
  if (nq > 1)
    stacked_load<PRE, PAIR>(g, blk, x, n_begin + g.NB,
                            min(g.NB, n_end - n_begin - g.NB), c, pre);
  __syncthreads();

  // chunk qi: stage chunk qi + 1 into the other buffer and start loading
  // chunk qi + 2, then chunk qi's warp tiles; one barrier
  for (int qi = 0; qi < nq; ++qi) {
    const int n = n_begin + qi * g.NB, nimg = min(g.NB, n_end - n);
    if (qi + 1 < nq) {
      stacked_stage<PRE>(g, blk, bsb[(qi + 1) & 1],
                         min(g.NB, n_end - n - g.NB), pre);
      if (qi + 2 < nq)
        stacked_load<PRE, PAIR>(g, blk, x, n + 2 * g.NB,
                                min(g.NB, n_end - n - 2 * g.NB), c, pre);
    }
    stacked_tiles<MQ, WZ, PAIR, TOEP>(g, band, mask, bsb[qi & 1], zw, out, n,
                                      c, nimg);
    __syncthreads();
  }
}

// The bf16 geometry (ops/dwconv_stacked.py stacked_band_geometry repeats
// it): false when the kernel does not take the shapes. bpc = blocks a
// channel.
bool band_geom(long long N, int C, int H, int W, int kh, int kw,
               BandGeom* gp, int* bpc, size_t* smem_out) {
  if (N < 1 || N > (1LL << 30) || C < 1 || H < 1 || H > kBandMax || W < 1 ||
      W > kBandMax || kh < 1 || kw < 1 || kh % 2 == 0 || kw % 2 == 0)
    return false;
  BandGeom g{};
  g.N = (int)N; g.C = C; g.H = H; g.W = W; g.kh = kh; g.kw = kw;
  g.g = kM / H < kw ? kM / H : kw;
  g.nc = (kw + g.g - 1) / g.g;
  g.MQ = (g.g * H + 15) / 16;
  g.KT = (H + 15) / 16;
  g.NZ = (W + g.g - 1 + 7) / 8;
  if (g.g == 1)                // Toeplitz tiles, K1's band kernel's
    g.WZ = g.MQ <= 2 ? 4 : 2;
  else
    g.WZ = g.MQ <= 2 ? 8 : 4;
  if (g.g > 1 && g.NZ > g.WZ) return false;    // a warp tile is the image
  g.TPI = (g.NZ + g.WZ - 1) / g.WZ;
  g.RPI = 8 * g.NZ + (g.nc - 1) * g.g;
  if (g.RPI < kw / 2 + round_up(W, 8)) g.RPI = kw / 2 + round_up(W, 8);
  g.P = 16 * g.KT + 8;
  g.BW = (W + 7) / 8;
  g.BPI = (H + 7) / 8 * g.BW;
  g.HW = H * W;
  // the images of one round of the 8 warps' tiles, as their 8 x 8 blocks
  // take in stacked_pre registers a lane
  const int pre = stacked_pre(g.MQ) * kWarps;
  int nb = kWarps / g.TPI;
  if (nb > pre / g.BPI) nb = pre / g.BPI;
  if (nb > g.N) nb = g.N;
  g.NB = nb < 1 ? 1 : nb;
  if (g.NB * g.BPI > pre) return false;
  // about 1024 blocks: channels times runs of chunks
  const int chunks = (g.N + g.NB - 1) / g.NB;
  int per = (1024 + C - 1) / C;
  if (per > chunks) per = chunks;
  g.CPB = (chunks + per - 1) / per;
  g.ZR = (g.g - 1) * H;
  g.ZP = 8 * g.WZ + 8;
  size_t off = (size_t)g.nc * (g.g == 1 ? 2 * g.MQ - 1 : g.MQ * g.KT) *
               kTileE * 2;
  g.mask_off = (int)off;
  off += round_up(4 * g.nc, 16);
  g.b_off = (int)off;
  g.b_bytes = round_up(g.NB * g.RPI * g.P * 2, 16);
  off += 2 * (size_t)g.b_bytes;
  g.z_off = (int)off;
  off += (size_t)kWarps * g.ZR * g.ZP * 4;
  if (off > kSmemMax) return false;
  *gp = g;
  *bpc = (chunks + g.CPB - 1) / g.CPB;
  *smem_out = off;
  return true;
}

template <int MQ, int WZ, bool PAIR, bool TOEP>
cudaError_t launch_band_t(const BandGeom& g, int bpc, size_t smem,
                          const void* x, const float* w, void* out,
                          cudaStream_t stream) {
  auto kernel = stacked_band_kernel<MQ, WZ, PAIR, TOEP>;
  static bool raised = false;                 // once an instantiation
  if (!raised) {
    const cudaError_t e = allow(reinterpret_cast<const void*>(kernel), smem);
    if (e != cudaSuccess) return e;
    raised = smem > 48 * 1024;
  }
  kernel<<<(unsigned)(g.C * bpc), kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), w, static_cast<bf16*>(out), g);
  return cudaGetLastError();
}

template <bool PAIR>
cudaError_t launch_band_p(const BandGeom& g, int bpc, size_t smem,
                          const void* x, const float* w, void* out,
                          cudaStream_t stream) {
  switch (g.MQ * 16 + g.WZ) {     // g = 1: WZ 4 (MQ <= 2) or 2, TOEP
    case 16 + 4: return launch_band_t<1, 4, PAIR, true>(g, bpc, smem, x, w,
                                                        out, stream);
    case 32 + 4: return launch_band_t<2, 4, PAIR, true>(g, bpc, smem, x, w,
                                                        out, stream);
    case 48 + 2: return launch_band_t<3, 2, PAIR, true>(g, bpc, smem, x, w,
                                                        out, stream);
    case 64 + 2: return launch_band_t<4, 2, PAIR, true>(g, bpc, smem, x, w,
                                                        out, stream);
    case 16 + 8: return launch_band_t<1, 8, PAIR, false>(g, bpc, smem, x, w,
                                                         out, stream);
    case 32 + 8: return launch_band_t<2, 8, PAIR, false>(g, bpc, smem, x, w,
                                                         out, stream);
    case 48 + 4: return launch_band_t<3, 4, PAIR, false>(g, bpc, smem, x, w,
                                                         out, stream);
    case 64 + 4: return launch_band_t<4, 4, PAIR, false>(g, bpc, smem, x, w,
                                                         out, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// 1 when slak_dwconv_stacked takes these shapes, else 0.
extern "C" int slak_dwconv_stacked_ok(int dtype, long long N, int C, int H,
                                      int W, int kh, int kw) {
  if (dtype == 1) {
    BandGeom g;
    int bpc;
    size_t smem;
    return band_geom(N, C, H, W, kh, kw, &g, &bpc, &smem);
  }
  Geom g;
  size_t smem;
  return dtype == 0 && N < (1LL << 31) && kh % 2 == 1 && kw % 2 == 1 &&
         make_geom((int)N, C, H, W, kh, kw, &g, &smem);
}

// The bf16 kernel's geometry for these shapes into v[0..12]: g, nc, MQ,
// KT, NZ, WZ, TPI, RPI, NB, CPB, blocks a channel, shared bytes, blocks.
// Returns 0, or 1 when the kernel does not take the shapes.
extern "C" int slak_dwconv_stacked_geom(long long N, int C, int H, int W,
                                        int kh, int kw, long long* v) {
  BandGeom g;
  int bpc;
  size_t smem;
  if (!band_geom(N, C, H, W, kh, kw, &g, &bpc, &smem)) return 1;
  const long long r[13] = {g.g, g.nc, g.MQ, g.KT, g.NZ, g.WZ, g.TPI, g.RPI,
                           g.NB, g.CPB, bpc, (long long)smem,
                           (long long)C * bpc};
  for (int i = 0; i < 13; ++i) v[i] = r[i];
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16. x, out: (N, C, H, W) contiguous; w:
// (C, kh, kw) float32 taps, odd. Returns the cudaError_t of the launch
// (cudaErrorInvalidConfiguration for shapes the kernel does not take).
extern "C" int slak_dwconv_stacked(int dtype, const void* x, const float* w,
                                   void* out, long long N, int C, int H,
                                   int W, int kh, int kw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    BandGeom g;
    int bpc;
    size_t smem;
    if (!band_geom(N, C, H, W, kh, kw, &g, &bpc, &smem))
      return (int)cudaErrorInvalidConfiguration;
    const bool pair = W % 2 == 0 &&
                      (((uintptr_t)x | (uintptr_t)out) & 3) == 0;
    return (int)(pair ? launch_band_p<true>(g, bpc, smem, x, w, out, s)
                      : launch_band_p<false>(g, bpc, smem, x, w, out, s));
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  Geom g;
  size_t smem;
  if (!make_geom((int)N, C, H, W, kh, kw, &g, &smem))
    return (int)cudaErrorInvalidConfiguration;
  const unsigned blocks = (unsigned)(C * ((N + g.NB - 1) / g.NB));
  const cudaError_t e =
      allow(reinterpret_cast<const void*>(stacked_f32_kernel), smem);
  if (e != cudaSuccess) return (int)e;
  stacked_f32_kernel<<<blocks, kThreads, smem, s>>>(
      static_cast<const float*>(x), w, static_cast<float*>(out), g);
  return (int)cudaGetLastError();
}
