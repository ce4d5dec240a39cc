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
// g*H rows fill one 64-row tile (a block's M extent in both routes): at
// SLaK-T's 224^2 maps g = 1, 2, 4, 5 for H = 56, 28, 14, 7.
//
// A block takes one channel and a group of images. It builds the channel's
// band in shared memory from the taps once (never in device memory), then
// for each image: stages the plane, and for each chunk computes Z into
// shared memory (fp32), then adds it into the plane's output accumulator
// (fp32, shared), each output from one thread, taps in order, so the sums
// are the same on every run; the output is rounded and stored once.
//
// bfloat16: the products run on the tensor cores, mma.sync m16n8k16 with
// fp32 accumulation; the band (bf16, exact: the taps are rounded to the
// compute dtype by the caller) and the plane (transposed, k contiguous)
// are padded to 16 rows / columns. float32: CUDA-core FMAs through
// simt_tile.cuh's 64 x 64 tile product (no TF32, as the JAX kernel's
// Precision.HIGHEST), the band read from the taps in shared memory.
//
// What bounds it on an H100: at SLaK's shapes the band does little wasted
// work (stage 1: 56 MACs an output and tap column against 51 real ones;
// none at stages 2-3, where the band is clipped to H), so in bf16 the
// tensor-core rate bounds the products, far above the CUDA cores' rate
// that bounds K1; the bytes (x read once, out written once) and the
// shift-add through shared memory are what is left. The zero padding of
// the tensor-core tiles (H to a multiple of 16, W + kw - 1 to one of 8)
// is wasted work. A simple version: one plane's products at a time.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "simt_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<bf16>(bf16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

constexpr int kThreads = simt_tile::kThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kM = simt_tile::kTile;     // rows of a chunk's tile
constexpr size_t kSmemMax = 200 * 1024;

struct Geom {
  int N, C, H, W, kh, kw;
  int g, nc;           // taps a chunk, chunks
  int NB;              // images a block
  int Hp, LDB;         // bf16: band K extent (H to 16) and row pitch
  int Mq;              // rows of a chunk's Z (bf16: g*H to 16; fp32: kM)
  int Np, LDZ;         // columns of Z (W + kw - 1, to 8 or to kM), pitch
  int LDX;             // bf16: pitch of the transposed plane
  int band_off, x_off, z_off, acc_off;   // byte offsets in shared memory
};

__device__ __forceinline__ unsigned ld32(const bf16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// d += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_16816(float* d, const unsigned* a,
                                          unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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
stacked_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
                    bf16* __restrict__ out, Geom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* band = reinterpret_cast<bf16*>(smem + g.band_off);   // [nc*Mq][LDB]
  bf16* xt = reinterpret_cast<bf16*>(smem + g.x_off);        // [Np][LDX]
  float* zs = reinterpret_cast<float*>(smem + g.z_off);      // [Mq][LDZ]
  float* acc = reinterpret_cast<float*>(smem + g.acc_off);   // [H*W]
  const int c = blockIdx.x % g.C;
  const int n0 = (blockIdx.x / g.C) * g.NB;
  const int n1 = min(g.N, n0 + g.NB);
  const int H = g.H, W = g.W, pk = g.kh / 2, ps = g.kw / 2;
  const float* wc = w + (long long)c * g.kh * g.kw;

  // the band: row r of chunk q is (t, h) = (r / H, r % H), column h2
  for (int i = threadIdx.x; i < g.nc * g.Mq * g.Hp; i += kThreads) {
    const int q = i / (g.Mq * g.Hp), rem = i - q * g.Mq * g.Hp;
    const int r = rem / g.Hp, h2 = rem - r * g.Hp;
    const int t = r / H, h = r - t * H, j = q * g.g + t, k = h2 - h + pk;
    float v = 0.f;
    if (t < g.g && j < g.kw && h2 < H && k >= 0 && k < g.kh)
      v = wc[k * g.kw + j];
    band[(q * g.Mq + r) * g.LDB + h2] = __float2bfloat16(v);
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int tiles_m = g.Mq / 16, tiles_n = g.Np / 8;
  const long long plane = (long long)H * W;
  for (int n = n0; n < n1; ++n) {
    const bf16* xp = x + ((long long)n * g.C + c) * plane;
    __syncthreads();                 // the previous image's reads are done
    // the plane, transposed: xt[col][h2] = x[h2][col - ps], zero padded
    for (int i = threadIdx.x; i < g.Np * g.Hp; i += kThreads) {
      const int h2 = i / g.Np, col = i - h2 * g.Np, wc_ = col - ps;
      bf16 v = __float2bfloat16(0.f);
      if (h2 < H && wc_ >= 0 && wc_ < W) v = xp[(long long)h2 * W + wc_];
      xt[col * g.LDX + h2] = v;
    }
    for (int o = threadIdx.x; o < H * W; o += kThreads) acc[o] = 0.f;
    for (int q = 0; q < g.nc; ++q) {
      __syncthreads();               // plane staged / previous Z consumed
      const bf16* bq = band + q * g.Mq * g.LDB;
      for (int tile = warp; tile < tiles_m * tiles_n; tile += kWarps) {
        const int m0 = (tile / tiles_n) * 16, c0 = (tile % tiles_n) * 8;
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        for (int k0 = 0; k0 < g.Hp; k0 += 16) {
          unsigned a[4];
          const bf16* ar = bq + (m0 + gid) * g.LDB + k0 + 2 * tig;
          a[0] = ld32(ar);
          a[1] = ld32(ar + 8 * g.LDB);
          a[2] = ld32(ar + 8);
          a[3] = ld32(ar + 8 * g.LDB + 8);
          const bf16* br = xt + (c0 + gid) * g.LDX + k0 + 2 * tig;
          mma_16816(d, a, ld32(br), ld32(br + 8));
        }
        float* zr = zs + (m0 + gid) * g.LDZ + c0 + 2 * tig;
        zr[0] = d[0];
        zr[1] = d[1];
        zr[8 * g.LDZ] = d[2];
        zr[8 * g.LDZ + 1] = d[3];
      }
      __syncthreads();
      shift_add(g, q, zs, acc);
    }
    __syncthreads();
    bf16* op = out + ((long long)n * g.C + c) * plane;
    for (int o = threadIdx.x; o < H * W; o += kThreads)
      op[o] = __float2bfloat16(acc[o]);
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

int round_up(int a, int m) { return (a + m - 1) / m * m; }

// The geometry and the shared memory a block needs; false when it does not
// fit (maps above 64 rows, or a plane too large for shared memory).
bool make_geom(int dtype, int N, int C, int H, int W, int kh, int kw,
               Geom* gp, size_t* smem_out) {
  if (H > kM) return false;
  Geom g{};
  g.N = N; g.C = C; g.H = H; g.W = W; g.kh = kh; g.kw = kw;
  g.g = kM / H < kw ? kM / H : kw;
  g.nc = (kw + g.g - 1) / g.g;
  // about 1024 blocks: channels times image groups
  int groups = (1024 + C - 1) / C;
  if (groups > N) groups = N;
  g.NB = (N + groups - 1) / groups;
  const int Wp = W + kw - 1;
  size_t off = 0;
  if (dtype == 1) {
    g.Hp = round_up(H, 16);
    g.LDB = g.Hp + 8;
    g.Mq = round_up(g.g * H, 16);
    g.Np = round_up(Wp, 8);
    g.LDX = g.Hp + 8;
    g.band_off = 0;
    off = (size_t)g.nc * g.Mq * g.LDB * 2;
    g.x_off = (int)round_up((int)off, 16);
    off = g.x_off + (size_t)g.Np * g.LDX * 2;
  } else {
    g.Mq = kM;
    g.Np = round_up(Wp, kM);
    g.band_off = 0;
    off = (size_t)kh * kw * 4;
    g.x_off = (int)round_up((int)off, 16);
  }
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

cudaError_t allow(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemMax);
}

}  // namespace

// 1 when slak_dwconv_stacked takes these shapes, else 0.
extern "C" int slak_dwconv_stacked_ok(int dtype, long long N, int C, int H,
                                      int W, int kh, int kw) {
  Geom g;
  size_t smem;
  return N < (1LL << 31) && kh % 2 == 1 && kw % 2 == 1 &&
         make_geom(dtype, (int)N, C, H, W, kh, kw, &g, &smem);
}

// dtype: 0 = float32, 1 = bfloat16. x, out: (N, C, H, W) contiguous; w:
// (C, kh, kw) float32 taps, odd. Returns the cudaError_t of the launch.
extern "C" int slak_dwconv_stacked(int dtype, const void* x, const float* w,
                                   void* out, long long N, int C, int H,
                                   int W, int kh, int kw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Geom g;
  size_t smem;
  if (!make_geom(dtype, (int)N, C, H, W, kh, kw, &g, &smem))
    return (int)cudaErrorInvalidConfiguration;
  const unsigned blocks = (unsigned)(C * ((N + g.NB - 1) / g.NB));
  cudaError_t e;
  if (dtype == 1) {
    e = allow(reinterpret_cast<const void*>(stacked_bf16_kernel), smem);
    if (e != cudaSuccess) return (int)e;
    stacked_bf16_kernel<<<blocks, kThreads, smem, s>>>(
        static_cast<const bf16*>(x), w, static_cast<bf16*>(out), g);
  } else if (dtype == 0) {
    e = allow(reinterpret_cast<const void*>(stacked_f32_kernel), smem);
    if (e != cudaSuccess) return (int)e;
    stacked_f32_kernel<<<blocks, kThreads, smem, s>>>(
        static_cast<const float*>(x), w, static_cast<float*>(out), g);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
