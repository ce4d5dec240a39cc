// float32 products on Hopper's tensor cores as 3xTF32 (TMA-fed wgmma),
// shared by mlp.cu (the float32 forward, K2/K3 and K12) and mlp_bwd.cu (the
// float32 backward's GELU product and dh, K8/K9), with the block shape of
// both sources' warp-specialised GEMMs and the helpers they share: the
// exact-erf GELU (and its derivative), the TF32 split, and the raise of a
// kernel's dynamic shared-memory limit.
//
// Every operand x of a product is stored as two TF32 planes, big = x
// rounded to TF32 and small = (x - big) rounded to TF32 (split_tf32), the
// small plane under the big one: (2 R, K) for R rows. A k step of 8 runs
// three TF32 wgmma into one fp32 accumulator, small A x big B, big A x
// small B, big A x big B; small x small (2^-22 of the product) is dropped.
// That is as accurate as fp32 FFMA (one TF32 pass is about 3e-4 off), the
// counterpart of the TPU kernels' Precision.HIGHEST, a multi-pass bf16
// product. TF32 wgmma reads K-major operands only: a matrix whose K runs
// down its columns enters as a transposed copy (split_kernel<true>).
//
// tf32_gemm_kernel is a persistent, warp-specialised block of two consumer
// warpgroups (64 rows each) and one producer thread, with an mbarrier ring
// of stages that each hold one 32-float k block (128 bytes, the 128-byte
// swizzle's row) of A's and B's two planes, on 128 x 64 tiles. The tensor
// cores do not round their fp32 sums to nearest: measured on the H100,
// accumulating the whole K in the wgmma accumulator left K9's dy 3.7e-5
// off at K = 4032 (the error grew with K), against 2.7e-6 for FFMA. So
// each k block's 12 wgmma go into a fresh partial (two, in turns, so that
// one is summed while the other's products run) and the partials are added
// into the tile's sums with fp32 adds. The epilogue is a template
// parameter (Tf32Epi):
// - F32: the sums to out (M, N);
// - GeluBwd (mlp_bwd.cu's product 2): two products a tile, a = h W1^T and
//   then dg = do W2 into two sums; g = GELU(a + b1) and da = dg GELU'(a +
//   b1); da's planes (and g and da whole for the token reductions in full
//   mode) and the column sums of da (db1);
// - GeluFwd (mlp.cu's product 1): g = GELU(a + b1), stored as g's planes,
//   the A operand of the next product.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "wgmma.cuh"

namespace {

constexpr size_t kSmemMax = 227 * 1024;
constexpr int kBM = 128;                 // rows a tile (64 a consumer)
constexpr int kBox = 64 * 128;           // bytes of a 64 x 128-byte box
constexpr int kHopperThreads = 384;      // 2 consumer + 1 producer group
constexpr int kConsumerWarps = 8;
constexpr float kInvSqrt2 = 0.70710678118654752f;
constexpr float kInvSqrt2Pi = 0.39894228040143268f;

// Raise a kernel's dynamic shared-memory limit to the most a block may
// have, once a kernel, not at every launch.
cudaError_t allow_smem(const void* kernel) {
  static const void* done[32];
  static int n_done = 0;
  for (int i = 0; i < n_done; ++i)
    if (done[i] == kernel) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemMax);
  if (e == cudaSuccess && n_done < 32) done[n_done++] = kernel;
  return e;
}

// the exact-erf GELU
__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.f + erff(v * kInvSqrt2));
}

// GELU of a = acc + bias, and gelu'(a) * dg
__device__ __forceinline__ void gelu_pair(float acc, float bias, float dg,
                                          float* g, float* da) {
  const float v = acc + bias;
  const float er = erff(v * kInvSqrt2);
  *g = 0.5f * v * (1.f + er);
  *da = dg * (0.5f * (1.f + er) + v * kInvSqrt2Pi * __expf(-0.5f * v * v));
}

// the sum over the 8 lanes that share lane & 3 (the rows of a warp's
// accumulator fragment)
__device__ __forceinline__ float rows_sum(float v) {
  for (int o = 4; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// x rounded to TF32 (round to nearest, ties away from zero), its low 13
// bits cleared (the PTX leaves them unspecified), and the split x = big +
// small of 3xTF32: small = (x - big) rounded to TF32 as well, so that no
// product depends on how the tensor cores treat an operand's low bits.
__device__ __forceinline__ float tf32_big(float x) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(u) : "f"(x));
  return __uint_as_float(u & 0xffffe000u);
}
__device__ __forceinline__ void split_tf32(float x, float* big,
                                           float* small) {
  const float b = tf32_big(x);
  *big = b;
  *small = tf32_big(x - b);
}

constexpr int kKf = 32;                 // floats of a k block (128 bytes)
constexpr int kBNf = 64;                // columns of a tile

enum class Tf32Epi { F32, GeluBwd, GeluFwd };

struct Tf32Args {
  int M, N;              // rows m < M (a multiple of kBM), columns n < N:
                         // the rows of A's and of B's big planes
  int kb;                // k blocks of each product
  int m_tiles, n_tiles;
  long long tiles;
  float* out;            // F32: (M, N)
  const float* b1;       // GeluBwd, GeluFwd: (N)
  float* vpart;          // GeluBwd: (2 m_tiles, N)
  float* planes;         // GeluBwd, GeluFwd: the output's planes (2 M, N),
                         // da's (GeluBwd) or g's (GeluFwd)
  float* g;              // GeluBwd, full mode: g and da whole (M, N); else
  float* da_full;        // null
};

// CS: the epilogue's column sums (GeluBwd)
template <bool CS> struct Tf32Cfg {
  static constexpr int BN = kBNf;
  static constexpr int kABytes = kBM * 128;      // one plane of A's k block
  static constexpr int kBBytes = BN * 128;
  static constexpr int kStageBytes = 2 * (kABytes + kBBytes);
  static constexpr size_t kCsBytes = CS ? 2 * 4 * BN * sizeof(float) : 0;
  static constexpr size_t kAvail =
      kSmemMax - 1024 - kCsBytes - 16 * sizeof(uint64_t);
  static constexpr int kStages =
      kAvail / kStageBytes > 6 ? 6 : (int)(kAvail / kStageBytes);
  static constexpr size_t kCs = (size_t)kStages * kStageBytes;
  static constexpr size_t kBar = kCs + kCsBytes;
  static constexpr size_t kSmem = 1024 + kBar + 2 * kStages * sizeof(uint64_t);
  static_assert(kStages >= 2 && kSmem <= kSmemMax, "fits a block");
};

// d (64 x kBNf) = one k block of A B^T as 3xTF32 (a = A's big plane, as
// its small one, likewise b and bs for B), 8 deep a step
__device__ __forceinline__ void mma_3xtf32(float* d, uint64_t a, uint64_t as,
                                           uint64_t b, uint64_t bs) {
#pragma unroll
  for (int kk = 0; kk < kKf / 8; ++kk) {
    wgmma::tf32<kBNf>(d, as + 2 * kk, b + 2 * kk, kk);
    wgmma::tf32<kBNf>(d, a + 2 * kk, bs + 2 * kk, 1);
    wgmma::tf32<kBNf>(d, a + 2 * kk, b + 2 * kk, 1);
  }
}

// d[i] += p[i], in fp32 (rounded to nearest)
template <int R>
__device__ __forceinline__ void add_into(float* d, const float* p) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] += p[i];
}

// GELU: two products a tile (GeluBwd)
template <Tf32Epi E, bool GELU = E == Tf32Epi::GeluBwd>
__global__ void __launch_bounds__(kHopperThreads, 1)
tf32_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b,
                 const __grid_constant__ CUtensorMap map_a2,
                 const __grid_constant__ CUtensorMap map_b2,
                 const Tf32Args gm) {
  constexpr int BN = kBNf, R = BN / 2;
  using L = Tf32Cfg<GELU>;
  constexpr int S = L::kStages;
  unsigned char* sm = smem_1k();
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* empty = full + S;
  const int n_kb = GELU ? 2 * gm.kb : gm.kb;     // k blocks of a tile

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {                      // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      int s = 0, ph = 0;
      for (long long tile = blockIdx.x; tile < gm.tiles; tile += gridDim.x) {
        const int mt = (int)(tile / gm.n_tiles);
        const int m0 = mt * kBM;
        const int n0 = (int)(tile - (long long)mt * gm.n_tiles) * BN;
        for (int kb = 0; kb < n_kb; ++kb) {
          const bool second = GELU && kb >= gm.kb;
          const CUtensorMap* ma = second ? &map_a2 : &map_a;
          const CUtensorMap* mb = second ? &map_b2 : &map_b;
          const int k = (second ? kb - gm.kb : kb) * kKf;
          mbar_wait(&empty[s], ph ^ 1);
          unsigned char* st = sm + s * L::kStageBytes;
          mbar_expect_tx(&full[s], L::kStageBytes);
          tma_load(st, ma, &full[s], k, m0);
          tma_load(st + L::kABytes, ma, &full[s], k, gm.M + m0);
          tma_load(st + 2 * L::kABytes, mb, &full[s], k, n0);
          tma_load(st + 2 * L::kABytes + L::kBBytes, mb, &full[s], k,
                   gm.N + n0);
          if (++s == S) { s = 0; ph ^= 1; }
        }
      }
    }
  } else {                                       // consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = threadIdx.x >> 7, wt = threadIdx.x & 127;
    const int lane = threadIdx.x & 31, warp = wt >> 5;
    const int r0 = warp * 16 + (lane >> 2), c0 = 2 * (lane & 3);
    int s = 0, ph = 0;
    for (long long tile = blockIdx.x; tile < gm.tiles; tile += gridDim.x) {
      const int mt = (int)(tile / gm.n_tiles);
      const int n0 = (int)(tile - (long long)mt * gm.n_tiles) * BN;
      const int m0 = mt * kBM + wg * 64;         // this warpgroup's rows
      wg_sync(wg);                     // the last tile's epilogue is done
      // sum (a, or dh) and sum2 (dg): the tile's fp32 sums; p0 and p1 the
      // partials of the even and odd k blocks
      float sum[R], sum2[GELU ? R : 1], p0[R], p1[R];
#pragma unroll
      for (int i = 0; i < R; ++i) sum[i] = 0.f;
      if constexpr (GELU) {
#pragma unroll
        for (int i = 0; i < R; ++i) sum2[i] = 0.f;
      }
      int prev = -1;
      // block kb's 12 wgmma into its partial p, from stage s
      const auto run_block = [&](float* p) {
        mbar_wait(&full[s], ph);
        const unsigned char* st = sm + s * L::kStageBytes;
        const uint64_t a = wgmma::desc_sw128(st + wg * kBox);
        const uint64_t as = wgmma::desc_sw128(st + L::kABytes + wg * kBox);
        const uint64_t b = wgmma::desc_sw128(st + 2 * L::kABytes);
        const uint64_t bs =
            wgmma::desc_sw128(st + 2 * L::kABytes + L::kBBytes);
        wgmma::fence();
        mma_3xtf32(p, a, as, b, bs);
        wgmma::commit();
      };
      // block kb's partial p, whose products are done, into its sum; its
      // stage back to the producer
      const auto promote = [&](float* p, int kb) {
        wgmma::fence_operands<R>(p);
        if (lane == 0) mbar_arrive(&empty[prev]);
        if constexpr (GELU) {
          if (kb >= gm.kb) {
            add_into<R>(sum2, p);
            return;
          }
        }
        add_into<R>(sum, p);
      };
      for (int kb = 0; kb < n_kb; kb += 2) {
        run_block(p0);
        wgmma::wait<1>();              // block kb - 1's products
        if (kb > 0) promote(p1, kb - 1);
        prev = s;
        if (++s == S) { s = 0; ph ^= 1; }
        if (kb + 1 == n_kb) break;
        run_block(p1);
        wgmma::wait<1>();              // block kb's products
        promote(p0, kb);
        prev = s;
        if (++s == S) { s = 0; ph ^= 1; }
      }
      wgmma::wait<0>();
      if (n_kb & 1)
        promote(p0, n_kb - 1);
      else
        promote(p1, n_kb - 1);

      // fragment layout: rows r0 and r0 + 8, n8 group j's columns
      // 8 j + c0 + {0, 1} in sum[4 j .. 4 j + 3]
      if constexpr (E == Tf32Epi::F32) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int n = n0 + 8 * j + c0;
          if (n >= gm.N) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const long long row = m0 + r0 + 8 * h;
            *reinterpret_cast<float2*>(gm.out + row * gm.N + n) =
                make_float2(sum[4 * j + 2 * h], sum[4 * j + 2 * h + 1]);
          }
        }
      } else if constexpr (E == Tf32Epi::GeluBwd) {
        float* cs = reinterpret_cast<float*>(sm + L::kCs) + wg * 4 * BN;
        const long long plane = (long long)gm.M * gm.N;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = 8 * j + c0, n = n0 + col;
          const bool in = n < gm.N;
          const float2 bb = in ? *reinterpret_cast<const float2*>(gm.b1 + n)
                               : make_float2(0.f, 0.f);
          float s0 = 0.f, s1 = 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * j + 2 * h;
            float g0, g1, d0, d1;
            gelu_pair(sum[i], bb.x, sum2[i], &g0, &d0);
            gelu_pair(sum[i + 1], bb.y, sum2[i + 1], &g1, &d1);
            if (in) {
              const long long o = (long long)(m0 + r0 + 8 * h) * gm.N + n;
              const float e0 = tf32_big(d0), e1 = tf32_big(d1);
              *reinterpret_cast<float2*>(gm.planes + o) = make_float2(e0, e1);
              *reinterpret_cast<float2*>(gm.planes + plane + o) =
                  make_float2(tf32_big(d0 - e0), tf32_big(d1 - e1));
              if (gm.g != nullptr) {
                *reinterpret_cast<float2*>(gm.g + o) = make_float2(g0, g1);
                *reinterpret_cast<float2*>(gm.da_full + o) =
                    make_float2(d0, d1);
              }
            }
            s0 += d0;
            s1 += d1;
          }
          s0 = rows_sum(s0);
          s1 = rows_sum(s1);
          if (lane < 4) {
            cs[warp * BN + col] = s0;
            cs[warp * BN + col + 1] = s1;
          }
        }
        wg_sync(wg);                   // every warp's column sums are in cs
        const int n = n0 + wt;
        if (wt < BN && n < gm.N)
          gm.vpart[(long long)(2 * mt + wg) * gm.N + n] =
              cs[wt] + cs[BN + wt] + cs[2 * BN + wt] + cs[3 * BN + wt];
      } else {                         // GeluFwd: g's planes
        const long long plane = (long long)gm.M * gm.N;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int n = n0 + 8 * j + c0;
          if (n >= gm.N) continue;
          const float2 bb = *reinterpret_cast<const float2*>(gm.b1 + n);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const long long o = (long long)(m0 + r0 + 8 * h) * gm.N + n;
            const float g0 = gelu(sum[4 * j + 2 * h] + bb.x);
            const float g1 = gelu(sum[4 * j + 2 * h + 1] + bb.y);
            const float e0 = tf32_big(g0), e1 = tf32_big(g1);
            *reinterpret_cast<float2*>(gm.planes + o) = make_float2(e0, e1);
            *reinterpret_cast<float2*>(gm.planes + plane + o) =
                make_float2(tf32_big(g0 - e0), tf32_big(g1 - e1));
          }
        }
      }
    }
  }
}

// m: the tensor maps of A's and B's planes (boxes of kKf columns x kBM
// rows and x kBNf rows), and of the second product's (GeluBwd; else
// unread).
template <Tf32Epi E>
cudaError_t run_tf32(const CUtensorMap* m, Tf32Args gm, int sms,
                     cudaStream_t stream) {
  const auto kernel = tf32_gemm_kernel<E>;
  const cudaError_t e = allow_smem(reinterpret_cast<const void*>(kernel));
  if (e != cudaSuccess) return e;
  gm.m_tiles = (gm.M + kBM - 1) / kBM;
  gm.n_tiles = (gm.N + kBNf - 1) / kBNf;
  gm.tiles = (long long)gm.m_tiles * gm.n_tiles;
  const int grid = (int)(gm.tiles < sms ? gm.tiles : sms);
  kernel<<<grid, kHopperThreads, Tf32Cfg<E == Tf32Epi::GeluBwd>::kSmem,
           stream>>>(m[0], m[1], m[2], m[3], gm);
  return cudaGetLastError();
}

// The big and small TF32 planes of a (rows, cols) fp32 matrix, or of its
// transpose (TRANS): dst (2 rows, cols) or (2 cols, rows), big rows first;
// 32 x 32 tiles, through shared memory when transposed.
template <bool TRANS>
__global__ void __launch_bounds__(256)
split_kernel(const float* __restrict__ src, float* __restrict__ dst,
             int rows, int cols) {
  __shared__ float tile[32][33];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int c0 = blockIdx.x * 32, r0 = blockIdx.y * 32;
  const long long plane = (long long)rows * cols;
  for (int i = w; i < 32; i += 8) {
    const int r = r0 + i, c = c0 + lane;
    const bool in = r < rows && c < cols;
    const float v = in ? src[(long long)r * cols + c] : 0.f;
    if constexpr (TRANS) {
      tile[i][lane] = v;
    } else if (in) {
      const long long o = (long long)r * cols + c;
      split_tf32(v, dst + o, dst + plane + o);
    }
  }
  if constexpr (TRANS) {
    __syncthreads();
    for (int i = w; i < 32; i += 8) {
      const int r = c0 + i, c = r0 + lane;       // dst is (cols, rows)
      if (r < cols && c < rows) {
        const long long o = (long long)r * rows + c;
        split_tf32(tile[lane][i], dst + o, dst + plane + o);
      }
    }
  }
}

cudaError_t split(const void* src, float* dst, int rows, int cols,
                  bool trans, cudaStream_t s) {
  const dim3 grid((cols + 31) / 32, (rows + 31) / 32);
  const float* x = static_cast<const float*>(src);
  if (trans)
    split_kernel<true><<<grid, 256, 0, s>>>(x, dst, rows, cols);
  else
    split_kernel<false><<<grid, 256, 0, s>>>(x, dst, rows, cols);
  return cudaGetLastError();
}

}  // namespace
