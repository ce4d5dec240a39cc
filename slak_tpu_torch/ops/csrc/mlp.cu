// Fused ConvNeXt block tail:
//   out = res + gamma * (GELU(LN(y + pre_bias) @ W1 + b1) @ W2 + b2)
// with fp32 LayerNorm statistics, h and g rounded to the compute dtype
// before each product, and fp32 accumulation.
//
// Replaces slak_tpu/ops/pallas_mlp.py: _mlp_fused_2d (_mlp_kernel, the
// tokens-major fused_mlp), _mlp_cmajor_2d (_mlp_cmajor_kernel, the
// channel-major fused_mlp_cmajor) and, as slak_fused_mlp_dual (K12),
// fused_mlp_cmajor_dual_raw. One family covers all three and the NCHW
// layout of this port: the activation is addressed through strides,
// element (token t, channel c) at n*sN + c*sC + p*sP with t = n*P + p.
//
// The TPU kernel keeps both weight matrices resident in VMEM. An SM has
// 227 KB of shared memory and stage 4's weights alone are 15.9 MB in bf16,
// so here the weights stream from global memory (and the 50 MB L2, where
// every block of a launch reads the same matrices). W1 and W2 are repacked
// once per model by the wrapper (ops/mlp.py) transposed, as nn.Linear
// stores them: W1^T (Fp, Cp) and W2^T (Cp, Fp), zero-padded to Cp = C
// rounded up to 16 and Fp = 4C rounded up to 64, so that each product's B
// operand is K-major; the ragged C of the activations is masked on load
// and store.
//
// Routes, by dtype and width:
// - bf16: a LayerNorm launch (ln_bf16_kernel) writes h = LN(y + pre_bias)
//   into a bf16 workspace, tokens-major; then
//   - Cp <= 256 (mlp_fused_kernel): the rest of the tail in one
//     persistent, warp-specialised kernel; TMA brings the tile's h and
//     each hidden chunk's W1^T rows and W2^T columns, wgmma computes both
//     products, and the chunk's GELU output feeds product 2 from
//     registers, so g never leaves the SM;
//   - wider (stages 3-4): one TMA + wgmma GEMM kernel twice, g = GELU(h
//     W1^T^T + b1) into the workspace, then the residual epilogue from
//     g W2^T^T. A 128-token fp32 accumulator of Cp = 1008 channels does
//     not fit a block.
// - float32 (the differentiated eval's ERF path): both products as
//   3xTF32 on the tensor cores (tf32_gemm.cuh: each operand split into big
//   and small TF32 planes, three TF32 wgmma a k step, two-level fp32 sums),
//   as accurate as fp32 FFMA, the counterpart of the JAX kernels'
//   Precision.HIGHEST. The LayerNorm launch writes h's planes, the first
//   product's epilogue g's, the second product's os, then the residual
//   epilogue through the strides (see the float32 section). g makes one
//   round trip through device memory at every width, as two planes (2 x
//   268 MB at the ERF's stage 1); keeping it on chip, as bf16 does up to
//   Cp = 256, is a later design.
//
// What bounds it on an H100: the two products, 4*T*C*4C operations, at
// 989 TFLOP/s dense bf16 at best, and in float32 at three TF32 passes at
// 495 TFLOP/s (2.6x the 67 TFLOP/s of FFMA); the bytes (y, res, out and
// the two weight matrices once) take far less. wgmma is the only way to
// that rate: a warpgroup's asynchronous products from shared memory (and
// registers), fed by TMA so that no thread spends instructions on the
// weight copies. What the kernels do not yet hide is CUDA-core work: T*4C
// exact-erf GELUs (~26 instructions each, the fused kernel's main loop at
// C <= 256; in float32 also the TF32 split of g) and the epilogues'
// residual loads and stores; in float32 also g's planes, 8 T 4C bytes
// each way.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "hopper.cuh"
#include "tf32_gemm.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr float kLnEps = 1e-6f;

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

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Args {
  const void* y;
  const void* res;
  void* out;
  const void* w1;      // W1^T (Fp, Cp) compute dtype
  const void* w2;      // W2^T (Cp, Fp) compute dtype
  const float* b1;     // (Fp)
  const float* vec;    // (5, C): ln_scale, ln_bias, b2, gamma, pre_bias
  long long n_outer;   // tokens = n_outer * P
  long long P;
  long long sN, sC, sP;
  int C, Cp, Fp;
  int BT;              // tokens a block of the per-token kernels
  int add_residual;
};

// K12 (the dual tail): y2 and outq in the q orientation (N, C, W, H) of an
// NCHW activation (qW = W, qH = H), and q_off, the byte offset in dynamic
// shared memory of the tile's q token offsets (n*sN + w*H + h). The
// kernels take Args (K2/K3) or DualArgs (K12) as a template type.
struct DualArgs : Args {
  const void* y2;
  void* outq;
  int qW, qH;
  int q_off;
};

template <typename A>
constexpr bool kDual = std::is_same<A, DualArgs>::value;

__device__ __forceinline__ long long* q_tokens(const DualArgs& a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  return reinterpret_cast<long long*>(smem_raw + a.q_off);
}

// Each token's offset in global memory (n*sN + p*sP; -1 past the end),
// computed once a tile: tok[BT] (and K12's q offsets).
template <typename A>
__device__ void token_offsets(const A& a, long long t0, long long* tok) {
  const long long T_total = a.n_outer * a.P;
  for (int t = threadIdx.x; t < a.BT; t += kThreads) {
    const long long tg = t0 + t;
    long long off = -1;
    if (tg < T_total) {
      const long long n = tg / a.P;
      off = n * a.sN + (tg - n * a.P) * a.sP;
    }
    tok[t] = off;
    if constexpr (kDual<A>) {
      long long q = -1;
      if (tg < T_total) {
        const long long n = tg / a.P;
        const int p = (int)(tg - n * a.P), h = p / a.qW;
        q = n * a.sN + (long long)(p - h * a.qW) * a.qH + h;
      }
      q_tokens(a)[t] = q;
    }
  }
  __syncthreads();
}

// Walk the tile's (token, channel) elements, neighbouring lanes on
// neighbouring addresses: along C when it is the unit stride (tokens-major:
// a warp a token), else along the tokens (a lane a token, a warp a
// channel). Each thread takes its elements U at a time: first U loads
// (load(offset), offset -1 outside the real extent), all in flight
// together, then use(t, c, offset, loaded value) for each.
template <int U, typename A, typename Load, typename Use>
__device__ __forceinline__ void for_tile(const A& a, const long long* tok,
                                         Load load, Use use) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (a.sC != 1) {
    for (int t = lane; t < a.BT; t += 32) {
      const long long base = tok[t];
      for (int c0 = warp; c0 < a.Cp; c0 += kWarps * U) {
        long long off[U];
        float v[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int c = c0 + kWarps * u;
          off[u] = base >= 0 && c < a.C ? base + c * a.sC : -1;
          v[u] = load(off[u]);
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (c0 + kWarps * u < a.Cp) use(t, c0 + kWarps * u, off[u], v[u]);
      }
    }
  } else {
    for (int t = warp; t < a.BT; t += kWarps) {
      const long long base = tok[t];
      for (int c0 = lane; c0 < a.Cp; c0 += 32 * U) {
        long long off[U];
        float v[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int c = c0 + 32 * u;
          off[u] = base >= 0 && c < a.C ? base + c : -1;
          v[u] = load(off[u]);
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (c0 + 32 * u < a.Cp) use(t, c0 + 32 * u, off[u], v[u]);
      }
    }
  }
}

// stage <- y + pre_bias (fp32, zero outside the tile, row pitch LDS);
// then store(t, c, h) with h = LN(stage) for each of the tile's tokens t
// and channels c < Cp (0 past C), neighbouring lanes on neighbouring c.
// The LayerNorm runs a warp per token, R tokens of a warp at once. K12: y
// = y1 + y2^T in the compute dtype, y2 read in the q orientation (strided
// by H along the tokens).
template <typename T, typename A, typename Store>
__device__ void load_layernorm(const A& a, const long long* tok,
                               float* stage, int LDS, Store store) {
  constexpr int R = 4;
  const T* __restrict__ y = static_cast<const T*>(a.y);
  const float* __restrict__ ln_s = a.vec;
  const float* __restrict__ ln_b = a.vec + a.C;
  const float* __restrict__ pre = a.vec + 4 * a.C;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for_tile<8>(
      a, tok,
      [&](long long off) { return off >= 0 ? to_f<T>(y[off]) : 0.f; },
      [&](int t, int c, long long off, float v) {
        if constexpr (kDual<A>) {
          const T* y2 = static_cast<const T*>(a.y2);
          if (off >= 0)
            v = to_f<T>(from_f<T>(v + to_f<T>(y2[q_tokens(a)[t] +
                                                 c * a.sC])));
        }
        stage[t * LDS + c] = off >= 0 ? v + pre[c] : 0.f;
      });
  __syncthreads();
  for (int t0 = warp * R; t0 < a.BT; t0 += kWarps * R) {   // BT % 16 == 0
    float mean[R], inv[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float s = 0.f;
      for (int c = lane; c < a.C; c += 32) s += stage[(t0 + r) * LDS + c];
      mean[r] = s;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) mean[r] = warp_sum(mean[r]) / a.C;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float q = 0.f;
      for (int c = lane; c < a.C; c += 32) {
        const float d = stage[(t0 + r) * LDS + c] - mean[r];
        q += d * d;
      }
      inv[r] = q;
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      inv[r] = rsqrtf(warp_sum(inv[r]) / a.C + kLnEps);
    for (int c = lane; c < a.Cp; c += 32) {
      const float sc = c < a.C ? ln_s[c] : 0.f;
      const float bi = c < a.C ? ln_b[c] : 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r)
        store(t0 + r, c,
              c < a.C
                  ? (stage[(t0 + r) * LDS + c] - mean[r]) * inv[r] * sc + bi
                  : 0.f);
    }
  }
  __syncthreads();
}

// out <- res + gamma * (acc + b2) over the tile's real extent; K12 with
// a non-null a.outq also writes the same values in the q orientation.
template <typename T, typename A>
__device__ void store_out(const A& a, const long long* tok,
                          const float* acc, int LDA) {
  const T* __restrict__ res = static_cast<const T*>(a.res);
  T* __restrict__ out = static_cast<T*>(a.out);
  const float* __restrict__ b2 = a.vec + 2 * a.C;
  const float* __restrict__ gamma = a.vec + 3 * a.C;
  for_tile<8>(
      a, tok,
      [&](long long off) {
        return off >= 0 && a.add_residual ? to_f<T>(res[off]) : 0.f;
      },
      [&](int t, int c, long long off, float r) {
        if (off >= 0)
          out[off] = from_f<T>(r + (acc[t * LDA + c] + b2[c]) * gamma[c]);
        if constexpr (kDual<A>) {
          T* outq = static_cast<T*>(a.outq);
          if (off >= 0 && outq != nullptr)
            outq[q_tokens(a)[t] + c * a.sC] =
                from_f<T>(r + (acc[t * LDA + c] + b2[c]) * gamma[c]);
        }
      });
}

// ---------------------------------------------------------------------------
// float32: the products as 3xTF32 on the tensor cores (tf32_gemm.cuh's
// TMA-fed wgmma, two-level fp32 sums), in six launches over the f32
// workspace, the tokens padded to Tp (a multiple of kBM):
//  1. split_kernel, twice: the big and small TF32 planes of W1^T (2 Fp,
//     Cp) and W2^T (2 Cp, Fp), each already K-major for its product;
//  2. simt_ln_kernel, kSimtBT tokens a block: y + pre_bias (K12: y1 +
//     y2^T), the LayerNorm, h stored as its planes (2 Tp, Cp), 0 past C
//     and on padded tokens;
//  3. tf32_gemm_kernel<GeluFwd>: g = GELU(h W1^T^T + b1), exact erf,
//     stored as its planes (2 Tp, Fp) by the epilogue;
//  4. tf32_gemm_kernel<F32>: os (Tp, Cp) = g W2^T^T;
//  5. simt_out_kernel, kSimtBT tokens a block: out = res + gamma (os + b2)
//     through the strides (K12: and outq).
// ---------------------------------------------------------------------------

constexpr int kSimtBT = 32;                   // tokens a per-token block

struct F32Layout {
  size_t h, g, os, w1, w2, total;
};

inline F32Layout f32_layout(long long Tp, int Cp, int Fp) {
  auto al = [](size_t n) { return (n + 255) / 256 * 256; };
  const size_t tp = (size_t)Tp, cp = (size_t)Cp, fp = (size_t)Fp;
  const size_t f = sizeof(float);
  F32Layout L;
  L.h = 0;
  L.g = L.h + al(2 * tp * cp * f);
  L.os = L.g + al(2 * tp * fp * f);
  L.w1 = L.os + al(tp * cp * f);
  L.w2 = L.w1 + al(2 * fp * cp * f);
  L.total = L.w2 + al(2 * cp * fp * f);
  return L;
}

size_t smem_simt_tile(int Cp) {
  return (size_t)kSimtBT * (Cp + 1) * sizeof(float) +
         kSimtBT * sizeof(long long);
}

// hp: h's planes (2 Tp, Cp), big rows first
template <typename A>
__global__ void __launch_bounds__(kThreads)
simt_ln_kernel(A a, float* __restrict__ hp, long long Tp) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int LDS = a.Cp + 1;
  float* stage = reinterpret_cast<float*>(smem_raw);
  long long* tok = reinterpret_cast<long long*>(stage + kSimtBT * LDS);
  const long long t0 = (long long)blockIdx.x * kSimtBT;
  const long long plane = Tp * a.Cp;
  token_offsets(a, t0, tok);
  load_layernorm<float>(a, tok, stage, LDS, [&](int t, int c, float v) {
    const long long o = (t0 + t) * a.Cp + c;
    split_tf32(tok[t] >= 0 ? v : 0.f, hp + o, hp + plane + o);
  });
}

template <typename A>
__global__ void __launch_bounds__(kThreads)
simt_out_kernel(A a, const float* __restrict__ os) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int Cp = a.Cp, LDA = Cp + 1;
  float* acc = reinterpret_cast<float*>(smem_raw);
  long long* tok = reinterpret_cast<long long*>(acc + kSimtBT * LDA);
  const long long t0 = (long long)blockIdx.x * kSimtBT;
  token_offsets(a, t0, tok);
  for (int i = threadIdx.x; i < kSimtBT * Cp; i += kThreads) {
    const int t = i / Cp, c = i - t * Cp;
    acc[t * LDA + c] = os[(t0 + t) * Cp + c];
  }
  __syncthreads();
  store_out<float>(a, tok, acc, LDA);
}

// ---------------------------------------------------------------------------
// bf16, Hopper tensor cores: TMA-fed wgmma.
//
// Both products run as wgmma.mma_async on tiles that TMA
// (cp.async.bulk.tensor) brings into shared memory in the 128-byte swizzle,
// behind a ring of mbarrier pairs (full: the bytes landed; empty: every
// consumer warp is done with the stage). A block is three warpgroups:
// warpgroups 0 and 1 consume (64 tokens each, the accumulators in
// registers, setmaxnreg 232), one thread of warpgroup 2 produces (the TMA
// loads, setmaxnreg 40). Blocks are persistent: one a SM, walking tiles
// blockIdx.x, + gridDim.x, ..., so the producer loads the next tile's
// operands while the consumers finish this one. Weights are read through
// tensor maps of the packed W1^T (Fp, Cp) and W2^T (Cp, Fp); TMA's
// out-of-bounds zero fill pads a K of Cp = 1008 to the 64-wide box.
// ---------------------------------------------------------------------------

constexpr int kBK = 64;                  // K of a TMA box (128 bytes)

// Token t's offset n*sN + p*sP (-1 past the end); K12 also its offset in
// the q orientation, n*sN + w*H + h.
template <typename A>
__device__ __forceinline__ long long token_offset(const A& a, long long t,
                                                  long long* q) {
  *q = -1;
  if (t >= a.n_outer * a.P) return -1;
  const long long n = t / a.P, p = t - n * a.P;
  if constexpr (kDual<A>) {
    const int h = (int)p / a.qW;
    *q = n * a.sN + (long long)((int)p - h * a.qW) * a.qH + h;
  }
  return n * a.sN + p * a.sP;
}

// ---- the consumers' residual epilogue ---------------------------------------
//
// A consumer warpgroup's 64 x (8 NJ) accumulator tile sits in wgmma's
// fragment layout: warp w holds rows 16 w + lane / 4 and + 8, n8 group j
// columns 8 j + 2 (lane % 4) + {0, 1}, in acc[4 j .. 4 j + 3]. Stored from
// there, a warp would write 8 rows x 4 columns of 2 bytes. So the epilogue
// goes in passes of kEpiCols columns: gamma (acc + b2) into the
// warpgroup's fp32 staging tile [64][kEpiCols + 1], then out = res + that
// with neighbouring lanes on neighbouring addresses -- down the rows
// (tokens) where those are contiguous in memory (NCHW, (C, M)), else along
// the columns -- through a ResidualSink (a pass's residual loads of a
// thread are in flight together). b2 and gamma of the tile's columns come
// from shared memory.

constexpr int kEpiCols = 32;                       // columns a pass
constexpr int kEpiLd = kEpiCols + 1;               // rows on 32 banks
constexpr int kStageFloats = 64 * kEpiLd;          // a consumer's staging
constexpr int kEpiPer = 64 * kEpiCols / 128;       // elements a thread a pass

// A consumer warpgroup's residual tile (64 tokens x NP channels, bf16) in
// its half of the fused kernel's h buffer: channel c's 64 tokens at
// [c / 64][wg half][c % 64][64] (the h buffer's k-blocks are 128 rows of
// 128 bytes, the warpgroup's 64 rows one 8 KB half).
__device__ __forceinline__ int res_at(int row, int c) {
  return (c >> 6) * (kBM * 64) + (c & 63) * 64 + row;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

// Start the copies of the warpgroup's residual tile into rsm (res_at),
// token pairs as 4-byte cp.async: the caller checked that pairs are
// contiguous and 4-byte aligned (tokens contiguous, P and the tile start
// even). Completes at cp_async_wait_all.
template <typename A>
__device__ __forceinline__ void prefetch_residual(const A& a,
                                                  const long long* tok,
                                                  bf16* rsm) {
  const bf16* res = static_cast<const bf16*>(a.res);
  const int wt = threadIdx.x & 127;
  for (int i = wt; i < 32 * a.C; i += 128) {
    const int r = 2 * (i & 31), c = i >> 5;
    const long long o = tok[r];
    if (o >= 0) cp_async4(rsm + res_at(r, c), res + o + c * a.sC);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The residual epilogue's loads and stores at channel c0 + c: res from
// device memory through the strides, or from rsm (prefetch_residual);
// out <- res + v through the strides, rows by the warpgroup's token
// offsets tok (K12: and outq at qtok).
template <typename A> struct ResidualSink {
  const bf16* res;
  bf16* out;
  bf16* outq;
  const long long* tok;
  const long long* qtok;
  long long sC;
  int C, c0, add_residual;
  const bf16* rsm;     // the residual already in shared memory, or null
  __device__ __forceinline__ float load(int row, int c) const {
    c += c0;
    if (rsm != nullptr) return c < C ? to_f<bf16>(rsm[res_at(row, c)]) : 0.f;
    const long long o = tok[row];
    return o >= 0 && c < C && add_residual ? to_f<bf16>(res[o + c * sC])
                                           : 0.f;
  }
  __device__ __forceinline__ void put(int row, int c, float v) const {
    c += c0;
    const long long o = tok[row];
    if (o < 0 || c >= C) return;
    const bf16 x = from_f<bf16>(v);
    out[o + c * sC] = x;
    if constexpr (kDual<A>)
      if (outq != nullptr) outq[qtok[row] + c * sC] = x;
  }
};

template <typename A>
__device__ __forceinline__ ResidualSink<A> residual_sink(
    const A& a, const long long* tok, const long long* qtok, int c0,
    const bf16* rsm = nullptr) {
  bf16* outq = nullptr;
  if constexpr (kDual<A>) outq = static_cast<bf16*>(a.outq);
  return ResidualSink<A>{static_cast<const bf16*>(a.res),
                         static_cast<bf16*>(a.out), outq, tok, qtok, a.sC,
                         a.C, c0, a.add_residual, rsm};
}

template <int NJ, typename A>
__device__ __forceinline__ void residual_epilogue(const float* acc,
                                                  float* stg, int wg,
                                                  int ncols,
                                                  const float* b2,
                                                  const float* gamma,
                                                  bool rows_contig,
                                                  const ResidualSink<A>& sink) {
  constexpr int kPasses = NJ * 8 / kEpiCols;
  const int wt = threadIdx.x & 127, lane = wt & 31, warp = wt >> 5;
  const int r0 = warp * 16 + (lane >> 2), c0 = 2 * (lane & 3);
  // the read side: rows_contig, row wt % 64 and columns wt / 64 + 2 k;
  // else column lane and rows warp + 4 k
  const int row0 = rows_contig ? wt & 63 : warp;
  const int col0 = rows_contig ? wt >> 6 : lane;
  const int drow = rows_contig ? 0 : 4, dcol = rows_contig ? 2 : 0;
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    if (p * kEpiCols >= ncols) break;
    float r[kEpiPer];
#pragma unroll
    for (int k = 0; k < kEpiPer; ++k)
      r[k] = sink.load(row0 + k * drow, p * kEpiCols + col0 + k * dcol);
    wg_sync(wg);
#pragma unroll
    for (int j = 0; j < kEpiCols / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + c0 + e, c = p * kEpiCols + col;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          stg[(r0 + 8 * h) * kEpiLd + col] =
              (acc[4 * (p * kEpiCols / 8 + j) + 2 * h + e] + b2[c]) * gamma[c];
      }
    wg_sync(wg);
#pragma unroll
    for (int k = 0; k < kEpiPer; ++k) {
      const int row = row0 + k * drow, col = col0 + k * dcol;
      sink.put(row, p * kEpiCols + col, stg[row * kEpiLd + col] + r[k]);
    }
  }
}

// The first GEMM's epilogue: g (row-major) <- bf16(GELU(acc + b1)) for
// the warpgroup's 64 x (8 NJ) tile at (row m0, column n0), in passes of 32
// columns: the thread's fragment values, GELU'd and rounded, into a bf16
// [64][32] tile in shared memory (two, alternating), then one TMA store
// of the tile (map_g: boxes of 32 columns x 64 rows; it clips rows past M
// and columns past N). b1: the tile's columns of b1 in shared memory.
template <int NJ>
__device__ __forceinline__ void gelu_epilogue(const float* acc, bf16* gst,
                                              int wg, int ncols,
                                              const float* b1,
                                              const CUtensorMap* map_g,
                                              int n0, long long m0) {
  constexpr int kPasses = NJ * 8 / 32;
  const int wt = threadIdx.x & 127, lane = wt & 31, warp = wt >> 5;
  const int r0 = warp * 16 + (lane >> 2), c0 = 2 * (lane & 3);
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    if (p * 32 >= ncols) continue;
    bf16* buf = gst + (p & 1) * 64 * 32;
    if (p >= 2) {                      // the store of pass p - 2 read buf
      if (wt == 0) bulk_wait_read<1>();
      wg_sync(wg);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 8 * j + c0;
      const float2 bb = *reinterpret_cast<const float2*>(b1 + p * 32 + col);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* v = acc + 4 * (p * 4 + j) + 2 * h;
        *reinterpret_cast<uint32_t*>(buf + (r0 + 8 * h) * 32 + col) =
            pack_bf16x2(gelu(v[0] + bb.x), gelu(v[1] + bb.y));
      }
    }
    fence_async_smem();
    wg_sync(wg);
    if (wt == 0) {
      tma_store(map_g, buf, n0 + p * 32, m0);
      bulk_commit();
    }
  }
  if (wt == 0) bulk_wait_read<0>();    // buf free for the next tile
}

// ---- C <= 256: the fused kernel --------------------------------------------
//
// The tail after the LayerNorm in one pass; the 4C-wide hidden activations
// stay on chip. The producer TMA-loads each tile's h (128 tokens x Cp, from
// ln_bf16_kernel) once, and for each chunk of kFC hidden units the chunk's
// W1^T rows and W2^T columns, each into a ring of kStages. A consumer
// warpgroup owns 64 of the tokens; its batch ch of products is product 2
// of chunk ch - 1 and product 1 of chunk ch:
//   a = h W1_chunk^T (wgmma m64n64k16, A and B from shared memory);
//   acc += g W2_chunk (wgmma m64nNPk16, A from registers: the m64n64
//   accumulator layout is the A-fragment layout);
// after which a + b1 goes through the exact-erf GELU, rounded to bf16 and
// packed as the next batch's g. Then out = res + gamma (acc + b2) through
// the strides (residual_epilogue); where token pairs are contiguous
// (NCHW, (C, M) at an even map size) the warpgroup first copies its
// residual tile into its half of h with cp.async, which takes the
// epilogue's wait for device memory off the critical path. A W1 stage is
// free after its batch, a W2 stage one batch later, so the two rings let
// the producer run two batches ahead at NP = 256 as well. NP = Cp rounded up to 128 or 256
// (product 2's N); KB = the 64-wide k-blocks of Cp. Shared memory:
// h [NP / 64][128][64] | W1 ring [kStages][NP / 64][64][64] | W2 ring
// [kStages][NP][64] | staging [2][64][33] fp32 | token and q offsets
// [2][2][64] | b1 [4 NP] | b2, gamma [2][NP] | barriers.
// ---------------------------------------------------------------------------

constexpr int kFC = 64;                  // hidden units a chunk
constexpr int kHBox = kBM * 128;         // h: a 64-wide k-block of a tile

template <int NP> struct Fused {
  static constexpr int kKB = NP / 64;
  static constexpr int kStages = NP > 128 ? 2 : 4;
  static constexpr int kW1Bytes = kKB * kBox;         // kFC rows of W1^T
  static constexpr int kW2Bytes = NP * 128;           // NP rows of W2^T
  static constexpr size_t kRing1 = (size_t)kKB * kHBox;
  static constexpr size_t kRing2 = kRing1 + (size_t)kStages * kW1Bytes;
  static constexpr size_t kStg = kRing2 + (size_t)kStages * kW2Bytes;
  static constexpr size_t kTok = kStg + 2 * kStageFloats * sizeof(float);
  static constexpr size_t kB1 = kTok + 4 * 64 * sizeof(long long);
  static constexpr size_t kCv = kB1 + 4 * NP * sizeof(float);
  static constexpr size_t kBar = kCv + 2 * NP * sizeof(float);
  static constexpr size_t kSmem =
      1024 + kBar + (4 * kStages + 2) * sizeof(uint64_t);
  static_assert(kSmem <= kSmemMax, "fits a block's shared memory");
};

template <int NP, typename A>
__global__ void __launch_bounds__(kHopperThreads, 1)
mlp_fused_kernel(const __grid_constant__ CUtensorMap map_h,
                 const __grid_constant__ CUtensorMap map_w1,
                 const __grid_constant__ CUtensorMap map_w2, const A a) {
  using L = Fused<NP>;
  constexpr int S = L::kStages;
  unsigned char* sm = smem_1k();
  uint64_t* full1 = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* empty1 = full1 + S;
  uint64_t* full2 = empty1 + S;
  uint64_t* empty2 = full2 + S;
  uint64_t* hfull = empty2 + S;
  uint64_t* hempty = hfull + 1;
  const long long T = a.n_outer * a.P;
  const int n_tiles = (int)((T + kBM - 1) / kBM);
  const int KB = (a.Cp + 63) / 64, n_chunks = a.Fp / kFC;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full1[s], 1);
      mbar_init(&empty1[s], kConsumerWarps);
      mbar_init(&full2[s], 1);
      mbar_init(&empty2[s], kConsumerWarps);
    }
    mbar_init(hfull, 1);
    mbar_init(hempty, kConsumerWarps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {                      // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      int s1 = 0, ph1 = 0, s2 = 0, ph2 = 0, hph = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        mbar_wait(hempty, hph ^ 1);
        mbar_expect_tx(hfull, KB * kHBox);
        for (int kb = 0; kb < KB; ++kb)
          tma_load(sm + kb * kHBox, &map_h, hfull, kb * kBK, tile * kBM);
        hph ^= 1;
        for (int ch = 0; ch < n_chunks; ++ch) {
          mbar_wait(&empty1[s1], ph1 ^ 1);
          unsigned char* w1 = sm + L::kRing1 + s1 * L::kW1Bytes;
          mbar_expect_tx(&full1[s1], KB * kBox);
          for (int kb = 0; kb < KB; ++kb)
            tma_load(w1 + kb * kBox, &map_w1, &full1[s1], kb * kBK,
                     ch * kFC);
          if (++s1 == S) { s1 = 0; ph1 ^= 1; }
          mbar_wait(&empty2[s2], ph2 ^ 1);
          mbar_expect_tx(&full2[s2], L::kW2Bytes);
          tma_load(sm + L::kRing2 + s2 * L::kW2Bytes, &map_w2, &full2[s2],
                   ch * kFC, 0);
          if (++s2 == S) { s2 = 0; ph2 ^= 1; }
        }
      }
    }
  } else {                                       // consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = threadIdx.x >> 7, wt = threadIdx.x & 127;
    const int lane = threadIdx.x & 31;
    float* stg = reinterpret_cast<float*>(sm + L::kStg) + wg * kStageFloats;
    long long* tok = reinterpret_cast<long long*>(sm + L::kTok) + wg * 128;
    long long* qtok = tok + 64;
    float* b1s = reinterpret_cast<float*>(sm + L::kB1);
    float* cv = reinterpret_cast<float*>(sm + L::kCv);
    for (int i = threadIdx.x; i < a.Fp; i += 256) b1s[i] = a.b1[i];
    for (int i = threadIdx.x; i < NP; i += 256) {
      cv[i] = i < a.C ? a.vec[2 * a.C + i] : 0.f;
      cv[NP + i] = i < a.C ? a.vec[3 * a.C + i] : 0.f;
    }
    asm volatile("bar.sync 3, 256;\n" ::: "memory");   // both consumers
    const uint64_t h_desc = wgmma::desc_sw128(sm + wg * (kHBox / 2));
    int s1 = 0, ph1 = 0, s2 = 0, ph2 = 0, hph = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      wg_sync(wg);                     // the last tile's epilogue is done
      if (wt < 64)
        tok[wt] = token_offset(a, (long long)tile * kBM + wg * 64 + wt,
                               &qtok[wt]);
      float acc[NP / 2], a1[kFC / 2];
      uint32_t g[4][4];
#pragma unroll
      for (int i = 0; i < NP / 2; ++i) acc[i] = 0.f;
      mbar_wait(hfull, hph);
      hph ^= 1;
      for (int ch = 0; ch <= n_chunks; ++ch) {
        const bool p1 = ch < n_chunks, p2 = ch > 0;
        if (p2) mbar_wait(&full2[s2], ph2);
        if (p1) mbar_wait(&full1[s1], ph1);
        wgmma::fence();
        if (p2) {
          const uint64_t dw2 =
              wgmma::desc_sw128(sm + L::kRing2 + s2 * L::kW2Bytes);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) wgmma::rs<NP>(acc, g[kk], dw2 + 2 * kk, 1);
        }
        if (p1) {
          const unsigned char* w1 = sm + L::kRing1 + s1 * L::kW1Bytes;
          for (int kb = 0; kb < KB; ++kb) {
            const uint64_t da = h_desc + kb * (kHBox >> 4);
            const uint64_t db = wgmma::desc_sw128(w1 + kb * kBox);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma::ss<kFC>(a1, da + 2 * kk, db + 2 * kk, kb | kk);
          }
        }
        wgmma::commit();
        wgmma::wait<0>();
        wgmma::fence_operands<kFC / 2>(a1);
        wgmma::fence_operands<NP / 2>(acc);
        if (p2) {
          if (lane == 0) mbar_arrive(&empty2[s2]);
          if (++s2 == S) { s2 = 0; ph2 ^= 1; }
        }
        if (!p1) break;
        if (lane == 0) mbar_arrive(&empty1[s1]);
        if (++s1 == S) { s1 = 0; ph1 ^= 1; }
        // + b1, GELU, bf16: the A fragments of the next product 2
        const float* b1 = b1s + ch * kFC + 2 * (lane & 3);
#pragma unroll
        for (int j = 0; j < kFC / 8; ++j) {
          const float2 bb = *reinterpret_cast<const float2*>(b1 + 8 * j);
          g[j >> 1][(j & 1) * 2] =
              pack_bf16x2(gelu(a1[4 * j] + bb.x), gelu(a1[4 * j + 1] + bb.y));
          g[j >> 1][(j & 1) * 2 + 1] = pack_bf16x2(
              gelu(a1[4 * j + 2] + bb.x), gelu(a1[4 * j + 3] + bb.y));
        }
      }
      // the residual into this warpgroup's half of h (its products are
      // done), where token pairs are contiguous: the NCHW and (C, M) main
      // path at an even map size
      bf16* rsm = nullptr;
      if (a.add_residual && a.sP == 1 && a.sC % 2 == 0 && a.P % 2 == 0) {
        rsm = reinterpret_cast<bf16*>(sm + wg * (kHBox / 2));
        wg_sync(wg);                   // tok of every row is written
        prefetch_residual(a, tok, rsm);
        cp_async_wait_all();
        wg_sync(wg);                   // every thread's copies landed
      }
      residual_epilogue<NP / 8>(acc, stg, wg, a.C, cv, cv + NP, a.sC != 1,
                                residual_sink(a, tok, qtok, 0, rsm));
      if (lane == 0) mbar_arrive(hempty);
    }
  }
}

// ---- C > 256: two GEMMs on the bf16 workspace ------------------------------
//
// A 128 x Cp fp32 accumulator does not fit a block above Cp = 256 (516 KB
// at Cp = 1008), and splitting the output channels across blocks would
// recompute product 1 for each split. So after ln_bf16_kernel the call
// runs one TMA + wgmma GEMM kernel twice:
//  1. gemm_kernel<GELU>: g (Tp, Fp) = bf16(GELU(h W1^T^T + b1));
//  2. gemm_kernel<residual>: out = res + gamma (g W2^T^T + b2) through the
//     strides (K12: and outq).
// The same arithmetic as the fused kernel (JAX rounds g to bf16 before
// product 2 too); g's round trip through device memory costs 2 T Fp bytes
// each way. The GEMM: C (M x N) = A (M x K) B^T, A and B K-major bf16,
// tiles of 128 x BN (BN picked per call so that the last wave is not
// mostly idle), K in 64-wide boxes through a ring of kStages, the tile
// index n fastest (the blocks of a wave share A's rows and B stays in L2).
// ---------------------------------------------------------------------------

struct Gemm {
  int N, K;             // output columns, reduction
  int n_tiles;          // column tiles
  long long tiles;      // all tiles (row tiles x n_tiles)
};

template <int BN> struct GemmCfg {
  static constexpr int kABytes = kBM * 128;
  static constexpr int kBBytes = BN * 128;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kStages =
      (200 * 1024) / kStageBytes > 6 ? 6 : (200 * 1024) / kStageBytes;
  static constexpr size_t kStg = (size_t)kStages * kStageBytes;
  static constexpr size_t kTok = kStg + 2 * kStageFloats * sizeof(float);
  static constexpr size_t kCv = kTok + 4 * 64 * sizeof(long long);
  static constexpr size_t kBar = kCv + 2 * 2 * BN * sizeof(float);
  static constexpr size_t kSmem = 1024 + kBar + 2 * kStages * sizeof(uint64_t);
  static_assert(kSmem <= kSmemMax, "fits a block's shared memory");
};

template <int BN, bool GELU, typename A>
__global__ void __launch_bounds__(kHopperThreads, 1)
gemm_kernel(const __grid_constant__ CUtensorMap map_a,
            const __grid_constant__ CUtensorMap map_b,
            const __grid_constant__ CUtensorMap map_g, const Gemm gm,
            const A a) {
  using L = GemmCfg<BN>;
  constexpr int S = L::kStages;
  unsigned char* sm = smem_1k();
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* empty = full + S;
  const int KB = (gm.K + kBK - 1) / kBK;

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
        const int m0 = (int)(tile / gm.n_tiles) * kBM;
        const int n0 = (int)(tile % gm.n_tiles) * BN;
        for (int kb = 0; kb < KB; ++kb) {
          mbar_wait(&empty[s], ph ^ 1);
          unsigned char* st = sm + s * L::kStageBytes;
          mbar_expect_tx(&full[s], L::kStageBytes);
          tma_load(st, &map_a, &full[s], kb * kBK, m0);
          tma_load(st + L::kABytes, &map_b, &full[s], kb * kBK, n0);
          if (++s == S) { s = 0; ph ^= 1; }
        }
      }
    }
  } else {                                       // consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = threadIdx.x >> 7, wt = threadIdx.x & 127;
    const int lane = threadIdx.x & 31;
    float* stg = reinterpret_cast<float*>(sm + L::kStg) + wg * kStageFloats;
    long long* tok = reinterpret_cast<long long*>(sm + L::kTok) + wg * 128;
    long long* qtok = tok + 64;
    float* cv = reinterpret_cast<float*>(sm + L::kCv) + wg * 2 * BN;
    int s = 0, ph = 0;
    for (long long tile = blockIdx.x; tile < gm.tiles; tile += gridDim.x) {
      const long long m0 = (tile / gm.n_tiles) * kBM + wg * 64;
      const int n0 = (int)(tile % gm.n_tiles) * BN;
      wg_sync(wg);                     // the last tile's epilogue is done
      // the tile's columns: b1 (GELU), or b2 and gamma; its token offsets
      for (int i = wt; i < BN; i += 128) {
        const int c = n0 + i;
        if (GELU) {
          cv[i] = c < gm.N ? a.b1[c] : 0.f;
        } else {
          cv[i] = c < a.C ? a.vec[2 * a.C + c] : 0.f;
          cv[BN + i] = c < a.C ? a.vec[3 * a.C + c] : 0.f;
        }
      }
      if (!GELU && wt < 64) tok[wt] = token_offset(a, m0 + wt, &qtok[wt]);
      float acc[BN / 2];
      int prev = -1;
      for (int kb = 0; kb < KB; ++kb) {
        mbar_wait(&full[s], ph);
        const unsigned char* st = sm + s * L::kStageBytes;
        const uint64_t da = wgmma::desc_sw128(st + wg * kBox);
        const uint64_t db = wgmma::desc_sw128(st + L::kABytes);
        wgmma::fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma::ss<BN>(acc, da + 2 * kk, db + 2 * kk, kb | kk);
        wgmma::commit();
        wgmma::wait<1>();              // the previous stage's products
        wgmma::fence_operands<BN / 2>(acc);
        if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = s;
        if (++s == S) { s = 0; ph ^= 1; }
      }
      wgmma::wait<0>();
      wgmma::fence_operands<BN / 2>(acc);
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      if constexpr (GELU)
        gelu_epilogue<BN / 8>(acc, reinterpret_cast<bf16*>(stg), wg,
                              gm.N - n0, cv, &map_g, n0, m0);
      else
        residual_epilogue<BN / 8>(acc, stg, wg, a.C - n0, cv, cv + BN,
                                  a.sC != 1, residual_sink(a, tok, qtok, n0));
    }
  }
}

// ---- the bf16 LayerNorm -------------------------------------------------------
//
// h (Tp, Cp) bf16 tokens-major = LN(y + pre_bias) (K12: y = bf16(y1 +
// y2^T)), zero past C, kLnBT tokens a block: the tile's y (bf16, exact)
// staged in shared memory through for_tile (neighbouring lanes on
// neighbouring addresses, 16 loads in flight a thread), then a warp a
// token, fp32 statistics, h stored along the channels.
// ---------------------------------------------------------------------------

constexpr int kLnBT = 32;                // tokens a block (4 a warp)

size_t smem_ln_bf16(int Cp) {
  return ((size_t)kLnBT * (Cp + 2) * sizeof(bf16) + 15) / 16 * 16 +
         kLnBT * sizeof(long long);
}

template <typename A>
__global__ void __launch_bounds__(kThreads)
ln_bf16_kernel(A a, bf16* __restrict__ h) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int LD = a.Cp + 2;               // odd in words: rows on 32 banks
  bf16* st = reinterpret_cast<bf16*>(smem_raw);
  long long* tok = reinterpret_cast<long long*>(
      smem_raw + ((size_t)kLnBT * LD * sizeof(bf16) + 15) / 16 * 16);
  const long long t0 = (long long)blockIdx.x * kLnBT;
  token_offsets(a, t0, tok);
  const bf16* __restrict__ y = static_cast<const bf16*>(a.y);
  for_tile<16>(
      a, tok,
      [&](long long off) { return off >= 0 ? to_f<bf16>(y[off]) : 0.f; },
      [&](int t, int c, long long off, float v) {
        if constexpr (kDual<A>) {
          const bf16* y2 = static_cast<const bf16*>(a.y2);
          if (off >= 0)
            v = to_f<bf16>(from_f<bf16>(v + to_f<bf16>(y2[q_tokens(a)[t] +
                                                          c * a.sC])));
        }
        st[t * LD + c] = from_f<bf16>(v);
      });
  __syncthreads();
  const float* __restrict__ ln_s = a.vec;
  const float* __restrict__ ln_b = a.vec + a.C;
  const float* __restrict__ pre = a.vec + 4 * a.C;
  constexpr int R = kLnBT / kWarps;
  const int lane = threadIdx.x & 31, t0r = (threadIdx.x >> 5) * R;
  float mean[R], inv[R];
#pragma unroll
  for (int r = 0; r < R; ++r) mean[r] = 0.f;
  for (int c = lane; c < a.C; c += 32) {
    const float pb = pre[c];
#pragma unroll
    for (int r = 0; r < R; ++r)
      mean[r] += to_f<bf16>(st[(t0r + r) * LD + c]) + pb;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    mean[r] = warp_sum(mean[r]) / a.C;
    inv[r] = 0.f;
  }
  for (int c = lane; c < a.C; c += 32) {
    const float pb = pre[c];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float d = to_f<bf16>(st[(t0r + r) * LD + c]) + pb - mean[r];
      inv[r] += d * d;
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
    inv[r] = rsqrtf(warp_sum(inv[r]) / a.C + kLnEps);
  for (int c = lane; c < a.Cp; c += 32) {
    const bool in = c < a.C;
    const float sc = in ? ln_s[c] : 0.f, bi = in ? ln_b[c] : 0.f;
    const float pb = in ? pre[c] : 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r)
      h[(t0 + t0r + r) * a.Cp + c] = from_f<bf16>(
          in ? (to_f<bf16>(st[(t0r + r) * LD + c]) + pb - mean[r]) * inv[r] *
                       sc + bi
             : 0.f);
  }
}

// ---------------------------------------------------------------------------

// K12's q token offsets go after a kernel's own shared layout: the
// dynamic shared memory with them (a.q_off set).
size_t with_q_tokens(const Args&, size_t smem) { return smem; }
size_t with_q_tokens(DualArgs& a, size_t smem) {
  a.q_off = (int)((smem + 15) / 16 * 16);
  return a.q_off + (size_t)a.BT * sizeof(long long);
}

long long f32_tokens(long long tokens) {
  return (tokens + kBM - 1) / kBM * kBM;
}

// float32: the weights' planes, the LayerNorm into h's planes, the two
// 3xTF32 products, the residual epilogue (see the float32 section).
template <typename A>
cudaError_t launch_f32(A a, void* ws, cudaStream_t stream) {
  const long long T = a.n_outer * a.P;
  if (T == 0) return cudaSuccess;
  a.BT = kSimtBT;
  const size_t smem = with_q_tokens(a, smem_simt_tile(a.Cp));
  if (ws == nullptr || smem > kSmemMax) return cudaErrorInvalidConfiguration;
  const int Cp = a.Cp, Fp = a.Fp, sms = sm_count();
  const long long Tp = f32_tokens(T);
  const F32Layout L = f32_layout(Tp, Cp, Fp);
  const auto at = [&](size_t off) {
    return reinterpret_cast<float*>(static_cast<unsigned char*>(ws) + off);
  };
  cudaError_t e = split(a.w1, at(L.w1), Fp, Cp, false, stream);
  if (e == cudaSuccess) e = split(a.w2, at(L.w2), Cp, Fp, false, stream);
  if (e == cudaSuccess)
    e = allow_smem(reinterpret_cast<const void*>(simt_ln_kernel<A>));
  if (e != cudaSuccess) return e;
  const unsigned blocks = (unsigned)(Tp / kSimtBT);
  simt_ln_kernel<A><<<blocks, kThreads, smem, stream>>>(a, at(L.h), Tp);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  // g = GELU(h W1^T^T + b1) -> g's planes
  CUtensorMap m[4];
  if (!tensor_map(&m[0], at(L.h), 2 * Tp, Cp, kBM, kKf, true, 0, true) ||
      !tensor_map(&m[1], at(L.w1), 2LL * Fp, Cp, kBNf, kKf, true, 0, true))
    return cudaErrorInvalidValue;
  m[2] = m[0];
  m[3] = m[1];
  Tf32Args g1{};
  g1.M = (int)Tp;
  g1.N = Fp;
  g1.kb = (Cp + kKf - 1) / kKf;
  g1.b1 = a.b1;
  g1.planes = at(L.g);
  e = run_tf32<Tf32Epi::GeluFwd>(m, g1, sms, stream);
  if (e != cudaSuccess) return e;

  // os = g W2^T^T
  if (!tensor_map(&m[0], at(L.g), 2 * Tp, Fp, kBM, kKf, true, 0, true) ||
      !tensor_map(&m[1], at(L.w2), 2LL * Cp, Fp, kBNf, kKf, true, 0, true))
    return cudaErrorInvalidValue;
  m[2] = m[0];
  m[3] = m[1];
  Tf32Args g2{};
  g2.M = (int)Tp;
  g2.N = Cp;
  g2.kb = Fp / kKf;
  g2.out = at(L.os);
  e = run_tf32<Tf32Epi::F32>(m, g2, sms, stream);
  if (e == cudaSuccess)
    e = allow_smem(reinterpret_cast<const void*>(simt_out_kernel<A>));
  if (e != cudaSuccess) return e;
  simt_out_kernel<A><<<blocks, kThreads, smem, stream>>>(a, at(L.os));
  return cudaGetLastError();
}

// ---- bf16 host side ---------------------------------------------------------

constexpr int kFusedCpMax = 256;         // the fused kernel's widest Cp

template <int NP, typename A>
cudaError_t run_fused(const CUtensorMap& mh, const A& a, int sms,
                      cudaStream_t stream) {
  CUtensorMap m1, m2;
  if (!tensor_map(&m1, a.w1, a.Fp, a.Cp, kFC) ||
      !tensor_map(&m2, a.w2, a.Cp, a.Fp, NP))
    return cudaErrorInvalidValue;
  const auto kernel = mlp_fused_kernel<NP, A>;
  const cudaError_t e = allow_smem(reinterpret_cast<const void*>(kernel));
  if (e != cudaSuccess) return e;
  const long long tiles = (a.n_outer * a.P + kBM - 1) / kBM;
  kernel<<<(unsigned)(tiles < sms ? tiles : sms), kHopperThreads,
           Fused<NP>::kSmem, stream>>>(mh, m1, m2, a);
  return cudaGetLastError();
}

// The bf16 workspace: h (Tp, Cp), then (Cp > kFusedCpMax) g (Tp, Fp).
struct Bf16Layout {
  size_t g, total;
};

Bf16Layout bf16_layout(long long tokens, int Cp, int Fp) {
  auto al = [](size_t n) { return (n + 255) / 256 * 256; };
  const size_t Tp = (size_t)((tokens + kBM - 1) / kBM * kBM);
  Bf16Layout L;
  L.g = al(Tp * Cp * sizeof(bf16));
  L.total = L.g + (Cp > kFusedCpMax ? al(Tp * Fp * sizeof(bf16)) : 0);
  return L;
}

template <int BN, bool GELU, typename A>
cudaError_t run_gemm(const CUtensorMap& ma, const CUtensorMap& mb,
                     const CUtensorMap& mg, const Gemm& gm, const A& a,
                     int sms, cudaStream_t stream) {
  const auto kernel = gemm_kernel<BN, GELU, A>;
  const cudaError_t e = allow_smem(reinterpret_cast<const void*>(kernel));
  if (e != cudaSuccess) return e;
  const int grid = (int)(gm.tiles < sms ? gm.tiles : sms);
  kernel<<<grid, kHopperThreads, GemmCfg<BN>::kSmem, stream>>>(ma, mb, mg,
                                                                  gm, a);
  return cudaGetLastError();
}

// bf16: the LayerNorm into h, then the fused kernel (Cp <= kFusedCpMax)
// or the two GEMMs through g.
template <typename A>
cudaError_t launch_bf16(A a, void* ws, cudaStream_t stream) {
  const long long T = a.n_outer * a.P;
  if (T == 0) return cudaSuccess;
  if (ws == nullptr) return cudaErrorInvalidConfiguration;
  const Bf16Layout L = bf16_layout(T, a.Cp, a.Fp);
  bf16* h = static_cast<bf16*>(ws);
  bf16* g = reinterpret_cast<bf16*>(static_cast<unsigned char*>(ws) + L.g);
  const long long m_tiles = (T + kBM - 1) / kBM;
  const int sms = sm_count();

  a.BT = kLnBT;
  const size_t smem = with_q_tokens(a, smem_ln_bf16(a.Cp));
  cudaError_t e =
      allow_smem(reinterpret_cast<const void*>(ln_bf16_kernel<A>));
  if (e != cudaSuccess) return e;
  ln_bf16_kernel<A><<<(unsigned)(m_tiles * kBM / kLnBT), kThreads, smem,
                      stream>>>(a, h);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  CUtensorMap ma, mb;
  if (!tensor_map(&ma, h, T, a.Cp, kBM)) return cudaErrorInvalidValue;
  if (a.Cp <= 128) return run_fused<128>(ma, a, sms, stream);
  if (a.Cp <= kFusedCpMax) return run_fused<256>(ma, a, sms, stream);

  // g = GELU(h W1^T^T + b1)
  CUtensorMap mg;
  const int bn1 = pick_bn(m_tiles, a.Fp, sms, {128, 192, 256});
  if (!tensor_map(&mb, a.w1, a.Fp, a.Cp, bn1) ||
      !tensor_map(&mg, g, T, a.Fp, 64, 32, false))
    return cudaErrorInvalidValue;
  const int n1 = (a.Fp + bn1 - 1) / bn1;
  const Gemm g1{a.Fp, a.Cp, n1, m_tiles * n1};
  const Args& base = a;
  e = bn1 == 128   ? run_gemm<128, true>(ma, mb, mg, g1, base, sms, stream)
      : bn1 == 192 ? run_gemm<192, true>(ma, mb, mg, g1, base, sms, stream)
                   : run_gemm<256, true>(ma, mb, mg, g1, base, sms, stream);
  if (e != cudaSuccess) return e;

  // out = res + gamma (g W2^T^T + b2)
  const int bn2 = pick_bn(m_tiles, a.Cp, sms, {128, 256});
  if (!tensor_map(&ma, g, T, a.Fp, kBM) ||
      !tensor_map(&mb, a.w2, a.Cp, a.Fp, bn2))
    return cudaErrorInvalidValue;
  const int n2 = (a.Cp + bn2 - 1) / bn2;
  const Gemm g2{a.Cp, a.Fp, n2, m_tiles * n2};
  return bn2 == 128 ? run_gemm<128, false>(ma, mb, mg, g2, a, sms, stream)
                    : run_gemm<256, false>(ma, mb, mg, g2, a, sms, stream);
}

}  // namespace

// The bytes of scratch slak_fused_mlp needs for dtype at this many tokens:
// float32's planes of h, g and the two weights, and os; bfloat16's h and,
// above Cp = 256, g.
extern "C" long long slak_fused_mlp_workspace(int dtype, long long tokens,
                                              int Cp, int Fp) {
  if (dtype == 0)
    return (long long)f32_layout(f32_tokens(tokens), Cp, Fp).total;
  return (long long)bf16_layout(tokens, Cp, Fp).total;
}

// dtype: 0 = float32, 1 = bfloat16. y, res, out: strided activations (see
// the header); W1^T (Fp, Cp), W2^T (Cp, Fp) in the compute dtype with Cp a
// multiple of 16 and Fp of 64; b1 (Fp) and vec (5, C) float32; ws:
// slak_fused_mlp_workspace bytes.
// Returns the cudaError_t of the launches.
extern "C" int slak_fused_mlp(int dtype, const void* y, const void* res,
                              void* out, const void* w1, const void* w2,
                              const float* b1, const float* vec,
                              long long n_outer, long long P, long long sN,
                              long long sC, long long sP, int C, int Cp,
                              int Fp, int add_residual, void* ws,
                              void* stream) {
  if (Cp % 16 || Fp % 64 || C > Cp) return (int)cudaErrorInvalidValue;
  Args a{y, res, out, w1, w2, b1, vec, n_outer, P, sN, sC, sP,
         C, Cp, Fp, 0, add_residual};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_f32(a, ws, s);
  if (dtype == 1) return (int)launch_bf16(a, ws, s);
  return (int)cudaErrorInvalidValue;
}

// K12 (replaces pallas_mlp.py: fused_mlp_cmajor_dual_raw, the
// _mlp_cmajor_dual_kernel of the dual eval stage): the same tail on
// y = y1 + y2^T, y1, res and out NCHW (N, C, H, W) and y2 in the q
// orientation (N, C, W, H), all contiguous; the branch sum is taken in the
// compute dtype before the fp32 LayerNorm (pallas_mlp.py:632). With outq
// non-null the output is also written in the q orientation. The rest as
// slak_fused_mlp with the NCHW strides (n_outer = N, P = H * W).
extern "C" int slak_fused_mlp_dual(int dtype, const void* y1, const void* y2,
                                   const void* res, void* out, void* outq,
                                   const void* w1, const void* w2,
                                   const float* b1, const float* vec,
                                   long long N, int C, int H, int W, int Cp,
                                   int Fp, void* ws, void* stream) {
  if (Cp % 16 || Fp % 64 || C > Cp) return (int)cudaErrorInvalidValue;
  const long long P = (long long)H * W;
  DualArgs a{{y1, res, out, w1, w2, b1, vec, N, P, C * P, P, 1, C, Cp, Fp,
              0, 1},
             y2, outq, W, H, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_f32(a, ws, s);
  if (dtype == 1) return (int)launch_bf16(a, ws, s);
  return (int)cudaErrorInvalidValue;
}
