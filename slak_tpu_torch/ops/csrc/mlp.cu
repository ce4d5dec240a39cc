// Fused ConvNeXt block tail:
//   out = res + gamma * (GELU(LN(y + pre_bias) @ W1 + b1) @ W2 + b2)
// with fp32 LayerNorm statistics, h and g rounded to the compute dtype
// before each product, and fp32 accumulation.
//
// Replaces slak_tpu/ops/pallas_mlp.py: _mlp_fused_2d (_mlp_kernel, the
// tokens-major fused_mlp) and _mlp_cmajor_2d (_mlp_cmajor_kernel, the
// channel-major fused_mlp_cmajor). One kernel covers both and the NCHW
// layout of this port: the activation is addressed through strides,
// element (token t, channel c) at n*sN + c*sC + p*sP with t = n*P + p.
//
// The TPU kernel keeps both weight matrices resident in VMEM. An SM has
// 227 KB of shared memory and stage 4's weights alone are 15.9 MB in bf16,
// so here the weights stream from global memory (and the 50 MB L2, where
// every block of a launch reads the same matrices) one hidden chunk at a
// time, while a tile of BT tokens stays on the SM throughout:
//   1. the tile y + pre_bias (fp32) and its LayerNorm h (compute dtype);
//   2. for each chunk of FC hidden units: a = h @ W1[:, chunk] -> + b1 ->
//      exact-erf GELU -> g (compute dtype) -> acc += g @ W2[chunk, :];
//   3. out = res + gamma * (acc + b2).
// The 4C-wide hidden activations never reach device memory. W1 and W2 are
// repacked once per model by the wrapper (ops/mlp.py) transposed, as
// nn.Linear stores them: W1^T (Fp, Cp) and W2^T (Cp, Fp), zero-padded to
// Cp = C rounded up to 16 and Fp = 4C rounded up to 64, so the tensor-core
// tiles never see a ragged edge and each product's B operand is read along
// its reduction axis (col_major fragments); the ragged C of the
// activations is masked on load and store.
//
// Three kernels, picked by dtype and width (launch_tc, launch_simt):
// - bf16, C <= 512 (mlp_rf_kernel): both products on tensor cores through
//   raw mma.sync m16n8k16 + ldmatrix. A warp owns 16 tokens and all (or,
//   above 256 channels, half) of the output channels in registers; at
//   C <= 256 the first product's accumulators become the second's A
//   fragments in registers, so g never leaves the warp.
// - bf16, wider (mlp_tc_kernel, stage 4's C = 998): WMMA 16x16x16, the
//   output accumulator spread over the warps' registers, g through shared
//   memory.
//   Both bf16 kernels copy each hidden chunk's W1^T rows and W2^T columns
//   into shared memory with cp.async, overlapped with the products.
// - float32 (the differentiated eval's ERF path): plain fp32 FMAs (no
//   TF32), matching the JAX kernels' Precision.HIGHEST, in four launches
//   over f32 scratch: the LayerNorm, the two products as tiled GEMMs (the
//   first with the GELU epilogue), the residual epilogue (see the float32
//   section). The hidden activations make one round trip through device
//   memory there; a one-pass design re-read every weight for each 16-64
//   tokens at one FMA per two loads and was 10-30x slower.
//
// What bounds it on an H100: the two products, 4*T*C*4C operations, at
// 989 TFLOP/s dense bf16 at best; the bytes (y, res, out and the two
// weight matrices once) take far less. mma.sync fed from shared memory
// reaches a fraction of that rate, and at C = 998 every 32-token tile
// streams all 15.9 MB of weights; wgmma with TMA-fed weight tiles is the
// next step.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include <initializer_list>

#include "simt_tile.cuh"

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;           // row padding of the shared tiles
constexpr float kLnEps = 1e-6f;
constexpr size_t kSmemMax = 227 * 1024;

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

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
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
  int BT, FC, KS;      // token tile, hidden chunk, split of product 1
  int add_residual;
};

// Each token's offset in global memory (n*sN + p*sP; -1 past the end),
// computed once a tile: tok[BT].
__device__ void token_offsets(const Args& a, long long t0, long long* tok) {
  const long long T_total = a.n_outer * a.P;
  for (int t = threadIdx.x; t < a.BT; t += kThreads) {
    const long long tg = t0 + t;
    long long off = -1;
    if (tg < T_total) {
      const long long n = tg / a.P;
      off = n * a.sN + (tg - n * a.P) * a.sP;
    }
    tok[t] = off;
  }
  __syncthreads();
}

// Walk the tile's (token, channel) elements, neighbouring lanes on
// neighbouring addresses: along C when it is the unit stride (tokens-major:
// a warp a token), else along the tokens (a lane a token, a warp a
// channel). Each thread takes its elements U at a time: first U loads
// (load(offset), offset -1 outside the real extent), all in flight
// together, then use(t, c, offset, loaded value) for each.
template <int U, typename Load, typename Use>
__device__ __forceinline__ void for_tile(const Args& a, const long long* tok,
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
// hs <- LN(stage) (row pitch LDA). The LayerNorm runs a warp per token, R
// tokens of a warp at once.
template <typename T>
__device__ void load_layernorm(const Args& a, const long long* tok,
                               float* stage, int LDS, T* hs, int LDA) {
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
        hs[(t0 + r) * LDA + c] = from_f<T>(
            c < a.C ? (stage[(t0 + r) * LDS + c] - mean[r]) * inv[r] * sc + bi
                    : 0.f);
    }
  }
  __syncthreads();
}

// out <- res + gamma * (acc + b2) over the tile's real extent.
template <typename T>
__device__ void store_out(const Args& a, const long long* tok,
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
      });
}

// ---------------------------------------------------------------------------
// bf16, tensor cores, C > 512: WMMA
//
// Warp w owns row tile w % WM and every WN-th column tile of the (BT, Cp)
// output in registers; when the first product has fewer tiles than warps,
// its reduction dimension is split across warps (KS).
//
// Shared layout (LDA = Cp + kPad, LDF = FC + kPad):
//   hs [BT][LDA] bf16 | as [KS][BT][LDF] f32 | gs [BT][LDF] bf16 |
//   tok [BT] i64 | B
// where region B holds either w1s [FC][LDA] + w2s [Cp][LDF] (bf16, the
// chunk's rows of W1^T and columns of W2^T) or, before and after the chunk
// loop, the fp32 staging tile [BT][LDA].
// ---------------------------------------------------------------------------

size_t smem_tc(int BT, int Cp, int FC, int KS) {
  const size_t LDA = Cp + kPad, LDF = FC + kPad;
  const size_t w = (Cp * LDF + FC * LDA) * sizeof(bf16);
  const size_t st = BT * LDA * sizeof(float);
  return BT * LDA * sizeof(bf16) + KS * BT * LDF * sizeof(float) +
         BT * LDF * sizeof(bf16) + BT * sizeof(long long) + (w > st ? w : st);
}

// w1s [FC][LDA] <- W1^T rows f0 .. f0+FC (16-byte pieces)
template <int FC>
__device__ void load_weights_w1(const Args& a, int f0, bf16* w1s, int LDA) {
  const bf16* w1 = static_cast<const bf16*>(a.w1);
  const int per_row = a.Cp / 8;
  for (int i = threadIdx.x; i < FC * per_row; i += kThreads) {
    const int f = i / per_row, v = i - f * per_row;
    cp_async16(w1s + f * LDA + v * 8, w1 + (size_t)(f0 + f) * a.Cp + v * 8);
  }
}

// w2s [Cp][LDF] <- W2^T columns f0 .. f0+FC
template <int FC>
__device__ void load_weights_w2(const Args& a, int f0, bf16* w2s, int LDF) {
  const bf16* w2 = static_cast<const bf16*>(a.w2);
  constexpr int per_row = FC / 8;
  for (int i = threadIdx.x; i < a.Cp * per_row; i += kThreads) {
    const int c = i / per_row, v = i - c * per_row;
    cp_async16(w2s + c * LDF + v * 8, w2 + (size_t)c * a.Fp + f0 + v * 8);
  }
}

template <int NFRAG, int FC>
__global__ void __launch_bounds__(kThreads) mlp_tc_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int BT = a.BT, Cp = a.Cp, Fp = a.Fp, KS = a.KS;
  const int LDA = Cp + kPad;
  constexpr int LDF = FC + kPad;
  bf16* hs = reinterpret_cast<bf16*>(smem_raw);
  float* as = reinterpret_cast<float*>(hs + BT * LDA);
  bf16* gs = reinterpret_cast<bf16*>(as + KS * BT * LDF);
  long long* tok = reinterpret_cast<long long*>(gs + BT * LDF);
  bf16* w1s = reinterpret_cast<bf16*>(tok + BT);
  bf16* w2s = w1s + FC * LDA;
  float* stage = reinterpret_cast<float*>(w1s);

  const int tid = threadIdx.x, warp = tid >> 5;
  token_offsets(a, (long long)blockIdx.x * BT, tok);
  load_layernorm<bf16>(a, tok, stage, LDA, hs, LDA);

  load_weights_w1<FC>(a, 0, w1s, LDA);
  cp_async_commit();
  load_weights_w2<FC>(a, 0, w2s, LDF);
  cp_async_commit();

  const int WM = BT / 16, WN = kWarps / WM;
  const int tiles_c = Cp / 16;
  const int tm2 = warp % WM, tn2 = warp / WM;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NFRAG];
#pragma unroll
  for (int i = 0; i < NFRAG; ++i) wmma::fill_fragment(acc[i], 0.f);

  // product 1: tiles_1 output tiles, each reduced over KS slices of Cp
  constexpr int tiles_f = FC / 16;
  const int tiles_1 = WM * tiles_f;
  const int kslice = ((Cp / 16 + KS - 1) / KS) * 16;

  for (int f0 = 0; f0 < Fp; f0 += FC) {
    cp_async_wait<1>();                 // W1 of this chunk has landed
    __syncthreads();
    for (int job = warp; job < tiles_1 * KS; job += kWarps) {
      const int tile = job % tiles_1, ks = job / tiles_1;
      const int tm = tile / tiles_f, tn = tile % tiles_f;
      const int k_lo = ks * kslice;
      const int k_hi = min(Cp, k_lo + kslice);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> cf;
      wmma::fill_fragment(cf, 0.f);
      for (int k = k_lo; k < k_hi; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bf;
        wmma::load_matrix_sync(af, hs + tm * 16 * LDA + k, LDA);
        wmma::load_matrix_sync(bf, w1s + tn * 16 * LDA + k, LDA);
        wmma::mma_sync(cf, af, bf, cf);
      }
      wmma::store_matrix_sync(as + (ks * BT + tm * 16) * LDF + tn * 16, cf,
                              LDF, wmma::mem_row_major);
    }
    __syncthreads();
    if (f0 + FC < Fp) load_weights_w1<FC>(a, f0 + FC, w1s, LDA);
    cp_async_commit();
#pragma unroll 4
    for (int i = tid; i < BT * FC; i += kThreads) {
      const int t = i / FC, f = i - t * FC;
      float v = a.b1[f0 + f];
      for (int ks = 0; ks < KS; ++ks) v += as[(ks * BT + t) * LDF + f];
      gs[t * LDF + f] = from_f<bf16>(gelu(v));
    }
    cp_async_wait<1>();                 // W2 of this chunk has landed
    __syncthreads();
    for (int k = 0; k < FC; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
      wmma::load_matrix_sync(af, gs + tm2 * 16 * LDF + k, LDF);
#pragma unroll
      for (int i = 0; i < NFRAG; ++i) {
        const int tn = tn2 + WN * i;
        if (tn < tiles_c) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
              bf;
          wmma::load_matrix_sync(bf, w2s + tn * 16 * LDF + k, LDF);
          wmma::mma_sync(acc[i], af, bf, acc[i]);
        }
      }
    }
    __syncthreads();
    if (f0 + FC < Fp) load_weights_w2<FC>(a, f0 + FC, w2s, LDF);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NFRAG; ++i) {
    const int tn = tn2 + WN * i;
    if (tn < tiles_c)
      wmma::store_matrix_sync(stage + tm2 * 16 * LDA + tn * 16, acc[i], LDA,
                              wmma::mem_row_major);
  }
  __syncthreads();
  store_out<bf16>(a, tok, stage, LDA);
}

// ---------------------------------------------------------------------------
// bf16, tensor cores, C <= 512: raw mma.sync with the hidden chunk on chip
//
// A warp owns 16 tokens and 1/WN of the Cp output channels (NT n8 tiles);
// the WN warps of a token group split each hidden chunk's first product
// between them. With WN = 1 the first product's m16n8 accumulators, plus
// b1 and GELU, are exactly the A fragments of the second product (raw
// mma.sync m16n8k16 and ldmatrix, whose register layouts PTX fixes), so g
// never leaves the registers; with WN = 2 each warp writes its half of g
// to shared memory and the pair meets at a named barrier. A block is 8
// warps, BT = 128 / WN tokens; per chunk of FC hidden units it waits once
// for the chunk's weights (double-buffered cp.async).
//
// Shared layout (LDA = Cp + kPad, LDF = FC + kPad, LDS = Cp + 1):
//   hs [BT][LDA] bf16 | gs [BT][LDF] bf16 (WN > 1) | tok [BT] i64 | B
// where region B holds two weight buffers, each W1^T rows [FC][LDA] and
// W2^T columns [Cp][LDF], or, before and after the chunk loop, the fp32
// staging tile [BT][LDS].
// ---------------------------------------------------------------------------

size_t smem_rf(int Cp, int WN, int FC) {
  const size_t BT = 16 * kWarps / WN;
  const size_t LDA = Cp + kPad, LDF = FC + kPad;
  const size_t w = 2 * (FC * LDA + Cp * LDF) * sizeof(bf16);
  const size_t st = BT * (Cp + 1) * sizeof(float);
  return BT * LDA * sizeof(bf16) + (WN > 1 ? BT * LDF * sizeof(bf16) : 0) +
         BT * sizeof(long long) + (w > st ? w : st);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
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

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// NT: output n8 tiles a warp holds (Cp <= 8 * NT * WN)
template <int NT, int WN, int FC>
__global__ void __launch_bounds__(kThreads) mlp_rf_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int BT = 16 * kWarps / WN, LDF = FC + kPad;
  constexpr int HT = FC / 8 / WN;                 // n8 tiles of product 1
  static_assert(HT % 2 == 0, "product 1 runs in n8 tile pairs");
  const int Cp = a.Cp, Fp = a.Fp, LDA = Cp + kPad, LDS = Cp + 1;
  bf16* hs = reinterpret_cast<bf16*>(smem_raw);
  bf16* gs = hs + BT * LDA;
  long long* tok = reinterpret_cast<long long*>(gs + (WN > 1 ? BT * LDF : 0));
  bf16* wbuf = reinterpret_cast<bf16*>(tok + BT);
  const int wstride = FC * LDA + Cp * LDF;        // one weight buffer
  float* stage = reinterpret_cast<float*>(wbuf);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tg = warp / WN, cg = warp % WN;       // token, channel group
  const int t0 = tg * 16;
  // this warp's output n8 tiles: [j0, j1), an even count
  const int j0 = cg * NT, j1 = min(Cp / 8, j0 + NT);
  token_offsets(a, (long long)blockIdx.x * BT, tok);
  load_layernorm<bf16>(a, tok, stage, LDS, hs, LDA);

  load_weights_w1<FC>(a, 0, wbuf, LDA);
  load_weights_w2<FC>(a, 0, wbuf + FC * LDA, LDF);
  cp_async_commit();

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  // ldmatrix lane addresses: A, a 16 x 16 block (rows x k); B, a pair of
  // n8 tiles (16 rows of W^T x 16 k)
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3);
  const int b_col = ((lane >> 3) & 1) * 8;
  const unsigned hs_a = smem_u32(hs + (t0 + a_row) * LDA + a_col);
  const unsigned gs_a = smem_u32(gs + (t0 + a_row) * LDF + a_col);
  const int g_row = t0 + (lane >> 2), c_lane = 2 * (lane & 3);

  const int n_chunks = Fp / FC;
  for (int ch = 0; ch < n_chunks; ++ch) {
    cp_async_wait<0>();
    __syncthreads();              // chunk ch landed; chunk ch-1 all read
    const bf16* w1s = wbuf + (ch & 1) * wstride;
    const bf16* w2s = w1s + FC * LDA;
    if (ch + 1 < n_chunks) {
      bf16* nxt = wbuf + ((ch + 1) & 1) * wstride;
      load_weights_w1<FC>(a, (ch + 1) * FC, nxt, LDA);
      load_weights_w2<FC>(a, (ch + 1) * FC, nxt + FC * LDA, LDF);
    }
    cp_async_commit();

    // product 1: h (16 x Cp) . W1^T rows [cg*HT*8, (cg+1)*HT*8) of the chunk
    float h1[HT][4];
#pragma unroll
    for (int j = 0; j < HT; ++j) h1[j][0] = h1[j][1] = h1[j][2] = h1[j][3] = 0.f;
    const unsigned w1_b = smem_u32(w1s + (cg * HT * 8 + b_row) * LDA + b_col);
    for (int k = 0; k < Cp; k += 16) {
      unsigned af[4];
      ldsm_x4(hs_a + k * 2, af);
#pragma unroll
      for (int jp = 0; jp < HT / 2; ++jp) {
        unsigned b[4];
        ldsm_x4(w1_b + (jp * 16 * LDA + k) * 2, b);
        mma_16816(h1[2 * jp], af, b[0], b[1]);
        mma_16816(h1[2 * jp + 1], af, b[2], b[3]);
      }
    }
    // + b1, GELU, round to bf16
    unsigned gf[HT][2];
#pragma unroll
    for (int j = 0; j < HT; ++j) {
      const float2 bb = *reinterpret_cast<const float2*>(
          a.b1 + ch * FC + (cg * HT + j) * 8 + c_lane);
      gf[j][0] = pack_bf16x2(gelu(h1[j][0] + bb.x), gelu(h1[j][1] + bb.y));
      gf[j][1] = pack_bf16x2(gelu(h1[j][2] + bb.x), gelu(h1[j][3] + bb.y));
    }
    if (WN > 1) {
      // share this warp's hidden tiles with the token group's other warps
#pragma unroll
      for (int j = 0; j < HT; ++j) {
        const int c = (cg * HT + j) * 8 + c_lane;
        *reinterpret_cast<unsigned*>(gs + g_row * LDF + c) = gf[j][0];
        *reinterpret_cast<unsigned*>(gs + (g_row + 8) * LDF + c) = gf[j][1];
      }
      asm volatile("bar.sync %0, %1;\n" :: "r"(1 + tg), "r"(32 * WN));
    }
    // product 2: g (16 x FC) . W2^T columns -> this warp's output tiles
    const unsigned w2_b = smem_u32(w2s + (j0 * 8 + b_row) * LDF + b_col);
#pragma unroll
    for (int kk = 0; kk < FC / 16; ++kk) {
      unsigned af[4];
      if (WN > 1) {
        ldsm_x4(gs_a + kk * 16 * 2, af);
      } else {                    // the accumulator layout is the A layout
        af[0] = gf[2 * kk][0];
        af[1] = gf[2 * kk][1];
        af[2] = gf[2 * kk + 1][0];
        af[3] = gf[2 * kk + 1][1];
      }
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        if (j0 + 2 * jp < j1) {
          unsigned b[4];
          ldsm_x4(w2_b + (jp * 16 * LDF + kk * 16) * 2, b);
          mma_16816(acc[2 * jp], af, b[0], b[1]);
          mma_16816(acc[2 * jp + 1], af, b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  // accumulators -> stage (fp32) -> out
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j0 + j < j1) {
      const int c = 8 * (j0 + j) + c_lane;
      stage[g_row * LDS + c] = acc[j][0];
      stage[g_row * LDS + c + 1] = acc[j][1];
      stage[(g_row + 8) * LDS + c] = acc[j][2];
      stage[(g_row + 8) * LDS + c + 1] = acc[j][3];
    }
  }
  __syncthreads();
  store_out<bf16>(a, tok, stage, LDS);
}

// ---------------------------------------------------------------------------
// float32, CUDA cores, in four launches over f32 scratch (the workspace):
//  1. simt_ln_kernel, kSimtBT tokens a block: y + pre_bias, the LayerNorm
//     -> hs (Tp, Cp);
//  2. simt_gemm_kernel<true>: gs (Tp, Fp) = GELU(hs W1^T^T + b1);
//  3. simt_gemm_kernel<false>: os (Tp, Cp) = gs W2^T^T;
//  4. simt_out_kernel, kSimtBT tokens a block: out = res + gamma (os + b2)
//     through the strides.
// The products are simt_tile.cuh's 64 x 64 tiles, K in steps of 16: each
// shared load feeds four FMAs, and a weight tile is read once for 64
// tokens.
// ---------------------------------------------------------------------------

constexpr int kSimtBT = 32;                   // tokens a per-token block
constexpr int kGM = simt_tile::kTile, kGN = simt_tile::kTile, kGK = 16;
static_assert(kThreads == simt_tile::kThreads, "one thread block shape");

struct SimtLayout {
  size_t hs, gs, os, total;
};

inline SimtLayout simt_layout(long long Tp, int Cp, int Fp) {
  auto al = [](size_t n) { return (n + 255) / 256 * 256; };
  SimtLayout L;
  L.hs = 0;
  L.gs = al((size_t)Tp * Cp * sizeof(float));
  L.os = L.gs + al((size_t)Tp * Fp * sizeof(float));
  L.total = L.os + al((size_t)Tp * Cp * sizeof(float));
  return L;
}

size_t smem_simt_tile(int Cp) {
  return (size_t)kSimtBT * (Cp + 1) * sizeof(float) +
         kSimtBT * sizeof(long long);
}

__global__ void __launch_bounds__(kThreads)
simt_ln_kernel(Args a, float* __restrict__ hs) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int LDS = a.Cp + 1;
  float* stage = reinterpret_cast<float*>(smem_raw);
  long long* tok = reinterpret_cast<long long*>(stage + kSimtBT * LDS);
  const long long t0 = (long long)blockIdx.x * kSimtBT;
  token_offsets(a, t0, tok);
  load_layernorm<float>(a, tok, stage, LDS, hs + t0 * a.Cp, a.Cp);
}

__global__ void __launch_bounds__(kThreads)
simt_out_kernel(Args a, const float* __restrict__ os) {
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

// Cout (Tp, N) = A (Tp, K) B^T, B (N, K), all row-major; GELU adds bias
// and applies the exact-erf GELU. Rows past N load as zeros and are not
// stored.
template <bool GELU>
__global__ void __launch_bounds__(kThreads, simt_tile::kMinBlocks)
simt_gemm_kernel(const float* __restrict__ A, const float* __restrict__ B,
                 float* __restrict__ Cout, const float* __restrict__ bias,
                 int K, int N) {
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  const long long m0 = (long long)blockIdx.x * kGM;
  const int n0 = blockIdx.y * kGN;
  float acc[4][4] = {};
  simt_tile::product<kGK, true, true>(
      [&](int r, long long k) { return k < K ? A[(m0 + r) * K + k] : 0.f; },
      [&](int r, long long k) {
        return k < K && n0 + r < N ? B[(long long)(n0 + r) * K + k] : 0.f;
      },
      0, K, acc);
  for (int i = 0; i < 4; ++i) {
    const long long row = m0 + tr * 4 + i;
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tc * 4 + j;
      if (n < N)
        Cout[row * N + n] = GELU ? gelu(acc[i][j] + bias[n]) : acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------

// Raise a kernel's dynamic shared-memory limit to the most a block may
// have, once a kernel, not at every launch.
cudaError_t allow_smem(const void* kernel) {
  static const void* done[16];
  static int n_done = 0;
  for (int i = 0; i < n_done; ++i)
    if (done[i] == kernel) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemMax);
  if (e == cudaSuccess && n_done < 16) done[n_done++] = kernel;
  return e;
}

template <typename K>
cudaError_t run(K kernel, const Args& a, size_t smem, cudaStream_t stream) {
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(kernel));
  if (e != cudaSuccess) return e;
  const long long tokens = a.n_outer * a.P;
  const long long blocks = (tokens + a.BT - 1) / a.BT;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int FC>
cudaError_t run_tc(int nfrag, const Args& a, size_t smem,
                   cudaStream_t stream) {
  if (nfrag <= 4) return run(mlp_tc_kernel<4, FC>, a, smem, stream);
  if (nfrag <= 8) return run(mlp_tc_kernel<8, FC>, a, smem, stream);
  return run(mlp_tc_kernel<16, FC>, a, smem, stream);
}

// Token tile, hidden chunk and product-1 split for bf16: the largest tile
// whose register accumulator (NFRAG fragments a warp) and shared memory
// fit, with the larger hidden chunk where both fit. (A smaller tile that
// fills more SMs when tokens are few measured slower at stage 4: every
// tile streams the whole weight matrices.)
cudaError_t launch_tc(Args a, cudaStream_t stream) {
  if (a.Cp <= 512) {
    a.KS = 1;
    a.FC = a.Cp <= 256 ? 64 : 32;
    const int WN = a.Cp <= 256 ? 1 : 2;
    a.BT = 16 * kWarps / WN;
    const size_t smem = smem_rf(a.Cp, WN, a.FC);
    if (smem <= kSmemMax) {
      if (a.Cp <= 128) return run(mlp_rf_kernel<16, 1, 64>, a, smem, stream);
      if (a.Cp <= 256) return run(mlp_rf_kernel<32, 1, 64>, a, smem, stream);
      return run(mlp_rf_kernel<32, 2, 32>, a, smem, stream);
    }
  }
  const int tiles_c = a.Cp / 16;
  for (int BT : {64, 32, 16}) {
    for (int FC : {64, 32}) {
      if (a.Fp % FC) continue;
      const int WM = BT / 16, WN = kWarps / WM;
      const int nfrag = (tiles_c + WN - 1) / WN;
      if (nfrag > 16) continue;
      const int tiles_1 = WM * (FC / 16);
      const int KS = tiles_1 >= kWarps ? 1 : kWarps / tiles_1;
      const size_t smem = smem_tc(BT, a.Cp, FC, KS);
      if (smem > kSmemMax) continue;
      a.BT = BT;
      a.FC = FC;
      a.KS = KS;
      return FC == 64 ? run_tc<64>(nfrag, a, smem, stream)
                      : run_tc<32>(nfrag, a, smem, stream);
    }
  }
  return cudaErrorInvalidConfiguration;
}

long long simt_tokens(const Args& a) {
  return (a.n_outer * a.P + kGM - 1) / kGM * kGM;
}

cudaError_t launch_simt(Args a, void* ws, cudaStream_t stream) {
  const size_t smem = smem_simt_tile(a.Cp);
  if (ws == nullptr || smem > kSmemMax) return cudaErrorInvalidConfiguration;
  a.BT = kSimtBT;
  a.FC = a.KS = 1;
  const long long Tp = simt_tokens(a);
  const SimtLayout L = simt_layout(Tp, a.Cp, a.Fp);
  unsigned char* base = static_cast<unsigned char*>(ws);
  float* hs = reinterpret_cast<float*>(base + L.hs);
  float* gs = reinterpret_cast<float*>(base + L.gs);
  float* os = reinterpret_cast<float*>(base + L.os);
  const float* w1 = static_cast<const float*>(a.w1);
  const float* w2 = static_cast<const float*>(a.w2);
  const unsigned tiles = (unsigned)(Tp / kSimtBT);
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(simt_ln_kernel));
  if (e != cudaSuccess) return e;
  simt_ln_kernel<<<tiles, kThreads, smem, stream>>>(a, hs);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  simt_gemm_kernel<true><<<dim3((unsigned)(Tp / kGM), a.Fp / kGN), kThreads,
                           0, stream>>>(hs, w1, gs, a.b1, a.Cp, a.Fp);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  simt_gemm_kernel<false><<<dim3((unsigned)(Tp / kGM),
                                 (a.Cp + kGN - 1) / kGN), kThreads, 0,
                            stream>>>(gs, w2, os, nullptr, a.Fp, a.Cp);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = allow_smem(reinterpret_cast<const void*>(simt_out_kernel));
  if (e != cudaSuccess) return e;
  simt_out_kernel<<<tiles, kThreads, smem, stream>>>(a, os);
  return cudaGetLastError();
}

}  // namespace

// The bytes of scratch slak_fused_mlp needs for dtype at this many tokens
// (the float32 path's hs, gs and os; none for bfloat16).
extern "C" long long slak_fused_mlp_workspace(int dtype, long long tokens,
                                              int Cp, int Fp) {
  if (dtype != 0) return 0;
  return (long long)simt_layout((tokens + kGM - 1) / kGM * kGM, Cp, Fp).total;
}

// dtype: 0 = float32, 1 = bfloat16. y, res, out: strided activations (see
// the header); W1^T (Fp, Cp), W2^T (Cp, Fp) in the compute dtype with Cp a
// multiple of 16 and Fp of 64; b1 (Fp) and vec (5, C) float32; ws:
// slak_fused_mlp_workspace bytes (may be null for bfloat16).
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
         C, Cp, Fp, 0, 0, 0, add_residual};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_simt(a, ws, s);
  if (dtype == 1) return (int)launch_tc(a, s);
  return (int)cudaErrorInvalidValue;
}
