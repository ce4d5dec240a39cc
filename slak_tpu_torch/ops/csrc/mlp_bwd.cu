// Backward of the fused ConvNeXt block tail
//   out = res + gamma * (GELU(LN(y + pre_bias) @ W1 + b1) @ W2 + b2):
// dy, dW1, dW2, db1, db2, dgamma, dLN-scale and dLN-bias. Two entry points
// over one launch sequence: slak_mlp_bwd (K8, dy in the compute dtype) and
// slak_mlp_bwd_wide (K9, dy in float32).
//
// K8 replaces slak_tpu/ops/pallas_mlp.py: _mlp_bwd_2d (_mlp_bwd_kernel,
// C <= 256) and K9 _mlp_bwd_chunked_2d (_mlp_bwd_chunked_kernel, any C;
// the wide tails, C = 499 and 998 at SLaK-T w1.3's stages 3-4). The TPU
// kernels walk a sequential grid and keep dW1, dW2 and db1 in resident
// output blocks that every token tile adds into (K9 also dh across its 4C
// chunks). Blocks here run in parallel, the fp32 weight gradients (2 MB at
// C = 249, 32 MB at C = 998) fit in no SM, and a 128 x Cp fp32 dh does not
// fit a block above Cp = 256. So the work is split by what each output
// reduces over, every step a launch over scratch, no sum carried between
// blocks:
//  1. wide_prep_kernel, 32 tokens a block (above Cp = 512: 16 in bf16, 8
//     in float32):
//     the LayerNorm (mean and inv to scratch), h -> hs and [do | dout] ->
//     dd, rounded (float32: TF32 planes, below); the block's column sums
//     of do (db2) and dout.
//  2. a = h W1^T and dg = do W2 over K = Cp, with the epilogue g = GELU(a +
//     b1) and da = dg gelu'(a + b1) -> gs, das (rounded), and the column
//     sums of da (db1).
//  3. dh = da W1 over K = Fp -> f32 scratch.
//  4. wide_lnb_kernel, as many tokens a block: the LayerNorm backward from
//     the whole dh row (a warp a token), dy through the forward's (sN, sC,
//     sP) strides (NCHW needs no transpose); the block's column sums of dh
//     xhat and dh.
//  5. the token-reduction products dW1^T = da^T h and [dW2^T; M] = [do |
//     dout]^T g, split along the tokens, and dgamma_kernel: dgamma = sum_f
//     W2^T[c, f] M[c, f] + b2[c] sum_t dout (= sum_t dout (g W2^T + b2), so
//     the per-token g W2^T is never formed).
// Block and split partials are added in a fixed order (reduce_rows for the
// many rows of the per-token kernels and of db1, sum_partials for the
// token splits): no atomics, the same bits every run.
//
// dy-only mode (the caller asks for no parameter gradient: the ERF's input
// gradient with frozen weights) runs steps 1-4 and stops: no token
// reduction, no dgamma, none of the sums that only the parameter gradients
// read; in float32 the prep and the GELU product also skip the scratch
// (h's and [do | dout]'s transposed planes, g and da whole) that only step
// 5 reads. dy comes from the
// same launches of steps 1-4 in both modes, so its bits do not depend on
// the mode.
//
// bf16 runs the products (2, 3 and 5) as one persistent, warp-specialised
// Hopper GEMM kernel (bwd_gemm_kernel, below): a producer thread keeps TMA
// loads in flight through an mbarrier ring, two consumer warpgroups run
// wgmma with fp32 accumulators in registers. Where K runs along a matrix's
// rows (W2^T and W1^T in products 2-3, and the token-major scratch in the
// token reductions) the operand is read MN-major: wgmma's transposed form,
// so no operand is repacked. float32 (the differentiated eval's ERF path)
// runs products 2 and 3 as 3xTF32 on the same kind of kernel
// (tf32_gemm_kernel in tf32_gemm.cuh: each operand split into big and
// small TF32 parts, three TF32 products a k step, as accurate as fp32, the
// Hopper analogue of the TPU kernels' Precision.HIGHEST). TF32 wgmma has
// no transposed form, so its token reductions run on wgrad_tf32_kernel
// (below): the wide token-major operand (da, g) is wgmma's A, read from
// shared memory by its threads and split in registers; the narrow one (h,
// [do | dout]) is B, whose planes the prep kernel writes transposed.
//
// Rounding follows _mlp_bwd_kernel: LN statistics, a, gelu, dg, da and dh
// in fp32; h, g, do and da rounded to the compute dtype before the
// products that use them; exact erf. The weights are pack_mlp's W1^T (Fp,
// Cp) and W2^T (Cp, Fp), zero-padded to Cp (a multiple of 16) and Fp (of
// 64); products load zeros past K and N (TMA's fill), the per-token
// kernels mask the ragged channels and tokens, so padded hidden units and
// channels give exactly zero gradients, which the wrapper slices away.
//
// What bounds it on an H100: the six products, 12*T*C*4C operations, 0.30
// ms at 989 TFLOP/s bf16 at batch 128's stages 1-4; f32 about 49 GFLOP an
// ERF launch (24.6 in dy-only mode), 0.73 ms at 67 TFLOP/s FFMA, 0.30 (dy
// only: 0.15) as three TF32 passes at 495 TFLOP/s; step 5 alone 6*T*C*4C,
// about 31 GFLOP a launch at the det path's 800^2 stage shapes (batch 2):
// 0.47 ms on FFMA, 0.19 as 3xTF32. The scratch round trips (h, do, dout,
// g, da in the compute dtype, dh in f32; at stage 1, batch 128, about 3
// GB: 0.9 ms at 3.35 TB/s) weigh as much as the products in bf16, and the
// exact-erf GELU' epilogue (T x 4C erf and exp) is CUDA-core work that the
// two consumer warpgroups do while the tensor cores wait (PERF.md has the
// measured split).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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

struct BArgs {
  const void* y;       // activations, strided (see slak_fused_mlp)
  const void* dout;
  void* dy;
  const void* w1;      // W1^T (Fp, Cp) compute dtype
  const void* w2;      // W2^T (Cp, Fp) compute dtype
  const float* b1;     // (Fp)
  const float* vec;    // (5, C): ln_scale, ln_bias, b2, gamma, pre_bias
  void* hs;            // scratch (Tp, Cp): h
  void* dd;            // scratch (Tp, 2 Cp): [do | dout]
  void* gs;            // scratch (Tp, Fp): g
  void* das;           // scratch (Tp, Fp): da
  float* stats;        // scratch (Tp, 2): LayerNorm mean, inv
  float* vpart_a;      // partials (Tp / BT, 2 Cp) of wide_prep_kernel
  float* vpart_b;      // partials (Tp / BT, 2 Cp) of wide_lnb_kernel
  long long n_outer, P, sN, sC, sP;
  int C, Cp, Fp, BT;
};

// Each token's offset in global memory (n*sN + p*sP; -1 past the end).
__device__ void token_offsets(const BArgs& a, long long t0, long long* tok) {
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
}

// float32's prep outputs for the 3xTF32 products: the big and small TF32
// planes of h and of do, each (2 Tp, Cp), big rows first, for the GELU
// product; full: also, for the token reductions, the planes of h and of
// [do | dout] transposed, (2 Cp, Tp) and (4 Cp, Tp), K = the tokens
// running along their rows.
struct PrepF32 {
  float* h;
  float* dd;
  float* ht;
  float* ddt;
  long long Tp;
  int full;
};

// Walk the tile's (token, channel < Cp) elements, neighbouring lanes on
// neighbouring addresses: along C when it is the unit stride (a warp a
// token), else along the tokens (a lane a token, a warp a channel). U
// loads of each thread are in flight together: load(offset) (offset -1
// outside the real extent), then use(t, c, offset, value).
template <int U, typename Load, typename Use>
__device__ __forceinline__ void for_tile(const BArgs& a, const long long* tok,
                                         Load load, Use use) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool tok_major = a.sC == 1;
  const int n_out = tok_major ? a.BT : a.Cp;     // walked by warps
  const int n_in = tok_major ? a.Cp : a.BT;      // walked by lanes
  const int s_out = tok_major ? kWarps : kWarps * U;
  const int s_in = tok_major ? 32 * U : 32;
  for (int i0 = warp; i0 < n_out; i0 += s_out) {
    for (int j0 = lane; j0 < n_in; j0 += s_in) {
      long long off[U];
      float v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = tok_major ? i0 : i0 + kWarps * u;
        const int j = tok_major ? j0 + 32 * u : j0;
        const int t = tok_major ? i : j, c = tok_major ? j : i;
        off[u] = (i < n_out && j < n_in && tok[t] >= 0 && c < a.C)
                     ? tok[t] + c * a.sC : -1;
        v[u] = load(off[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = tok_major ? i0 : i0 + kWarps * u;
        const int j = tok_major ? j0 + 32 * u : j0;
        if (i < n_out && j < n_in)
          use(tok_major ? i : j, tok_major ? j : i, off[u], v[u]);
      }
    }
  }
}

__host__ __device__ inline size_t align128(size_t n) {
  return (n + 127) / 128 * 128;
}

__host__ __device__ inline size_t take(size_t* o, size_t bytes) {
  const size_t at = *o;
  *o += align128(bytes);
  return at;
}

// ---------------------------------------------------------------------------
// The per-token kernels (both dtypes)
// ---------------------------------------------------------------------------

constexpr int kWT = 32;        // tokens a block in the per-token kernels
constexpr int kWTNarrow = 16;  // ... in bf16 above Cp = 512
constexpr int kWTF32Narrow = 8;    // ... in float32 above Cp = 512
constexpr int kWPadT = 128;    // the tokens are padded to a multiple of this

// The per-token kernels' token tile for a compute dtype of e bytes: above
// 512 channels bf16 takes 16 tokens a block and float32 8, so that the few
// blocks of a wide tail (196 of 129 KB shared each at batch 128's stage 4
// with 32; 32 at the ERF's stage 4, 1024 tokens) fill the SMs. Measured at
// batch 128 (PERF.md): 16 tokens a block took stage 4 from 1.25 to 1.02
// ms, and lost at stages 1-3, as did 8 and 64.
inline int token_tile(size_t e, int Cp) {
  if (Cp <= 512) return kWT;
  return e == 2 ? kWTNarrow : kWTF32Narrow;
}

// Shared layout of the per-token kernels: tile [BT][Cp + 1] f32 (the odd
// pitch keeps the token-walking lanes off each other's banks) | mean, inv
// [BT] f32 | tok [BT] i64
struct TLayout {
  size_t tile, stats, tok, total;
};

__host__ __device__ inline TLayout t_layout(int Cp, int BT = kWT) {
  TLayout L;
  size_t o = 0;
  L.tile = take(&o, (size_t)BT * (Cp + 1) * sizeof(float));
  L.stats = take(&o, 2 * BT * sizeof(float));
  L.tok = take(&o, BT * sizeof(long long));
  L.total = o;
  return L;
}

// The LayerNorm (each token's mean and inv to scratch), h rounded -> hs,
// [do | dout] rounded -> dd (float32: h and do as TF32 planes -> sp, and
// in full mode h and [do | dout] as transposed planes, sp.ht and sp.ddt),
// and this block's column sums of do (db2) and dout -> vpart_a[blockIdx.x].
// Padded tokens and channels give zeros.
template <typename T, int BT = kWT>
__global__ void __launch_bounds__(kThreads)
wide_prep_kernel(BArgs a, const PrepF32 sp) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int C = a.C, Cp = a.Cp, LDW = Cp + 1;
  const TLayout L = t_layout(Cp, BT);
  float* tile = reinterpret_cast<float*>(smem_raw + L.tile);
  long long* tok = reinterpret_cast<long long*>(smem_raw + L.tok);
  const T* __restrict__ y = static_cast<const T*>(a.y);
  const T* __restrict__ dout = static_cast<const T*>(a.dout);
  T* __restrict__ h_g = static_cast<T*>(a.hs);
  T* __restrict__ dd_g = static_cast<T*>(a.dd);
  const float* __restrict__ ln_s = a.vec;
  const float* __restrict__ ln_b = a.vec + C;
  const float* __restrict__ gamma = a.vec + 3 * C;
  const float* __restrict__ pre = a.vec + 4 * C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long t0 = (long long)blockIdx.x * BT;

  token_offsets(a, t0, tok);
  __syncthreads();
  for_tile<4>(
      a, tok, [&](long long off) { return off >= 0 ? to_f(y[off]) : 0.f; },
      [&](int t, int c, long long off, float v) {
        tile[t * LDW + c] = off >= 0 ? v + pre[c] : 0.f;
      });
  __syncthreads();
  for (int t = warp; t < BT; t += kWarps) {
    float* row = tile + t * LDW;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += row[c];
    const float mu = warp_sum(s) / C;
    float q = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = row[c] - mu;
      q += d * d;
    }
    const float iv = rsqrtf(warp_sum(q) / C + kLnEps);
    const bool real = tok[t] >= 0;
    for (int c = lane; c < Cp; c += 32)
      row[c] = real && c < C ? (row[c] - mu) * iv * ln_s[c] + ln_b[c] : 0.f;
    if (lane == 0) {
      a.stats[(t0 + t) * 2] = mu;
      a.stats[(t0 + t) * 2 + 1] = iv;
    }
  }
  __syncthreads();
  if constexpr (sizeof(T) == 4) {
    const long long plane = sp.Tp * Cp;
    for (int i = tid; i < BT * Cp; i += kThreads) {
      const int t = i / Cp, c = i - t * Cp;
      const long long o = (t0 + t) * Cp + c;
      split_tf32(tile[t * LDW + c], sp.h + o, sp.h + plane + o);
    }
    // transposed, the tokens fastest: BT tokens (128 bytes at 32) a row
    if (sp.full)
      for (int i = tid; i < BT * Cp; i += kThreads) {
        const int c = i / BT, t = i - c * BT;
        const long long o = c * sp.Tp + t0 + t;
        split_tf32(tile[t * LDW + c], sp.ht + o, sp.ht + plane + o);
      }
  } else {
    for (int i = tid; i < BT * Cp; i += kThreads) {
      const int t = i / Cp, c = i - t * Cp;
      h_g[(t0 + t) * Cp + c] = from_f<T>(tile[t * LDW + c]);
    }
  }
  __syncthreads();
  for_tile<4>(
      a, tok,
      [&](long long off) { return off >= 0 ? to_f(dout[off]) : 0.f; },
      [&](int t, int c, long long, float v) { tile[t * LDW + c] = v; });
  __syncthreads();
  float* part = a.vpart_a + (long long)blockIdx.x * 2 * Cp;
  for (int c = tid; c < Cp; c += kThreads) {
    const float gm = c < C ? gamma[c] : 0.f;
    float s = 0.f, sd = 0.f;
    for (int t = 0; t < BT; ++t) {
      const float d = tile[t * LDW + c];
      const float v = d * gm;
      if constexpr (sizeof(T) == 4) {
        const long long o = (t0 + t) * Cp + c;
        split_tf32(v, sp.dd + o, sp.dd + sp.Tp * Cp + o);
      } else {
        T* row = dd_g + (t0 + t) * 2 * Cp;
        row[c] = from_f<T>(v);
        row[Cp + c] = from_f<T>(d);
      }
      s += v;
      sd += d;
    }
    part[c] = s;
    part[Cp + c] = sd;
  }
  if constexpr (sizeof(T) == 4) {
    // [do | dout] transposed, the tokens fastest: row n < Cp is do's
    // channel n (the same product d gamma as above), row Cp + c dout's c
    if (sp.full) {
      const long long plane = sp.Tp * 2 * Cp;
      for (int i = tid; i < BT * 2 * Cp; i += kThreads) {
        const int n = i / BT, t = i - n * BT;
        const int c = n < Cp ? n : n - Cp;
        const float d = tile[t * LDW + c];
        const float v = n < Cp ? d * (c < C ? gamma[c] : 0.f) : d;
        const long long o = n * sp.Tp + t0 + t;
        split_tf32(v, sp.ddt + o, sp.ddt + plane + o);
      }
    }
  }
}

// The LayerNorm backward from dh (f32 scratch, (Tp, Cp)): dy (DY, through
// the forward's strides) and this block's column sums of dh * xhat
// (dLN-scale) and dh (dLN-bias) -> vpart_b[blockIdx.x].
template <typename T, typename DY, int BT = kWT>
__global__ void __launch_bounds__(kThreads)
wide_lnb_kernel(BArgs a, const float* __restrict__ dh) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int C = a.C, Cp = a.Cp, LDW = Cp + 1;
  const TLayout L = t_layout(Cp, BT);
  float* tile = reinterpret_cast<float*>(smem_raw + L.tile);
  float* mean = reinterpret_cast<float*>(smem_raw + L.stats);
  float* inv = mean + BT;
  long long* tok = reinterpret_cast<long long*>(smem_raw + L.tok);
  const T* __restrict__ y = static_cast<const T*>(a.y);
  DY* __restrict__ dy = static_cast<DY*>(a.dy);
  const float* __restrict__ ln_s = a.vec;
  const float* __restrict__ pre = a.vec + 4 * C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long t0 = (long long)blockIdx.x * BT;
  const float* dh_t = dh + t0 * Cp;

  token_offsets(a, t0, tok);
  for (int t = tid; t < BT; t += kThreads) {
    mean[t] = a.stats[(t0 + t) * 2];
    inv[t] = a.stats[(t0 + t) * 2 + 1];
  }
  __syncthreads();
  // xhat -> tile (zero on padded tokens and channels)
  for_tile<4>(
      a, tok, [&](long long off) { return off >= 0 ? to_f(y[off]) : 0.f; },
      [&](int t, int c, long long off, float v) {
        tile[t * LDW + c] = off >= 0 ? (v + pre[c] - mean[t]) * inv[t] : 0.f;
      });
  __syncthreads();
  float* part = a.vpart_b + (long long)blockIdx.x * 2 * Cp;
  for (int c = tid; c < Cp; c += kThreads) {
    float sl = 0.f, sb = 0.f;
    for (int t = 0; t < BT; ++t) {
      const float d = dh_t[t * Cp + c];
      sl += d * tile[t * LDW + c];
      sb += d;
    }
    part[c] = sl;
    part[Cp + c] = sb;
  }
  __syncthreads();
  // dy = inv (dxh - mean_c dxh - xhat mean_c(dxh xhat)), dxh = dh ln_scale,
  // a warp a token, in place of xhat
  for (int t = warp; t < BT; t += kWarps) {
    float* row = tile + t * LDW;
    const float* drow = dh_t + t * Cp;
    float s = 0.f, q = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = drow[c] * ln_s[c];
      s += d;
      q += d * row[c];
    }
    const float m1 = warp_sum(s) / C, m2 = warp_sum(q) / C, iv = inv[t];
    for (int c = lane; c < Cp; c += 32)
      row[c] = c < C ? iv * (drow[c] * ln_s[c] - m1 - row[c] * m2) : 0.f;
  }
  __syncthreads();
  for_tile<4>(
      a, tok, [](long long) { return 0.f; },
      [&](int t, int c, long long off, float) {
        if (off >= 0) dy[off] = from_f<DY>(tile[t * LDW + c]);
      });
}

// dgamma[c] = sum_f W2^T[c, f] M[c, f] + b2[c] sum_t dout[t, c], a warp a
// channel
template <typename T>
__global__ void __launch_bounds__(kThreads)
dgamma_kernel(const T* __restrict__ w2, const float* __restrict__ m,
              const float* __restrict__ b2, const float* __restrict__ dsum,
              float* __restrict__ dgamma, int C, int Cp, int Fp) {
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (c >= Cp) return;
  float s = 0.f;
  if (c < C)
    for (int f = lane; f < Fp; f += 32)
      s += to_f(w2[(long long)c * Fp + f]) * m[(long long)c * Fp + f];
  s = warp_sum(s);
  if (lane == 0) dgamma[c] = c < C ? s + b2[c] * dsum[c] : 0.f;
}

// ---------------------------------------------------------------------------

// out[i] = sum over k < parts of part[k * n + i], in order
__global__ void sum_partials(const float* __restrict__ part,
                             float* __restrict__ out, long long n,
                             int parts) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < parts; ++k) s += part[k * n + i];
  out[i] = s;
}

cudaError_t reduce(const float* part, float* out, long long n, int parts,
                   cudaStream_t s) {
  sum_partials<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(part, out, n,
                                                           parts);
  return cudaGetLastError();
}

// The column sums of many partial rows (a row a block of a per-token
// kernel: 12544 at batch 128's stage 1) in two fixed-order steps, so that
// no thread walks them all: chunks of kChunk rows summed by parallel
// blocks (32 columns x 8 row lanes a block, the lanes' sums added in
// order) into `chunks` (ceil(parts / kChunk), n), then those in order by
// sum_partials.
constexpr int kChunk = 64;

__global__ void __launch_bounds__(256)
sum_chunks(const float* __restrict__ part, float* __restrict__ chunks,
           long long n, int parts) {
  __shared__ float sh[8][32];
  const int lane = threadIdx.x & 31, r = threadIdx.x >> 5;
  const long long i = (long long)blockIdx.x * 32 + lane;
  const int k0 = blockIdx.y * kChunk, k1 = min(parts, k0 + kChunk);
  float s = 0.f;
  if (i < n)
    for (int k = k0 + r; k < k1; k += 8) s += part[(long long)k * n + i];
  sh[r][lane] = s;
  __syncthreads();
  if (r == 0 && i < n) {
    float t = 0.f;
    for (int q = 0; q < 8; ++q) t += sh[q][lane];
    chunks[(long long)blockIdx.y * n + i] = t;
  }
}

cudaError_t reduce_rows(const float* part, float* out, long long n,
                        int parts, float* chunks, cudaStream_t s) {
  if (parts <= 2 * kChunk) return reduce(part, out, n, parts, s);
  const int nc = (parts + kChunk - 1) / kChunk;
  sum_chunks<<<dim3((unsigned)((n + 31) / 32), nc), 256, 0, s>>>(
      part, chunks, n, parts);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return reduce(chunks, out, n, nc, s);
}

template <typename K, typename... Args>
cudaError_t run(K kernel, int grid, size_t smem, cudaStream_t s,
                Args... args) {
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(kernel));
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, s>>>(args...);
  return cudaGetLastError();
}

// ===========================================================================
// bf16: the products on Hopper's tensor cores (TMA-fed wgmma)
//
// C (M x N) = sum over K of A[m][k] B[n][k], bf16 operands in device
// memory, fp32 accumulators in registers. Each operand is either K-major
// (rows m or n with K contiguous, read as boxes of 64 columns of K: h, do
// and da as token rows over the channels or hidden units, W1^T as product
// 2's B) or MN-major (rows k with M or N contiguous, read as 64 x 64 boxes:
// W2^T in product 2 and W1^T in product 3, whose K runs along their rows,
// and the token-major scratch in the token reductions, K = the tokens);
// wgmma takes an MN-major bf16 operand in its transposed form. A block is
// three warpgroups: warpgroups 0 and 1 consume (64 rows of M each,
// setmaxnreg 232), one thread of warpgroup 2 produces (the TMA loads,
// setmaxnreg 40) through a ring of mbarrier pairs (full: the bytes
// landed; empty: every consumer warp is done with the stage). Blocks are
// persistent, one an SM, walking tiles blockIdx.x, + gridDim.x, ...: the
// producer loads the next tile while the consumers run this one's
// epilogue. A tile is 128 rows x BN columns x one split of the k blocks,
// the column tile fastest (the blocks of a wave share A's rows).
//
// Epilogues: GELU (product 2, two products a = h W1^T and dg = do W2 on one
// tile): g = GELU(a + b1) and da = dg gelu'(a + b1) rounded, each staged as
// a [64][32] bf16 tile a warpgroup and stored by TMA, and each
// warpgroup's column sums of da (db1) -> vpart row 2 m_tile + wg; F32
// (products 3 and 5): the accumulators to out + z * z_stride, rows m < M,
// columns n < N.
// ===========================================================================

constexpr int kBK = 64;                  // K of a stage (128 bytes)
constexpr int kEpiCols = 32;             // the GELU epilogue's columns a pass

struct GemmArgs {
  int M, N;              // the stored extent: rows m < M, columns n < N
  int kb_total;          // 64-wide k blocks of K
  int kb_split;          // k blocks a split
  int m_tiles, n_tiles;
  long long tiles;       // m_tiles * n_tiles * splits
  float* out;            // F32: (splits, M, ld) fp32
  long long ld, z_stride;
  const float* b1;       // GELU: (N)
  float* vpart;          // GELU: (2 m_tiles, N) fp32
};

template <int BN, bool GELU> struct GemmCfg {
  static constexpr int kABytes = kBM * 128;
  static constexpr int kBBytes = BN * 128;
  static constexpr int kStageBytes = (kABytes + kBBytes) * (GELU ? 2 : 1);
  // GELU: g and da staging tiles of each consumer warpgroup; the column
  // sums of its 4 warps
  static constexpr size_t kEpiBytes =
      GELU ? 2 * 2 * 64 * kEpiCols * sizeof(bf16) : 0;
  static constexpr size_t kCsBytes = GELU ? 2 * 4 * BN * sizeof(float) : 0;
  static constexpr size_t kAvail =
      kSmemMax - 1024 - kEpiBytes - kCsBytes - 16 * sizeof(uint64_t);
  static constexpr int kStages =
      kAvail / kStageBytes > 6 ? 6 : (int)(kAvail / kStageBytes);
  static constexpr size_t kEpi = (size_t)kStages * kStageBytes;
  static constexpr size_t kCs = kEpi + kEpiBytes;
  static constexpr size_t kBar = kCs + kCsBytes;
  static constexpr size_t kSmem = 1024 + kBar + 2 * kStages * sizeof(uint64_t);
  static_assert(kStages >= 2 && kSmem <= kSmemMax, "fits a block");
  static_assert(!GELU || BN == 128, "the GELU epilogue's column sums");
};

struct Tile {
  int m0, n0, mt, kb0, kb1;
  long long z;
};

// Tile t's rows, columns and k blocks: the column tile fastest, then the
// row tile, then the split.
__device__ __forceinline__ Tile tile_at(const GemmArgs& gm, long long t,
                                        int bn) {
  const long long mn = (long long)gm.m_tiles * gm.n_tiles;
  Tile r;
  r.z = t / mn;
  const int i = (int)(t - r.z * mn);
  r.mt = i / gm.n_tiles;
  r.m0 = r.mt * kBM;
  r.n0 = (i - r.mt * gm.n_tiles) * bn;
  r.kb0 = (int)r.z * gm.kb_split;
  r.kb1 = min(gm.kb_total, r.kb0 + gm.kb_split);
  return r;
}

// One stage's share of an operand of `rows` rows of M or N from r0, k block
// kb: K-major, one box of `rows` x 64 at (k, r0); MN-major, rows / 64
// boxes of 64 k x 64, kBox bytes apart.
template <bool MN>
__device__ __forceinline__ void load_operand(unsigned char* dst,
                                             const CUtensorMap* map,
                                             uint64_t* bar, int kb, int r0,
                                             int rows) {
  if constexpr (!MN) {
    tma_load(dst, map, bar, kb * kBK, r0);
  } else {
    for (int j = 0; j < rows / 64; ++j)
      tma_load(dst + j * kBox, map, bar, r0 + 64 * j, kb * kBK);
  }
}

// The descriptor of an operand tile, and the advance of a 16-deep k step
// (in the descriptor's 16-byte units): 32 bytes K-major, 2048 MN-major.
template <bool MN>
__device__ __forceinline__ uint64_t op_desc(const unsigned char* tile) {
  return MN ? wgmma::desc_sw128_mn(tile, kBox) : wgmma::desc_sw128(tile);
}
template <bool MN> constexpr int kStep = MN ? 128 : 2;

template <int BN, bool GELU, bool TA, bool TB>
__global__ void __launch_bounds__(kHopperThreads, 1)
bwd_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b,
                const __grid_constant__ CUtensorMap map_a2,
                const __grid_constant__ CUtensorMap map_b2,
                const __grid_constant__ CUtensorMap map_g,
                const __grid_constant__ CUtensorMap map_da,
                const GemmArgs gm) {
  using L = GemmCfg<BN, GELU>;
  constexpr int S = L::kStages;
  unsigned char* sm = smem_1k();
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* empty = full + S;

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
        const Tile t = tile_at(gm, tile, BN);
        for (int kb = t.kb0; kb < t.kb1; ++kb) {
          mbar_wait(&empty[s], ph ^ 1);
          unsigned char* st = sm + s * L::kStageBytes;
          mbar_expect_tx(&full[s], L::kStageBytes);
          load_operand<TA>(st, &map_a, &full[s], kb, t.m0, kBM);
          load_operand<TB>(st + L::kABytes, &map_b, &full[s], kb, t.n0, BN);
          if (GELU) {
            unsigned char* st2 = st + L::kABytes + L::kBBytes;
            load_operand<false>(st2, &map_a2, &full[s], kb, t.m0, kBM);
            load_operand<true>(st2 + L::kABytes, &map_b2, &full[s], kb,
                               t.n0, BN);
          }
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
      const Tile t = tile_at(gm, tile, BN);
      const int m0 = t.m0 + wg * 64;             // this warpgroup's rows
      wg_sync(wg);                     // the last tile's epilogue is done
      float acc[BN / 2], acc2[GELU ? BN / 2 : 1];
      int prev = -1;
      for (int kb = t.kb0; kb < t.kb1; ++kb) {
        mbar_wait(&full[s], ph);
        const unsigned char* st = sm + s * L::kStageBytes;
        const uint64_t da = op_desc<TA>(st + wg * kBox);
        const uint64_t db = op_desc<TB>(st + L::kABytes);
        const int keep = kb > t.kb0;   // scale_d: add into acc
        wgmma::fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma::ss<BN, TA, TB>(acc, da + kStep<TA> * kk,
                                db + kStep<TB> * kk, keep | kk);
        if constexpr (GELU) {
          const unsigned char* st2 = st + L::kABytes + L::kBBytes;
          const uint64_t da2 = op_desc<false>(st2 + wg * kBox);
          const uint64_t db2 = op_desc<true>(st2 + L::kABytes);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma::ss<BN, 0, 1>(acc2, da2 + kStep<false> * kk,
                                db2 + kStep<true> * kk, keep | kk);
        }
        wgmma::commit();
        wgmma::wait<1>();              // the previous stage's products
        wgmma::fence_operands<BN / 2>(acc);
        if constexpr (GELU) wgmma::fence_operands<BN / 2>(acc2);
        if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = s;
        if (++s == S) { s = 0; ph ^= 1; }
      }
      wgmma::wait<0>();
      wgmma::fence_operands<BN / 2>(acc);
      if constexpr (GELU) wgmma::fence_operands<BN / 2>(acc2);
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);

      if constexpr (!GELU) {
        // fragment layout: rows r0 and r0 + 8, n8 group j's columns
        // 8 j + c0 + {0, 1} in acc[4 j .. 4 j + 3]
        float* out = gm.out + t.z * gm.z_stride;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int n = t.n0 + 8 * j + c0;
          if (n >= gm.N) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = m0 + r0 + 8 * h;
            if (row < gm.M)
              *reinterpret_cast<float2*>(out + (long long)row * gm.ld + n) =
                  make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          }
        }
      } else {
        bf16* gst = reinterpret_cast<bf16*>(sm + L::kEpi) +
                    wg * 2 * 64 * kEpiCols;
        bf16* dst = gst + 64 * kEpiCols;
        float* cs = reinterpret_cast<float*>(sm + L::kCs) + wg * 4 * BN;
#pragma unroll
        for (int p = 0; p < BN / kEpiCols; ++p) {
          if (p > 0) {                 // pass p - 1's stores read the tiles
            if (wt == 0) bulk_wait_read<0>();
            wg_sync(wg);
          }
#pragma unroll
          for (int j = 0; j < kEpiCols / 8; ++j) {
            const int col = 8 * j + c0, n = t.n0 + p * kEpiCols + col;
            const float2 bb = n < gm.N
                                  ? *reinterpret_cast<const float2*>(gm.b1 + n)
                                  : make_float2(0.f, 0.f);
            float s0 = 0.f, s1 = 0.f;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int i = 4 * (p * kEpiCols / 8 + j) + 2 * h;
              float g0, g1, d0, d1;
              gelu_pair(acc[i], bb.x, acc2[i], &g0, &d0);
              gelu_pair(acc[i + 1], bb.y, acc2[i + 1], &g1, &d1);
              *reinterpret_cast<uint32_t*>(gst + (r0 + 8 * h) * kEpiCols +
                                           col) = pack_bf16x2(g0, g1);
              *reinterpret_cast<uint32_t*>(dst + (r0 + 8 * h) * kEpiCols +
                                           col) = pack_bf16x2(d0, d1);
              s0 += d0;
              s1 += d1;
            }
            s0 = rows_sum(s0);
            s1 = rows_sum(s1);
            if (lane < 4) {
              cs[warp * BN + p * kEpiCols + col] = s0;
              cs[warp * BN + p * kEpiCols + col + 1] = s1;
            }
          }
          fence_async_smem();
          wg_sync(wg);
          if (wt == 0) {
            tma_store(&map_g, gst, t.n0 + p * kEpiCols, m0);
            tma_store(&map_da, dst, t.n0 + p * kEpiCols, m0);
            bulk_commit();
          }
        }
        if (wt == 0) bulk_wait_read<0>();
        wg_sync(wg);                   // every warp's column sums are in cs
        const int n = t.n0 + wt;
        if (wt < BN && n < gm.N)
          gm.vpart[(long long)(2 * t.mt + wg) * gm.N + n] =
              cs[wt] + cs[BN + wt] + cs[2 * BN + wt] + cs[3 * BN + wt];
      }
    }
  }
}

// The split of K: k blocks a split so that every split of `splits` has
// one at least; returns the splits that remain.
int split_k(GemmArgs* gm, int kb_total, int splits) {
  gm->kb_total = kb_total;
  gm->kb_split = (kb_total + splits - 1) / splits;
  return (kb_total + gm->kb_split - 1) / gm->kb_split;
}

template <int BN, bool GELU, bool TA, bool TB>
cudaError_t run_gemm(const CUtensorMap* m, GemmArgs gm, int splits, int sms,
                     cudaStream_t stream) {
  const auto kernel = bwd_gemm_kernel<BN, GELU, TA, TB>;
  const cudaError_t e = allow_smem(reinterpret_cast<const void*>(kernel));
  if (e != cudaSuccess) return e;
  gm.m_tiles = (gm.M + kBM - 1) / kBM;
  gm.n_tiles = (gm.N + BN - 1) / BN;
  gm.tiles = (long long)gm.m_tiles * gm.n_tiles * splits;
  const int grid = (int)(gm.tiles < sms ? gm.tiles : sms);
  kernel<<<grid, kHopperThreads, GemmCfg<BN, GELU>::kSmem, stream>>>(
      m[0], m[1], m[2], m[3], m[4], m[5], gm);
  return cudaGetLastError();
}

// Products 2, 3 and 5 in bf16 over the workspace (see launch_bwd).
cudaError_t products_bf16(const BArgs& a, long long Tp, float* dh,
                          float* vp_db1, float* chunks, float* wpart1,
                          float* wpart2, float* dvec, float* dw1, float* dw2,
                          int s1, int s2, bool full, cudaStream_t s) {
  const int Cp = a.Cp, Fp = a.Fp;
  const int sms = sm_count();
  CUtensorMap m[6];
  // 2. a = h W1^T, dg = do W2 -> g, da; db1
  bool ok = tensor_map(&m[0], a.hs, Tp, Cp, kBM) &&            // h, K-major
            tensor_map(&m[1], a.w1, Fp, Cp, 128) &&            // W1^T, K-major
            tensor_map(&m[2], a.dd, Tp, Cp, kBM, 64, true, 2 * Cp) &&  // do
            tensor_map(&m[3], a.w2, Cp, Fp, 64) &&   // W2^T [k = c][n = f]
            tensor_map(&m[4], a.gs, Tp, Fp, 64, kEpiCols, false) &&
            tensor_map(&m[5], a.das, Tp, Fp, 64, kEpiCols, false);
  if (!ok) return cudaErrorInvalidValue;
  GemmArgs g{};
  g.M = (int)Tp;
  g.N = Fp;
  split_k(&g, (Cp + kBK - 1) / kBK, 1);
  g.b1 = a.b1;
  g.vpart = vp_db1;
  cudaError_t e = run_gemm<128, true, false, false>(m, g, 1, sms, s);
  if (e != cudaSuccess) return e;
  if (full) {
    e = reduce_rows(vp_db1, dvec, Fp, (int)(2 * ((Tp + kBM - 1) / kBM)),
                    chunks, s);
    if (e != cudaSuccess) return e;
  }
  // 3. dh = da W1: A da (K-major), B W1^T [k = f][n = c] (MN-major)
  const int bn = pick_bn((Tp + kBM - 1) / kBM, Cp, sms, {128, 256});
  if (!tensor_map(&m[0], a.das, Tp, Fp, kBM) ||
      !tensor_map(&m[1], a.w1, Fp, Cp, 64))
    return cudaErrorInvalidValue;
  GemmArgs d{};
  d.M = (int)Tp;
  d.N = Cp;
  split_k(&d, Fp / kBK, 1);
  d.out = dh;
  d.ld = Cp;
  e = bn == 128 ? run_gemm<128, false, false, true>(m, d, 1, sms, s)
                : run_gemm<256, false, false, true>(m, d, 1, sms, s);
  if (e != cudaSuccess || !full) return e;
  // 5. dW1^T (Fp, Cp) = da^T h and [dW2^T; M] (2 Cp, Fp) = [do | dout]^T g,
  // K = the tokens: both operands MN-major
  const int kb_t = (int)(Tp / kBK);
  if (!tensor_map(&m[0], a.das, Tp, Fp, 64) ||
      !tensor_map(&m[1], a.hs, Tp, Cp, 64))
    return cudaErrorInvalidValue;
  GemmArgs w{};
  w.M = Fp;
  w.N = Cp;
  w.out = wpart1;
  w.ld = Cp;
  w.z_stride = (long long)Fp * Cp;
  int parts = split_k(&w, kb_t, s1);
  e = run_gemm<128, false, true, true>(m, w, parts, sms, s);
  if (e != cudaSuccess) return e;
  e = reduce(wpart1, dw1, (long long)Fp * Cp, parts, s);
  if (e != cudaSuccess) return e;
  if (!tensor_map(&m[0], a.dd, Tp, 2 * Cp, 64) ||
      !tensor_map(&m[1], a.gs, Tp, Fp, 64))
    return cudaErrorInvalidValue;
  w.M = 2 * Cp;
  w.N = Fp;
  w.out = wpart2;
  w.ld = Fp;
  w.z_stride = 2LL * Cp * Fp;
  parts = split_k(&w, kb_t, s2);
  e = run_gemm<128, false, true, true>(m, w, parts, sms, s);
  if (e != cudaSuccess) return e;
  return reduce(wpart2, dw2, 2LL * Cp * Fp, parts, s);
}

// ===========================================================================
// float32: products 2 and 3 as 3xTF32 on the tensor cores (TMA-fed wgmma)
//
// tf32_gemm.cuh's tf32_gemm_kernel (3xTF32: each operand as big and small
// TF32 planes, two-level fp32 sums). TF32 wgmma reads K-major operands
// only, so the weights enter as W1^T (Fp, Cp) for a = h W1^T, and as the
// transposed copies W2 (Fp, Cp) for dg = do W2 and W1 (Cp, Fp) for dh =
// da W1, all split by split_kernel each launch; h and do are split by
// wide_prep_kernel, da by the GELU epilogue (Tf32Epi::GeluBwd: a and dg on
// one tile, da's planes and the db1 column sums); dh is Tf32Epi::F32.
// ===========================================================================

// float32's split planes in the workspace
struct Tf32Planes {
  float* h;      // (2 Tp, Cp), by wide_prep_kernel
  float* dd;     // do's (2 Tp, Cp), by wide_prep_kernel
  float* ht;     // h transposed (2 Cp, Tp), by wide_prep_kernel (full)
  float* ddt;    // [do | dout] transposed (4 Cp, Tp), likewise
  float* da;     // (2 Tp, Fp), by the GELU epilogue
  float* w1t;    // W1^T's (2 Fp, Cp)
  float* w2;     // W2's (2 Fp, Cp)
  float* w1;     // W1's (2 Cp, Fp)
};

// Products 2 and 3 in float32 (see launch_bwd): the weights' planes, then
// a, dg -> da's planes (g, da whole in full mode); db1 (full mode); dh.
cudaError_t products_tf32(const BArgs& a, const Tf32Planes& p, long long Tp,
                          float* dh, float* vp_db1, float* chunks,
                          float* dvec, bool full, cudaStream_t s) {
  const int Cp = a.Cp, Fp = a.Fp, M = (int)Tp;
  const int sms = sm_count();
  cudaError_t e = split(a.w1, p.w1t, Fp, Cp, false, s);
  if (e == cudaSuccess) e = split(a.w2, p.w2, Cp, Fp, true, s);
  if (e == cudaSuccess) e = split(a.w1, p.w1, Fp, Cp, true, s);
  if (e != cudaSuccess) return e;
  CUtensorMap m[4];
  // 2. a = h W1^T, dg = do W2 -> da's planes; db1
  bool ok = tensor_map(&m[0], p.h, 2 * Tp, Cp, kBM, kKf, true, 0, true) &&
            tensor_map(&m[1], p.w1t, 2LL * Fp, Cp, kBNf, kKf, true, 0, true) &&
            tensor_map(&m[2], p.dd, 2 * Tp, Cp, kBM, kKf, true, 0, true) &&
            tensor_map(&m[3], p.w2, 2LL * Fp, Cp, kBNf, kKf, true, 0, true);
  if (!ok) return cudaErrorInvalidValue;
  Tf32Args g{};
  g.M = M;
  g.N = Fp;
  g.kb = (Cp + kKf - 1) / kKf;
  g.b1 = a.b1;
  g.vpart = vp_db1;
  g.planes = p.da;
  g.g = full ? static_cast<float*>(a.gs) : nullptr;
  g.da_full = full ? static_cast<float*>(a.das) : nullptr;
  e = run_tf32<Tf32Epi::GeluBwd>(m, g, sms, s);
  if (e != cudaSuccess) return e;
  if (full) {
    e = reduce_rows(vp_db1, dvec, Fp, 2 * ((M + kBM - 1) / kBM), chunks, s);
    if (e != cudaSuccess) return e;
  }
  // 3. dh = da W1
  ok = tensor_map(&m[0], p.da, 2 * Tp, Fp, kBM, kKf, true, 0, true) &&
       tensor_map(&m[1], p.w1, 2LL * Cp, Fp, kBNf, kKf, true, 0, true);
  if (!ok) return cudaErrorInvalidValue;
  m[2] = m[0];
  m[3] = m[1];
  Tf32Args d{};
  d.M = M;
  d.N = Cp;
  d.kb = Fp / kKf;
  d.out = dh;
  return run_tf32<Tf32Epi::F32>(m, d, sms, s);
}

// ===========================================================================
// float32 step 5: the token reductions as 3xTF32 on the tensor cores
//
// out (M x N) = sum over the tokens t of A[t][m] B[n][t], M = Fp: dW1^T =
// da^T h (N = Cp) and g^T [do | dout] (N = 2 Cp, stored transposed: dw2's
// [dW2^T; M], (2 Cp, Fp), as dgamma_kernel and the wrapper read it). K is
// the tokens, and TF32 wgmma reads shared-memory operands K-major only. So
// the wide operand, da or g (token-major, whole, from the GELU epilogue),
// is wgmma's A taken from registers: the producer thread loads it with TMA
// as [32 tokens][32 m] boxes in the 128-byte swizzle, and each consumer
// thread reads its fragments from shared memory and splits them into big
// and small TF32 parts in registers. The narrow operand, h or [do | dout],
// is B, K-major in shared memory: wide_prep_kernel writes its big and
// small planes transposed (PrepF32::ht, ::ddt). A k block of 32 tokens
// runs 12 wgmma (small A x big B, big A x small B, big A x big B, four
// k steps of 8) into a fresh partial, which is added into the tile's sums
// in fp32 (as tf32_gemm_kernel does: the tensor cores' sums drift with K,
// and K here is up to 80000 tokens). The consumers' own work sets the
// pace (on an H100 the kernel runs only 5-12% faster with no stage loaded
// at all), so each thread reads and splits the next block's fragments
// while this block's wgmma run (two fragment sets in turns: 6-10% faster
// than reading them after the wait, with the same bits;
// tools/probe_mlp_bwd.py --ablate). A tile is 128 rows of
// M (64 a consumer warpgroup) x kWBN columns x one split of the tokens,
// the column tile fastest; blocks are persistent, one an SM; the splits'
// partials are added in order by sum_partials. No atomics: the same bits
// every run.
//
// A's shared-memory reads: fragment row r of warp w holds m = 32 (w / 2) +
// 16 (g / 4) + 8 (w % 2) + 4 (r >= 8) + g % 4 of its warpgroup's 64 (g =
// lane / 4), a permutation of the rows that the epilogue undoes: then the
// 32 lanes of a fragment read (16-byte chunk (m / 4) ^ (t % 8), the
// swizzle, word m % 4) on 32 different banks.
// ===========================================================================

constexpr int kWBN = 128;                // columns a tile
constexpr int kWKt = 32;                 // tokens a k block (128 bytes)

struct WgArgs {
  int M, N;              // rows m < M, columns n < N (B's big plane rows)
  int kb_total;          // 32-token k blocks of the tokens
  int kb_split;          // k blocks a split
  int m_tiles, n_tiles;
  long long tiles;       // m_tiles * n_tiles * splits
  float* out;            // (splits, M, ld), or transposed (splits, N, ld)
  long long ld, z_stride;
  int trans;
};

struct WgCfg {
  static constexpr int kABox = kWKt * 128;       // [32 tokens][32 m] fp32
  static constexpr int kABytes = (kBM / 32) * kABox;
  static constexpr int kBBytes = kWBN * 128;     // one plane's [n][32 tokens]
  static constexpr int kStageBytes = kABytes + 2 * kBBytes;
  static constexpr size_t kAvail = kSmemMax - 1024 - 16 * sizeof(uint64_t);
  static constexpr int kStages =
      kAvail / kStageBytes > 6 ? 6 : (int)(kAvail / kStageBytes);
  static constexpr size_t kBar = (size_t)kStages * kStageBytes;
  static constexpr size_t kSmem = 1024 + kBar + 2 * kStages * sizeof(uint64_t);
  static_assert(kStages >= 2 && kSmem <= kSmemMax, "fits a block");
};

__global__ void __launch_bounds__(kHopperThreads, 1)
wgrad_tf32_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b,
                  const WgArgs gm) {
  using L = WgCfg;
  constexpr int S = L::kStages, R = kWBN / 2;
  unsigned char* sm = smem_1k();
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* empty = full + S;
  const long long mn = (long long)gm.m_tiles * gm.n_tiles;

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
        const long long z = tile / mn;
        const int i = (int)(tile - z * mn), mt = i / gm.n_tiles;
        const int m0 = mt * kBM, n0 = (i - mt * gm.n_tiles) * kWBN;
        const int kb0 = (int)z * gm.kb_split;
        const int kb1 = min(gm.kb_total, kb0 + gm.kb_split);
        for (int kb = kb0; kb < kb1; ++kb) {
          mbar_wait(&empty[s], ph ^ 1);
          unsigned char* st = sm + s * L::kStageBytes;
          mbar_expect_tx(&full[s], L::kStageBytes);
          // A's boxes of 32 m; one wholly past M loads a box inside it
          // instead (its rows are not stored)
          for (int j = 0; j < kBM / 32; ++j)
            tma_load(st + j * L::kABox, &map_a, &full[s],
                     min(m0 + 32 * j, gm.M - 32), kb * kWKt);
          tma_load(st + L::kABytes, &map_b, &full[s], kb * kWKt, n0);
          tma_load(st + L::kABytes + L::kBBytes, &map_b, &full[s],
                   kb * kWKt, gm.N + n0);
          if (++s == S) { s = 0; ph ^= 1; }
        }
      }
    }
  } else {                                       // consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
    const int warp = (threadIdx.x >> 5) & 3, g = lane >> 2, q = lane & 3;
    // byte offsets in a stage of the fragment words a0 and a2 (j = 0: row
    // g, tokens q and q + 4) and a1 and a3 (j = 1: row g + 8, m + 4) of the
    // first k step; k step kk is 8 rows (1024 bytes) further
    const int chunk = 4 * (g >> 2) + 2 * (warp & 1);
    const int box = (2 * wg + (warp >> 1)) * L::kABox + 4 * (g & 3);
    int off[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = q + 4 * h;
        off[j][h] = box + row * 128 + (((chunk + j) ^ row) << 4);
      }
    // the rows of this thread's sums: m_row and m_row + 4 (see above)
    const int m_row = 64 * wg + 32 * (warp >> 1) + 16 * (g >> 2) +
                      8 * (warp & 1) + (g & 3);
    int s = 0, ph = 0;
    for (long long tile = blockIdx.x; tile < gm.tiles; tile += gridDim.x) {
      const long long z = tile / mn;
      const int i = (int)(tile - z * mn), mt = i / gm.n_tiles;
      const int m0 = mt * kBM, n0 = (i - mt * gm.n_tiles) * kWBN;
      const int kb0 = (int)z * gm.kb_split;
      const int kb1 = min(gm.kb_total, kb0 + gm.kb_split);
      float sum[R], p[R];
#pragma unroll
      for (int r = 0; r < R; ++r) sum[r] = 0.f;
      // the A fragments of a k block's four k steps from stage st, split
      // in registers
      const auto load_a = [&](uint32_t (&bg)[4][4], uint32_t (&sl)[4][4],
                              const unsigned char* st) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float x = *reinterpret_cast<const float*>(
                st + off[r & 1][r >> 1] + kk * 1024);
            const float b = tf32_big(x);
            bg[kk][r] = __float_as_uint(b);
            sl[kk][r] = __float_as_uint(tf32_big(x - b));
          }
      };
      // block kb's 12 wgmma from stage s with the fragments (bg, sl); while
      // they run, block kb + 1's fragments into (nb, ns); then block kb's
      // partial into the sums and its stage back to the producer
      const auto step = [&](int kb, uint32_t (&bg)[4][4],
                            uint32_t (&sl)[4][4], uint32_t (&nb)[4][4],
                            uint32_t (&ns)[4][4]) {
        const unsigned char* st = sm + s * L::kStageBytes;
        const uint64_t b = wgmma::desc_sw128(st + L::kABytes);
        const uint64_t bs = wgmma::desc_sw128(st + L::kABytes + L::kBBytes);
        wgmma::fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma::tf32_rs<kWBN>(p, sl[kk], b + 2 * kk, kk);
          wgmma::tf32_rs<kWBN>(p, bg[kk], bs + 2 * kk, 1);
          wgmma::tf32_rs<kWBN>(p, bg[kk], b + 2 * kk, 1);
        }
        wgmma::commit();
        const int s2 = s + 1 == S ? 0 : s + 1;
        const int ph2 = s + 1 == S ? ph ^ 1 : ph;
        if (kb + 1 < kb1) {
          mbar_wait(&full[s2], ph2);
          load_a(nb, ns, sm + s2 * L::kStageBytes);
        }
        wgmma::wait<0>();
        wgmma::fence_operands<R>(p);
        if (lane == 0) mbar_arrive(&empty[s]);
        add_into<R>(sum, p);
        s = s2;
        ph = ph2;
      };
      uint32_t big0[4][4], small0[4][4], big1[4][4], small1[4][4];
      mbar_wait(&full[s], ph);
      load_a(big0, small0, sm + s * L::kStageBytes);
      for (int kb = kb0; kb < kb1; kb += 2) {
        step(kb, big0, small0, big1, small1);
        if (kb + 1 < kb1) step(kb + 1, big1, small1, big0, small0);
      }
      // fragment layout: rows m_row + 4 h, n8 group j's columns
      // 8 j + 2 q + {0, 1} in sum[4 j + 2 h .. + 1]
      float* out = gm.out + z * gm.z_stride;
#pragma unroll
      for (int j = 0; j < kWBN / 8; ++j) {
        const int n = n0 + 8 * j + 2 * q;
        if (n >= gm.N) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long m = m0 + m_row + 4 * h;
          if (m >= gm.M) continue;
          const float v0 = sum[4 * j + 2 * h], v1 = sum[4 * j + 2 * h + 1];
          if (gm.trans) {
            out[n * gm.ld + m] = v0;
            out[(n + 1) * gm.ld + m] = v1;
          } else {
            *reinterpret_cast<float2*>(out + m * gm.ld + n) =
                make_float2(v0, v1);
          }
        }
      }
    }
  }
}

// One token reduction (see the section comment): A (Tp, M) token-major,
// B's planes (2 N, Tp); out (M, N) or, trans, (N, M), through `part`
// (splits, M, N) when the tokens are split.
cudaError_t wgrad_tf32(const void* A, const float* B, long long Tp, int M,
                       int N, int splits, bool trans, float* part,
                       float* out, int sms, cudaStream_t s) {
  const auto kernel = wgrad_tf32_kernel;
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(kernel));
  if (e != cudaSuccess) return e;
  CUtensorMap m[2];
  if (!tensor_map(&m[0], A, Tp, M, kWKt, 32, true, 0, true) ||
      !tensor_map(&m[1], B, 2LL * N, (int)Tp, kWBN, kWKt, true, 0, true))
    return cudaErrorInvalidValue;
  WgArgs w{};
  w.M = M;
  w.N = N;
  w.kb_total = (int)(Tp / kWKt);
  w.kb_split = (w.kb_total + splits - 1) / splits;
  const int parts = (w.kb_total + w.kb_split - 1) / w.kb_split;
  w.m_tiles = (M + kBM - 1) / kBM;
  w.n_tiles = (N + kWBN - 1) / kWBN;
  w.tiles = (long long)w.m_tiles * w.n_tiles * parts;
  w.out = parts == 1 ? out : part;
  w.ld = trans ? M : N;
  w.z_stride = (long long)M * N;
  w.trans = trans;
  const int grid = (int)(w.tiles < sms ? w.tiles : sms);
  kernel<<<grid, kHopperThreads, WgCfg::kSmem, s>>>(m[0], m[1], w);
  e = cudaGetLastError();
  if (e != cudaSuccess || parts == 1) return e;
  return reduce(part, out, (long long)M * N, parts, s);
}

// The workspace, compute dtype of `e` bytes: in bf16 hs (Tp, Cp) and dd
// (Tp, 2 Cp); gs and das (Tp, Fp) in the compute dtype; dh (Tp, Cp),
// stats (Tp, 2), the per-token kernels' partials (Tp / token_tile, 2 Cp)
// twice, db1's (Tp / 64, Fp: a row each 64 tokens, a consumer
// warpgroup's), reduce_rows' chunk sums, wpart1 (s1, Fp, Cp), wpart2 (s2,
// 2 Cp, Fp) float32; in float32 also the split planes (Tf32Planes).
struct WLayout {
  size_t hs, dd, gs, das, dh, stats, vp_prep, vp_lnb, vp_db1, chunks, wpart1,
      wpart2, sp_h, sp_dd, sp_ht, sp_ddt, sp_da, sp_w1t, sp_w2, sp_w1, total;
};

inline WLayout w_layout(size_t e, long long Tp, int Cp, int Fp, int s1,
                        int s2) {
  const size_t tp = (size_t)Tp, cp = (size_t)Cp, fp = (size_t)Fp;
  const size_t nb = tp / token_tile(e, Cp), nm = tp / 64;
  const size_t f32 = e == 4 ? 2 * sizeof(float) : 0;   // two planes
  WLayout L;
  size_t o = 0;
  const size_t bf = e == 2 ? e : 0;           // hs and dd: bf16 only
  L.hs = take(&o, tp * cp * bf);
  L.dd = take(&o, tp * 2 * cp * bf);
  L.gs = take(&o, tp * fp * e);
  L.das = take(&o, tp * fp * e);
  L.dh = take(&o, tp * cp * sizeof(float));
  L.stats = take(&o, tp * 2 * sizeof(float));
  L.vp_prep = take(&o, nb * 2 * cp * sizeof(float));
  L.vp_lnb = take(&o, nb * 2 * cp * sizeof(float));
  L.vp_db1 = take(&o, nm * fp * sizeof(float));
  L.chunks = take(&o, (nb / kChunk + 1) * (2 * cp > fp ? 2 * cp : fp) *
                          sizeof(float));
  L.wpart1 = take(&o, (size_t)s1 * fp * cp * sizeof(float));
  L.wpart2 = take(&o, (size_t)s2 * 2 * cp * fp * sizeof(float));
  L.sp_h = take(&o, tp * cp * f32);
  L.sp_dd = take(&o, tp * cp * f32);
  L.sp_ht = take(&o, tp * cp * f32);
  L.sp_ddt = take(&o, tp * 2 * cp * f32);
  L.sp_da = take(&o, tp * fp * f32);
  L.sp_w1t = take(&o, fp * cp * f32);
  L.sp_w2 = take(&o, fp * cp * f32);
  L.sp_w1 = take(&o, fp * cp * f32);
  L.total = o;
  return L;
}

// The launch sequence; full = false is dy-only mode (dw1, dw2 and dvec
// are not written and may be null).
template <typename T, typename DY, int BT>
cudaError_t launch_bwd(BArgs a, void* ws, float* dw1, float* dw2,
                       float* dvec, int s1, int s2, bool full,
                       cudaStream_t s) {
  constexpr bool kBf16 = sizeof(T) == 2;
  const int C = a.C, Cp = a.Cp, Fp = a.Fp;
  const long long Tp = (a.n_outer * a.P + kWPadT - 1) / kWPadT * kWPadT;
  const WLayout W = w_layout(sizeof(T), Tp, Cp, Fp, s1, s2);
  unsigned char* base = static_cast<unsigned char*>(ws);
  const auto at = [&](size_t off) {
    return reinterpret_cast<float*>(base + off);
  };
  a.hs = base + W.hs;
  a.dd = base + W.dd;
  a.gs = base + W.gs;
  a.das = base + W.das;
  a.stats = at(W.stats);
  a.vpart_a = at(W.vp_prep);
  a.vpart_b = at(W.vp_lnb);
  a.BT = BT;
  float* dh = at(W.dh);
  float* vp_db1 = at(W.vp_db1);
  float* chunks = at(W.chunks);
  const Tf32Planes planes{at(W.sp_h),  at(W.sp_dd),  at(W.sp_ht),
                          at(W.sp_ddt), at(W.sp_da),  at(W.sp_w1t),
                          at(W.sp_w2),  at(W.sp_w1)};
  const PrepF32 sp{planes.h, planes.dd, planes.ht, planes.ddt, Tp, full};
  const size_t smem_t = t_layout(Cp, BT).total;
  if (smem_t > kSmemMax) return cudaErrorInvalidConfiguration;
  const int nb = (int)(Tp / BT);

  // 1. LayerNorm, h, do, dout; db2 and sum_t dout
  cudaError_t e = run(wide_prep_kernel<T, BT>, nb, smem_t, s, a, sp);
  if (e != cudaSuccess) return e;
  if (full) {
    e = reduce_rows(a.vpart_a, dvec + Fp, 2LL * Cp, nb, chunks, s);
    if (e != cudaSuccess) return e;
  }
  if constexpr (kBf16) {
    // 2, 3 and 5 on the tensor cores
    e = products_bf16(a, Tp, dh, vp_db1, chunks, at(W.wpart1),
                      at(W.wpart2), dvec, dw1, dw2, s1, s2, full, s);
    if (e != cudaSuccess) return e;
  } else {
    // 2 and 3 as 3xTF32 on the tensor cores
    e = products_tf32(a, planes, Tp, dh, vp_db1, chunks, dvec, full, s);
    if (e != cudaSuccess) return e;
    if (full) {
      // 5. dW1^T = da^T h ; [dW2^T ; M] = ([do | dout]^T g), as 3xTF32
      const int sms = sm_count();
      e = wgrad_tf32(a.das, planes.ht, Tp, Fp, Cp, s1, false, at(W.wpart1),
                     dw1, sms, s);
      if (e != cudaSuccess) return e;
      e = wgrad_tf32(a.gs, planes.ddt, Tp, Fp, 2 * Cp, s2, true,
                     at(W.wpart2), dw2, sms, s);
      if (e != cudaSuccess) return e;
    }
  }
  // 4. the LayerNorm backward: dy; dLN-scale, dLN-bias
  e = run(wide_lnb_kernel<T, DY, BT>, nb, smem_t, s, a, (const float*)dh);
  if (e != cudaSuccess || !full) return e;
  e = reduce_rows(a.vpart_b, dvec + Fp + 2 * Cp, 2LL * Cp, nb, chunks, s);
  if (e != cudaSuccess) return e;
  // dgamma from M, the last Cp rows of dw2
  dgamma_kernel<T><<<(Cp + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      static_cast<const T*>(a.w2), dw2 + (long long)Cp * Fp, a.vec + 2 * C,
      dvec + Fp + Cp, dvec + Fp + 4 * Cp, C, Cp, Fp);
  return cudaGetLastError();
}

// The checks and the dispatch of both entry points: dy in float32
// (dy_f32) or in the compute dtype; full = false: dy-only mode.
int launch(bool dy_f32, int dtype, const void* y, const void* dout, void* dy,
           const void* w1, const void* w2, const float* b1, const float* vec,
           void* ws, float* dw1, float* dw2, float* dvec, long long n_outer,
           long long P, long long sN, long long sC, long long sP, int C,
           int Cp, int Fp, int s1, int s2, bool full, void* stream) {
  if (Cp % 16 || Fp % 64 || C < 1 || C > Cp || s1 < 1 || s2 < 1 ||
      (full && (dw1 == nullptr || dw2 == nullptr || dvec == nullptr)))
    return (int)cudaErrorInvalidValue;
  BArgs a{y, dout, dy, w1, w2, b1, vec, nullptr, nullptr, nullptr, nullptr,
          nullptr, nullptr, nullptr, n_outer, P, sN, sC, sP, C, Cp, Fp, kWT};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)(token_tile(sizeof(float), Cp) == kWTF32Narrow
                     ? launch_bwd<float, float, kWTF32Narrow>(
                           a, ws, dw1, dw2, dvec, s1, s2, full, s)
                     : launch_bwd<float, float, kWT>(a, ws, dw1, dw2, dvec,
                                                     s1, s2, full, s));
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const bool narrow = token_tile(sizeof(bf16), Cp) == kWTNarrow;
  if (dy_f32)
    return (int)(narrow ? launch_bwd<bf16, float, kWTNarrow>(
                              a, ws, dw1, dw2, dvec, s1, s2, full, s)
                        : launch_bwd<bf16, float, kWT>(a, ws, dw1, dw2, dvec,
                                                       s1, s2, full, s));
  return (int)(narrow ? launch_bwd<bf16, bf16, kWTNarrow>(
                            a, ws, dw1, dw2, dvec, s1, s2, full, s)
                      : launch_bwd<bf16, bf16, kWT>(a, ws, dw1, dw2, dvec,
                                                    s1, s2, full, s));
}

}  // namespace

// The bytes of the workspace slak_mlp_bwd and slak_mlp_bwd_wide take for
// dtype (0 = float32, 1 = bfloat16), Tp = the tokens rounded up to 128,
// and the two token-reduction products' token splits s1 and s2 (-1 for a
// bad dtype).
extern "C" long long slak_mlp_bwd_workspace(int dtype, long long Tp, int Cp,
                                            int Fp, int s1, int s2) {
  if (dtype != 0 && dtype != 1) return -1;
  return (long long)w_layout(dtype == 1 ? 2 : 4, Tp, Cp, Fp, s1, s2).total;
}

// K8: the tail's backward; dtype 0 = float32, 1 = bfloat16. y, dout, dy:
// strided activations as in slak_fused_mlp (element (token n*P + p,
// channel c) at n*sN + c*sC + p*sP), dy in the compute dtype; W1^T (Fp,
// Cp), W2^T (Cp, Fp) in the compute dtype with Cp a multiple of 16 and Fp
// of 64; b1 (Fp) and vec (5, C: ln_scale, ln_bias, b2, gamma, pre_bias)
// float32; ws: slak_mlp_bwd_workspace bytes. Outputs, float32: dw1 = dW1^T
// (Fp, Cp); dw2 (2 Cp, Fp), whose first Cp rows are dW2^T; dvec = [db1
// (Fp) | db2 | (sum_t dout) | dlns | dlnb | dgamma (Cp each)]. dy_only:
// dy alone, and dw1, dw2 and dvec may be null. Returns the cudaError_t of
// the launches.
extern "C" int slak_mlp_bwd(int dtype, const void* y, const void* dout,
                            void* dy, const void* w1, const void* w2,
                            const float* b1, const float* vec, void* ws,
                            float* dw1, float* dw2, float* dvec,
                            long long n_outer, long long P, long long sN,
                            long long sC, long long sP, int C, int Cp,
                            int Fp, int s1, int s2, int dy_only,
                            void* stream) {
  return launch(false, dtype, y, dout, dy, w1, w2, b1, vec, ws, dw1, dw2,
                dvec, n_outer, P, sN, sC, sP, C, Cp, Fp, s1, s2, !dy_only,
                stream);
}

// K9: the same at any width, dy float32 (shaped and strided like y), as
// the TPU kernel's dy.
extern "C" int slak_mlp_bwd_wide(int dtype, const void* y, const void* dout,
                                 float* dy, const void* w1, const void* w2,
                                 const float* b1, const float* vec, void* ws,
                                 float* dw1, float* dw2, float* dvec,
                                 long long n_outer, long long P, long long sN,
                                 long long sC, long long sP, int C, int Cp,
                                 int Fp, int s1, int s2, int dy_only,
                                 void* stream) {
  return launch(true, dtype, y, dout, dy, w1, w2, b1, vec, ws, dw1, dw2,
                dvec, n_outer, P, sN, sC, sP, C, Cp, Fp, s1, s2, !dy_only,
                stream);
}
