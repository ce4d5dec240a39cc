// Backward of the fused ConvNeXt block tail
//   out = res + gamma * (GELU(LN(y + pre_bias) @ W1 + b1) @ W2 + b2):
// dy, dW1, dW2, db1, db2, dgamma, dLN-scale and dLN-bias. Two entry points:
// slak_mlp_bwd (K8, C <= 256, below) and slak_mlp_bwd_wide (K9, any C, the
// section at the end).
//
// K8 replaces slak_tpu/ops/pallas_mlp.py: _mlp_bwd_2d (_mlp_bwd_kernel). The
// TPU kernel walks the token tiles in order and keeps dW1 and dW2 in a
// resident output block that every tile adds into. Blocks here run in
// parallel, and at C = 249 the fp32 dW1 + dW2 are 2 MB, which fits in no
// SM; a tile of tokens is far too short a reduction to add into a global
// copy each time. So the work is split by what each output reduces over:
// token-tile kernels do the per-token work and write the rounded operands
// of the weight gradients (h, do, g, da) to scratch, and the weight
// gradients are token-reduction GEMMs over that scratch.
//
// bf16 (tensor cores: raw mma.sync m16n8k16 + ldmatrix, fp32 accumulators
// in registers; 8 warps and 128 tokens a block, 16 tokens a warp):
// 1. mlp_bwd_a_kernel, persistent (one block an SM walking every
//    gridDim-th tile): the LayerNorm (mean and inv to scratch), h, do =
//    dout * gamma rounded; then per chunk of FC hidden units, its W1^T
//    rows and W2^T columns double-buffered with cp.async:
//      a = h W1^T + b1, g = GELU(a) rounded, dg = do W2,
//      da = dg gelu'(a) rounded.
//    h, [do | dout], g and da go to scratch; db1, db2 and sum_t dout sum
//    in the block.
// 2. mlp_bwd_b_kernel, persistent: dh = da W1 over the chunks of da and
//    W1^T (double-buffered), then the LayerNorm backward in registers: dy,
//    stored through the forward's (sN, sC, sP) strides (NCHW with no
//    transpose), and the dLN-scale and dLN-bias sums of the block.
// 3. mlp_bwd_gemm_kernel: part[z] = A^T B over split z of the tokens
//    (128 x 128 output tiles, 3-stage cp.async, ldmatrix.trans):
//    dW1^T = da^T h and, in one launch, [dW2^T; M] = [do | dout]^T g.
// 4. dgamma_kernel: dgamma = sum_f W2^T[c, f] M[c, f] + b2[c] sum_t dout.
//    That is sum_t dout * (g W2^T + b2), so the per-token o_pre = g W2^T
//    is never formed, and kernel 1 holds only 16 x FC accumulators a warp.
// The block and split partials are added by sum_partials in a fixed
// order. No atomics: every run gives the same bits.
//
// float32 (the differentiated eval's ERF path at stages 1-2) runs K9's
// kernels (slak_mlp_bwd_wide, below), which cover any width; the wrapper
// calls that entry point for float32.
//
// Rounding follows _mlp_bwd_kernel: LN statistics, a, gelu, dg, da and dh
// in fp32; h, g, do and da rounded to the compute dtype before the
// products that use them; exact erf. The weights are pack_mlp's W1^T
// (Fp, Cp) and W2^T (Cp, Fp), zero-padded, so the padded channels and
// hidden units give zero gradients that the wrapper slices away.
//
// What bounds it on an H100: the six products (kernels 1-3), 12*T*C*4C
// operations, at 989 TFLOP/s bf16: about 0.3 ms a launch at stages 1-2,
// batch 128. This design also moves h, do, dout, g and da through device
// memory (at stage 1, batch 128, about 2.7 GB written and read once: 0.8
// ms at 3.35 TB/s); keeping g and da on chip, and wgmma, are the next
// steps.
//
// K9 replaces pallas_mlp.py: _mlp_bwd_chunked_2d (_mlp_bwd_chunked_kernel),
// the backward of the wide tails (C = 499 and 998 at SLaK-T w1.3's stages
// 3-4), which backs differentiated eval (the ERF analysis) in float32 and
// bfloat16. The TPU kernel walks a sequential grid (token tiles, 4C
// chunks): dW1/dW2/db1 blocks are added into across token tiles, dh into
// the dy block across chunks, and the LayerNorm backward runs on the last
// chunk. K8's design does not stretch that far: its kernel 2 holds dh as
// 16 x Cp accumulators a warp (about 500 registers a thread at Cp = 1008)
// and its kernel 1 stages a 128-token h tile (258 KB at Cp = 1008, above a
// block's 227 KB). So K9 carries no sum between blocks and keeps no whole
// row of dh on chip; every step is a separate launch over scratch:
//  1. wide_prep_kernel, 32 tokens a block: the LayerNorm (mean and inv to
//     scratch), h -> hs and [do | dout] -> dd, rounded; the block's column
//     sums of do and dout.
//  2. wide_{tc,simt}_kernel<true>: a = h W1^T and dg = do W2 as tiled
//     products over C (two accumulator sets), the epilogue g = GELU(a + b1)
//     and da = dg gelu'(a + b1) -> gs, das (rounded), and the block's
//     column sums of da (db1).
//  3. wide_{tc,simt}_kernel<false>: dh = da W1 -> f32 scratch.
//  4. wide_lnb_kernel, 32 tokens a block: the LayerNorm backward from the
//     whole dh row (a warp a token), dy in f32 through the forward's
//     strides; the block's column sums of dh xhat and dh.
//  5. K8's token-reduction GEMMs and dgamma_kernel: dW1^T = da^T h,
//     [dW2^T; M] = [do | dout]^T g, dgamma = sum_f W2^T M + b2 sum_t dout.
// Partials are summed by sum_partials in a fixed order: no atomics. bf16
// runs the products on the tensor cores (mma.sync, 128 x 64 tiles), f32 on
// the CUDA cores (simt_tile.cuh: 64 x 64 tiles, 4 x 4 a thread, shared with
// K2/K3's f32 path and the f32 token-reduction GEMMs). Padding: the weights
// are pack_mlp's, zero-padded to Cp (a multiple of 16) and Fp (of 64); the
// product kernels load zeros past K and N, the per-token kernels mask the
// ragged channels and tokens, so padded hidden units and channels give
// exactly zero gradients, which the wrapper slices away.
// What bounds it: the six products, 12*T*C*4C operations: about 49 GFLOP a
// launch at both ERF shapes (T = 4096, C = 499 and T = 1024, C = 998), 0.73
// ms at 67 TFLOP/s f32; 0.30 TFLOP at bf16 batch 128's stage 3 (T = 25088),
// 0.30 ms at 989 TFLOP/s. The scratch traffic (h, do, dout, g, da in the
// compute dtype, dh in f32, each written once and read about twice) is
// about 48*T*Cp + 24*T*Fp bytes in f32: 0.3 GB at the ERF's stage 3, 0.09
// ms at 3.35 TB/s, so the products bound it; wgmma/TMA and keeping g and da
// on chip are the later steps.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "simt_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBT = 16 * kWarps;   // tokens a block in the bf16 kernels
constexpr int kPad = 8;            // row padding of the shared tiles
constexpr float kLnEps = 1e-6f;
constexpr float kInvSqrt2 = 0.70710678118654752f;
constexpr float kInvSqrt2Pi = 0.39894228040143268f;
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

// the sum over the 8 lanes that share lane & 3 (the rows of an mma tile)
__device__ __forceinline__ float rows_sum(float v) {
  for (int o = 4; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the sum over the 4 lanes that share lane >> 2 (a row of an mma tile)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned addr, unsigned* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
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

// ldmatrix lane addresses (row, column) of the 8x8 pieces:
//  A 16x16 from [m][k] storage (non-trans);
//  B, a pair of n8 tiles x k16, from [n][k] storage (non-trans);
//  B, a pair of n8 tiles x k16, from [k][n] storage (trans);
//  A 16x16 from [k][m] storage (trans).
struct Lanes {
  int a_row, a_col, b_row, b_col, bt_k, bt_n, at_k, at_m;
  __device__ explicit Lanes(int lane)
      : a_row(lane & 15), a_col((lane >> 4) * 8),
        b_row((lane & 7) + ((lane >> 4) << 3)), b_col(((lane >> 3) & 1) * 8),
        bt_k((lane & 7) + (((lane >> 3) & 1) << 3)), bt_n((lane >> 4) * 8),
        at_k((lane & 7) + ((lane >> 4) << 3)), at_m(((lane >> 3) & 1) * 8) {}
};

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
  float* vpart_a;      // partials: (grid, Fp + 2 Cp) K8, (Tp/32, 2 Cp) K9
  float* vpart_b;      // partials: (grid, 2 Cp) K8, (Tp/32, 2 Cp) K9
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

// Copy `rows` rows of `cols` elements (a multiple of 16 bytes) from src
// (pitch sp) to dst (pitch dp), 16 bytes a thread at a time.
template <typename T>
__device__ void copy_rows(T* dst, long long dp, const T* src, long long sp,
                          int rows, int cols) {
  constexpr int V = 16 / sizeof(T);
  const int per_row = cols / V;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row, v = i - r * per_row;
    *reinterpret_cast<uint4*>(dst + r * dp + v * V) =
        *reinterpret_cast<const uint4*>(src + r * sp + v * V);
  }
}

// dst [rows][ld] <- `rows` rows of `cols` (a multiple of 8) elements of src
// (pitch sp), with cp.async
__device__ void async_rows(bf16* dst, int ld, const bf16* src, long long sp,
                           int rows, int cols) {
  const int per_row = cols / 8;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row, v = i - r * per_row;
    cp_async16(dst + r * ld + v * 8, src + r * sp + v * 8);
  }
}

// ---------------------------------------------------------------------------
// bf16 kernel 1: LayerNorm, a, g, dg, da
//
// Shared layout (LDA = Cp + kPad, LDF = FC + kPad):
//   hs [BT][LDA] | ds [BT][LDA] (y, then dout, then do) |
//   w 2 x (W1^T rows [FC][LDA] + W2^T columns [Cp][LDF]) |
//   pdb1 [2][kWarps][FC] f32 | vacc [Fp + 2 Cp] f32 | tok [BT] i64
// ---------------------------------------------------------------------------

struct ALayout {
  size_t hs, ds, w, pdb1, vacc, tok, total;
};

__host__ __device__ inline ALayout a_layout(int Cp, int Fp, int FC) {
  const size_t LDA = Cp + kPad, LDF = FC + kPad;
  ALayout L;
  size_t o = 0;
  L.hs = take(&o, kBT * LDA * sizeof(bf16));
  L.ds = take(&o, kBT * LDA * sizeof(bf16));
  L.w = take(&o, 2 * (FC * LDA + Cp * LDF) * sizeof(bf16));
  L.pdb1 = take(&o, 2 * kWarps * FC * sizeof(float));
  L.vacc = take(&o, (Fp + 2 * Cp) * sizeof(float));
  L.tok = take(&o, kBT * sizeof(long long));
  L.total = o;
  return L;
}

// the chunk's W1^T rows [f0, f0+FC) and W2^T columns [f0, f0+FC)
template <int FC>
__device__ void load_w_chunk(const BArgs& a, int f0, bf16* w1s, bf16* w2s) {
  const bf16* w1 = static_cast<const bf16*>(a.w1);
  const bf16* w2 = static_cast<const bf16*>(a.w2);
  async_rows(w1s, a.Cp + kPad, w1 + (size_t)f0 * a.Cp, a.Cp, FC, a.Cp);
  async_rows(w2s, FC + kPad, w2 + f0, a.Fp, a.Cp, FC);
}

// v[f] += the kWarps rows of p (kWarps x FC), in order
template <int FC>
__device__ void flush_cols(const float* p, float* v) {
  for (int f = threadIdx.x; f < FC; f += kThreads) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += p[w * FC + f];
    v[f] += s;
  }
}

template <int FC>
__global__ void __launch_bounds__(kThreads) mlp_bwd_a_kernel(BArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int BT = kBT, LDF = FC + kPad, NJ = FC / 8;
  static_assert(NJ % 2 == 0, "product tiles come in n8 pairs");
  const int C = a.C, Cp = a.Cp, Fp = a.Fp, LDA = Cp + kPad;
  const ALayout L = a_layout(Cp, Fp, FC);
  bf16* hs = reinterpret_cast<bf16*>(smem_raw + L.hs);
  bf16* ds = reinterpret_cast<bf16*>(smem_raw + L.ds);
  bf16* wbuf = reinterpret_cast<bf16*>(smem_raw + L.w);
  float* pdb1 = reinterpret_cast<float*>(smem_raw + L.pdb1);
  float* vacc = reinterpret_cast<float*>(smem_raw + L.vacc);
  long long* tok = reinterpret_cast<long long*>(smem_raw + L.tok);
  const int wstride = FC * LDA + Cp * LDF;

  const bf16* __restrict__ y = static_cast<const bf16*>(a.y);
  const bf16* __restrict__ dout = static_cast<const bf16*>(a.dout);
  bf16* __restrict__ h_g = static_cast<bf16*>(a.hs);
  bf16* __restrict__ dd_g = static_cast<bf16*>(a.dd);
  bf16* __restrict__ g_g = static_cast<bf16*>(a.gs);
  bf16* __restrict__ da_g = static_cast<bf16*>(a.das);
  const float* __restrict__ ln_s = a.vec;
  const float* __restrict__ ln_b = a.vec + C;
  const float* __restrict__ gamma = a.vec + 3 * C;
  const float* __restrict__ pre = a.vec + 4 * C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Lanes ln(lane);
  const int t0w = warp * 16, g_row = t0w + (lane >> 2);
  const int c_lane = 2 * (lane & 3);
  const unsigned hs_a = smem_u32(hs + (t0w + ln.a_row) * LDA + ln.a_col);
  const unsigned ds_a = smem_u32(ds + (t0w + ln.a_row) * LDA + ln.a_col);
  const long long T_total = a.n_outer * a.P;
  const long long n_tiles = (T_total + BT - 1) / BT;
  const int n_chunks = Fp / FC;

  for (int i = tid; i < Fp + 2 * Cp; i += kThreads) vacc[i] = 0.f;

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long t0 = tile * BT;
    __syncthreads();                  // the previous tile is done
    load_w_chunk<FC>(a, 0, wbuf, wbuf + FC * LDA);
    cp_async_commit();
    token_offsets(a, t0, tok);
    __syncthreads();
    // y -> ds; LayerNorm -> hs (zero on padded tokens and channels), and
    // each token's mean and inv -> stats
    for_tile<8>(
        a, tok, [&](long long off) { return off >= 0 ? to_f(y[off]) : 0.f; },
        [&](int t, int c, long long, float v) {
          ds[t * LDA + c] = from_f<bf16>(v);
        });
    __syncthreads();
    for (int t = warp; t < BT; t += kWarps) {
      const bf16* row = ds + t * LDA;
      float s = 0.f;
      for (int c = lane; c < C; c += 32) s += to_f(row[c]) + pre[c];
      const float mu = warp_sum(s) / C;
      float q = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float d = to_f(row[c]) + pre[c] - mu;
        q += d * d;
      }
      const float iv = rsqrtf(warp_sum(q) / C + kLnEps);
      const bool real = tok[t] >= 0;
      for (int c = lane; c < Cp; c += 32)
        hs[t * LDA + c] = from_f<bf16>(
            real && c < C
                ? (to_f(row[c]) + pre[c] - mu) * iv * ln_s[c] + ln_b[c]
                : 0.f);
      if (lane == 0) {
        a.stats[(t0 + t) * 2] = mu;
        a.stats[(t0 + t) * 2 + 1] = iv;
      }
    }
    __syncthreads();
    // dout -> ds, and to scratch next to do; h to scratch
    for_tile<8>(
        a, tok,
        [&](long long off) { return off >= 0 ? to_f(dout[off]) : 0.f; },
        [&](int t, int c, long long, float v) {
          ds[t * LDA + c] = from_f<bf16>(v);
        });
    __syncthreads();
    copy_rows<bf16>(dd_g + t0 * 2 * Cp + Cp, 2 * Cp, ds, LDA, BT, Cp);
    copy_rows<bf16>(h_g + t0 * Cp, Cp, hs, LDA, BT, Cp);
    __syncthreads();
    // do = dout * gamma, rounded in place; db2 and sum_t dout, a thread a
    // channel, the tokens in order
    for (int c = tid; c < Cp; c += kThreads) {
      const float gm = c < C ? gamma[c] : 0.f;
      float s = 0.f, sd = 0.f;
      for (int t = 0; t < BT; ++t) {
        const float d = to_f(ds[t * LDA + c]);
        const float v = d * gm;
        ds[t * LDA + c] = from_f<bf16>(v);
        s += v;
        sd += d;
      }
      vacc[Fp + c] += s;
      vacc[Fp + Cp + c] += sd;
    }
    __syncthreads();
    copy_rows<bf16>(dd_g + t0 * 2 * Cp, 2 * Cp, ds, LDA, BT, Cp);

    bf16* g_row0 = g_g + (t0 + g_row) * Fp + c_lane;
    bf16* da_row0 = da_g + (t0 + g_row) * Fp + c_lane;
    for (int ch = 0; ch < n_chunks; ++ch) {
      cp_async_wait<0>();
      __syncthreads();            // chunk ch landed; chunk ch-1 all read
      if (ch > 0)
        flush_cols<FC>(pdb1 + ((ch - 1) & 1) * kWarps * FC,
                       vacc + (ch - 1) * FC);
      const bf16* w1s = wbuf + (ch & 1) * wstride;
      const bf16* w2s = w1s + FC * LDA;
      if (ch + 1 < n_chunks) {
        bf16* nxt = wbuf + ((ch + 1) & 1) * wstride;
        load_w_chunk<FC>(a, (ch + 1) * FC, nxt, nxt + FC * LDA);
      }
      cp_async_commit();
      const int f0 = ch * FC;

      // a = h (16 x Cp) . W1^T rows of the chunk
      float av[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) av[j][0] = av[j][1] = av[j][2] = av[j][3] = 0.f;
      const unsigned w1_b = smem_u32(w1s + ln.b_row * LDA + ln.b_col);
      for (int k = 0; k < Cp; k += 16) {
        unsigned af[4];
        ldsm_x4(hs_a + k * 2, af);
#pragma unroll
        for (int jp = 0; jp < NJ / 2; ++jp) {
          unsigned b[4];
          ldsm_x4(w1_b + (jp * 16 * LDA + k) * 2, b);
          mma_16816(av[2 * jp], af, b[0], b[1]);
          mma_16816(av[2 * jp + 1], af, b[2], b[3]);
        }
      }
      // + b1; g = GELU(a) rounded -> scratch; erf kept for gelu'
      float er[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float2 bb =
            *reinterpret_cast<const float2*>(a.b1 + f0 + j * 8 + c_lane);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          av[j][e] += (e & 1) ? bb.y : bb.x;
          er[j][e] = erff(av[j][e] * kInvSqrt2);
        }
        *reinterpret_cast<unsigned*>(g_row0 + f0 + j * 8) =
            pack_bf16x2(0.5f * av[j][0] * (1.f + er[j][0]),
                        0.5f * av[j][1] * (1.f + er[j][1]));
        *reinterpret_cast<unsigned*>(g_row0 + 8 * Fp + f0 + j * 8) =
            pack_bf16x2(0.5f * av[j][2] * (1.f + er[j][2]),
                        0.5f * av[j][3] * (1.f + er[j][3]));
      }
      // dg = do (16 x Cp) . W2^T columns of the chunk ([k = c][n = f])
      float dg[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) dg[j][0] = dg[j][1] = dg[j][2] = dg[j][3] = 0.f;
      const unsigned w2_b = smem_u32(w2s + ln.bt_k * LDF + ln.bt_n);
      for (int k = 0; k < Cp; k += 16) {
        unsigned af[4];
        ldsm_x4(ds_a + k * 2, af);
#pragma unroll
        for (int jp = 0; jp < NJ / 2; ++jp) {
          unsigned b[4];
          ldsm_x4_t(w2_b + (k * LDF + jp * 16) * 2, b);
          mma_16816(dg[2 * jp], af, b[0], b[1]);
          mma_16816(dg[2 * jp + 1], af, b[2], b[3]);
        }
      }
      // da = dg gelu'(a): rounded -> scratch; its column sums -> pdb1
      float* pd = pdb1 + ((ch & 1) * kWarps + warp) * FC;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float da[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = av[j][e];
          const float gp = 0.5f * (1.f + er[j][e]) +
                           v * kInvSqrt2Pi * __expf(-0.5f * v * v);
          da[e] = dg[j][e] * gp;
        }
        *reinterpret_cast<unsigned*>(da_row0 + f0 + j * 8) =
            pack_bf16x2(da[0], da[1]);
        *reinterpret_cast<unsigned*>(da_row0 + 8 * Fp + f0 + j * 8) =
            pack_bf16x2(da[2], da[3]);
        const float s0 = rows_sum(da[0] + da[2]);
        const float s1 = rows_sum(da[1] + da[3]);
        if (lane < 4) {
          pd[j * 8 + c_lane] = s0;
          pd[j * 8 + c_lane + 1] = s1;
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();
    flush_cols<FC>(pdb1 + ((n_chunks - 1) & 1) * kWarps * FC,
                   vacc + (n_chunks - 1) * FC);
  }
  __syncthreads();
  float* dst = a.vpart_a + (long long)blockIdx.x * (Fp + 2 * Cp);
  for (int i = tid; i < Fp + 2 * Cp; i += kThreads) dst[i] = vacc[i];
}

// ---------------------------------------------------------------------------
// bf16 kernel 2: dh = da W1, the LayerNorm backward, dy
//
// Shared layout (LDA = Cp + kPad, LDF = FC + kPad):
//   buf 2 x (da [BT][LDF] + W1^T rows [FC][LDA]), after the chunk loop the
//   y (then dy) tile [BT][LDA] | colp [kWarps][2 Cp] f32 |
//   vacc [2 Cp] f32 | mean, inv [BT] f32 | tok [BT] i64
// ---------------------------------------------------------------------------

struct BLayout {
  size_t buf, colp, vacc, stats, tok, total;
};

__host__ __device__ inline BLayout b_layout(int Cp, int FC) {
  const size_t LDA = Cp + kPad, LDF = FC + kPad;
  const size_t bufs = 2 * (kBT * LDF + FC * LDA) * sizeof(bf16);
  const size_t ytile = kBT * LDA * sizeof(bf16);
  BLayout L;
  size_t o = 0;
  L.buf = take(&o, bufs > ytile ? bufs : ytile);
  L.colp = take(&o, kWarps * 2 * Cp * sizeof(float));
  L.vacc = take(&o, 2 * Cp * sizeof(float));
  L.stats = take(&o, 2 * kBT * sizeof(float));
  L.tok = take(&o, kBT * sizeof(long long));
  L.total = o;
  return L;
}

template <int NT, int FC>   // NT: n8 tiles of dh a warp holds, 8 NT >= Cp
__global__ void __launch_bounds__(kThreads) mlp_bwd_b_kernel(BArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int BT = kBT, LDF = FC + kPad;
  const int C = a.C, Cp = a.Cp, Fp = a.Fp, LDA = Cp + kPad;
  const int nt = Cp / 8;            // this width's n8 tiles (<= NT, even)
  const BLayout L = b_layout(Cp, FC);
  bf16* buf = reinterpret_cast<bf16*>(smem_raw + L.buf);
  bf16* ys = buf;
  float* colp = reinterpret_cast<float*>(smem_raw + L.colp);
  float* vacc = reinterpret_cast<float*>(smem_raw + L.vacc);
  float* mean = reinterpret_cast<float*>(smem_raw + L.stats);
  float* inv = mean + BT;
  long long* tok = reinterpret_cast<long long*>(smem_raw + L.tok);
  const int bstride = BT * LDF + FC * LDA;

  const bf16* __restrict__ y = static_cast<const bf16*>(a.y);
  bf16* __restrict__ dy = static_cast<bf16*>(a.dy);
  const bf16* __restrict__ w1 = static_cast<const bf16*>(a.w1);
  const bf16* __restrict__ da_g = static_cast<const bf16*>(a.das);
  const float* __restrict__ ln_s = a.vec;
  const float* __restrict__ pre = a.vec + 4 * C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Lanes ln(lane);
  const int t0w = warp * 16, r0 = t0w + (lane >> 2), r1 = r0 + 8;
  const int c_lane = 2 * (lane & 3);
  const long long T_total = a.n_outer * a.P;
  const long long n_tiles = (T_total + BT - 1) / BT;
  const int n_chunks = Fp / FC;
  const float inv_c = 1.f / C;

  for (int i = tid; i < 2 * Cp; i += kThreads) vacc[i] = 0.f;

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long t0 = tile * BT;
    __syncthreads();                  // the previous tile is done
    async_rows(buf, LDF, da_g + t0 * Fp, Fp, BT, FC);
    async_rows(buf + BT * LDF, LDA, w1, Cp, FC, Cp);
    cp_async_commit();
    token_offsets(a, t0, tok);
    for (int t = tid; t < BT; t += kThreads) {
      mean[t] = a.stats[(t0 + t) * 2];
      inv[t] = a.stats[(t0 + t) * 2 + 1];
    }
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int ch = 0; ch < n_chunks; ++ch) {
      cp_async_wait<0>();
      __syncthreads();
      const bf16* das = buf + (ch & 1) * bstride;
      const bf16* w1s = das + BT * LDF;
      if (ch + 1 < n_chunks) {
        bf16* nxt = buf + ((ch + 1) & 1) * bstride;
        async_rows(nxt, LDF, da_g + t0 * Fp + (ch + 1) * FC, Fp, BT, FC);
        async_rows(nxt + BT * LDF, LDA, w1 + (size_t)(ch + 1) * FC * Cp, Cp,
                   FC, Cp);
      }
      cp_async_commit();
      // dh += da (16 x FC) . W1^T rows ([k = f][n = c])
      const unsigned da_a =
          smem_u32(das + (t0w + ln.a_row) * LDF + ln.a_col);
      const unsigned w1_b = smem_u32(w1s + ln.bt_k * LDA + ln.bt_n);
#pragma unroll
      for (int kk = 0; kk < FC / 16; ++kk) {
        unsigned af[4];
        ldsm_x4(da_a + kk * 16 * 2, af);
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp) {
          if (2 * jp < nt) {
            unsigned b[4];
            ldsm_x4_t(w1_b + (kk * 16 * LDA + jp * 16) * 2, b);
            mma_16816(acc[2 * jp], af, b[0], b[1]);
            mma_16816(acc[2 * jp + 1], af, b[2], b[3]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();
    for_tile<8>(
        a, tok, [&](long long off) { return off >= 0 ? to_f(y[off]) : 0.f; },
        [&](int t, int c, long long, float v) {
          ys[t * LDA + c] = from_f<bf16>(v);
        });
    __syncthreads();
    // The LayerNorm backward of rows r0 and r1 (this lane's), xhat from y:
    // dxh = dh * ln_scale; dy = inv (dxh - mean_c dxh - xhat mean_c(dxh
    // xhat)). Padded tokens have dh = 0 and add nothing to the sums.
    const float mu0 = mean[r0], iv0 = inv[r0], mu1 = mean[r1], iv1 = inv[r1];
    float s1a = 0.f, s2a = 0.f, s1b = 0.f, s2b = 0.f;
    float* cw = colp + warp * 2 * Cp;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = j * 8 + c_lane + e;
          const bool ok = c < C;
          const float sc = ok ? ln_s[c] : 0.f, pb = ok ? pre[c] : 0.f;
          const float xa = (to_f(ys[r0 * LDA + c]) + pb - mu0) * iv0;
          const float xb = (to_f(ys[r1 * LDA + c]) + pb - mu1) * iv1;
          const float ga = acc[j][e], gb = acc[j][2 + e];
          s1a += ga * sc;
          s2a += ga * sc * xa;
          s1b += gb * sc;
          s2b += gb * sc * xb;
          const float cl = rows_sum(ga * xa + gb * xb);
          const float cb = rows_sum(ga + gb);
          if (lane < 4) {
            cw[c] = ok ? cl : 0.f;
            cw[Cp + c] = ok ? cb : 0.f;
          }
        }
      }
    }
    s1a = quad_sum(s1a) * inv_c;
    s2a = quad_sum(s2a) * inv_c;
    s1b = quad_sum(s1b) * inv_c;
    s2b = quad_sum(s2b) * inv_c;
    // dy, in place of y (each lane rewrites the elements it read)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = j * 8 + c_lane + e;
          const bool ok = c < C;
          const float sc = ok ? ln_s[c] : 0.f, pb = ok ? pre[c] : 0.f;
          const float xa = (to_f(ys[r0 * LDA + c]) + pb - mu0) * iv0;
          const float xb = (to_f(ys[r1 * LDA + c]) + pb - mu1) * iv1;
          ys[r0 * LDA + c] =
              from_f<bf16>(iv0 * (acc[j][e] * sc - s1a - xa * s2a));
          ys[r1 * LDA + c] =
              from_f<bf16>(iv1 * (acc[j][2 + e] * sc - s1b - xb * s2b));
        }
      }
    }
    __syncthreads();
    for_tile<8>(
        a, tok, [](long long) { return 0.f; },
        [&](int t, int c, long long off, float) {
          if (off >= 0) dy[off] = ys[t * LDA + c];
        });
    for (int c = tid; c < Cp; c += kThreads) {
      float sl = 0.f, sb = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        sl += colp[w * 2 * Cp + c];
        sb += colp[w * 2 * Cp + Cp + c];
      }
      vacc[c] += sl;
      vacc[Cp + c] += sb;
    }
  }
  __syncthreads();
  float* dst = a.vpart_b + (long long)blockIdx.x * 2 * Cp;
  for (int i = tid; i < 2 * Cp; i += kThreads) dst[i] = vacc[i];
}

// ---------------------------------------------------------------------------
// bf16 kernel 3: part[z] (M x N, fp32) = sum over the tokens of split z of
// A[t][m] * B[t][n]; A (Tp, M) and B (Tp, N) token-major with row pitches
// lda and ldb, M and N multiples of 16, the split a multiple of kGK
// tokens. A 128 x 128 output tile a block, a 64 x 32 tile a warp; the
// token axis streams through a 3-stage cp.async ring of [kGK][128] tiles
// read with ldmatrix.trans.
// ---------------------------------------------------------------------------

constexpr int kGT = 128, kGK = 32, kGStages = 3, kGLD = kGT + kPad;
constexpr size_t kGemmSmem = kGStages * 2 * kGK * kGLD * sizeof(bf16);

__global__ void __launch_bounds__(kThreads)
mlp_bwd_gemm_kernel(const bf16* __restrict__ A, int lda,
                    const bf16* __restrict__ B, int ldb, float* part,
                    long long Tp, int M, int N, long long per) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  const int m0 = blockIdx.x * kGT, n0 = blockIdx.y * kGT;
  const long long ta = blockIdx.z * per;
  const long long tb = min(Tp, ta + per);
  const int nk = tb > ta ? (int)((tb - ta) / kGK) : 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const Lanes ln(lane);

  auto load = [&](int s, int kt) {
    const long long t = ta + (long long)kt * kGK;
    bf16* As = sm + s * 2 * kGK * kGLD;
    bf16* Bs = As + kGK * kGLD;
    constexpr int per_row = kGT / 8;
    for (int i = tid; i < 2 * kGK * per_row; i += kThreads) {
      const bool is_b = i >= kGK * per_row;
      const int ii = is_b ? i - kGK * per_row : i;
      const int r = ii / per_row, v = ii - r * per_row;
      const int col = (is_b ? n0 : m0) + v * 8;
      bf16* dst = (is_b ? Bs : As) + r * kGLD + v * 8;
      if (col < (is_b ? N : M))
        cp_async16(dst, is_b ? B + (t + r) * ldb + col
                             : A + (t + r) * lda + col);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

#pragma unroll
  for (int s = 0; s < kGStages - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kGStages - 2>();
    __syncthreads();                // tile kt landed; tile kt-1 all read
    const int nxt = kt + kGStages - 1;
    if (nxt < nk) load(nxt % kGStages, nxt);
    cp_async_commit();
    const bf16* As = sm + (kt % kGStages) * 2 * kGK * kGLD;
    const bf16* Bs = As + kGK * kGLD;
#pragma unroll
    for (int kk = 0; kk < kGK; kk += 16) {
      unsigned af[4][4], bfr[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4_t(smem_u32(As + (kk + ln.at_k) * kGLD + wm * 64 + mi * 16 +
                           ln.at_m), af[mi]);
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldsm_x4_t(smem_u32(Bs + (kk + ln.bt_k) * kGLD + wn * 32 + np * 16 +
                           ln.bt_n), bfr[np]);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
          mma_16816(acc[mi][nj], af[mi], bfr[nj >> 1][(nj & 1) * 2],
                    bfr[nj >> 1][(nj & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();
  float* dst = part + (long long)blockIdx.z * M * N;
  const int c_lane = 2 * (lane & 3);
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      const int m = m0 + wm * 64 + mi * 16 + (lane >> 2);
      const int n = n0 + wn * 32 + nj * 8 + c_lane;
      if (m < M && n < N) {
        *reinterpret_cast<float2*>(dst + (long long)m * N + n) =
            make_float2(acc[mi][nj][0], acc[mi][nj][1]);
        *reinterpret_cast<float2*>(dst + (long long)(m + 8) * N + n) =
            make_float2(acc[mi][nj][2], acc[mi][nj][3]);
      }
    }
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

// part[z] (M x N) = sum over the tokens of split z of A[t][m] * B[t][n],
// float32 on the CUDA cores: simt_tile.cuh's 64 x 64 output tile a block,
// 32 tokens a step through shared memory
constexpr int kTileMN = simt_tile::kTile, kTileT32 = 32;
static_assert(kThreads == simt_tile::kThreads, "one thread block shape");

__global__ void __launch_bounds__(kThreads, simt_tile::kMinBlocks)
mlp_bwd_gemm_f32_kernel(const float* __restrict__ A, int lda,
                        const float* __restrict__ B, int ldb, float* part,
                        long long Tp, int M, int N, long long per) {
  const int m0 = blockIdx.x * kTileMN, n0 = blockIdx.y * kTileMN;
  const long long ta = blockIdx.z * per, tb = min(Tp, ta + per);
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  float acc[4][4] = {};
  simt_tile::product<kTileT32, false, false>(
      [&](int m, long long t) {
        return t < tb && m0 + m < M ? A[t * lda + m0 + m] : 0.f;
      },
      [&](int n, long long t) {
        return t < tb && n0 + n < N ? B[t * ldb + n0 + n] : 0.f;
      },
      ta, tb, acc);
  float* dst = part + (long long)blockIdx.z * M * N;
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + tr * 4 + i, n = n0 + tc * 4 + j;
      if (m < M && n < N) dst[(long long)m * N + n] = acc[i][j];
    }
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

// Raise a kernel's dynamic shared-memory limit, once a kernel.
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

long long split_len(long long Tp, int splits, int step) {
  return ((Tp + splits - 1) / splits + step - 1) / step * step;
}

// part (splits, M, N) then out (M, N) = its sum over the splits
cudaError_t gemm_bf16(const void* A, int lda, const void* B, int ldb,
                      float* part, float* out, long long Tp, int M, int N,
                      int splits, cudaStream_t s) {
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(
      mlp_bwd_gemm_kernel));
  if (e != cudaSuccess) return e;
  const dim3 grid((M + kGT - 1) / kGT, (N + kGT - 1) / kGT, splits);
  mlp_bwd_gemm_kernel<<<grid, kThreads, kGemmSmem, s>>>(
      static_cast<const bf16*>(A), lda, static_cast<const bf16*>(B), ldb,
      part, Tp, M, N, split_len(Tp, splits, kGK));
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return reduce(part, out, (long long)M * N, splits, s);
}

cudaError_t gemm_f32(const void* A, int lda, const void* B, int ldb,
                     float* part, float* out, long long Tp, int M, int N,
                     int splits, cudaStream_t s) {
  const dim3 grid((M + kTileMN - 1) / kTileMN, (N + kTileMN - 1) / kTileMN,
                  splits);
  mlp_bwd_gemm_f32_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(A), lda, static_cast<const float*>(B), ldb,
      part, Tp, M, N, split_len(Tp, splits, kTileT32));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return reduce(part, out, (long long)M * N, splits, s);
}

template <typename K>
cudaError_t run(K kernel, const BArgs& a, int grid, size_t smem,
                cudaStream_t s) {
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(kernel));
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const BArgs& a, int grid, float* wpart1,
                        float* wpart2, float* dw1, float* dw2, float* dvec,
                        int splits1, int splits2, cudaStream_t s) {
  const int Cp = a.Cp, Fp = a.Fp;
  const int fca = Cp <= 128 ? 64 : 32;
  const size_t smem_a = a_layout(Cp, Fp, fca).total;
  const size_t smem_b = b_layout(Cp, 64).total;
  if (a.BT != kBT || Cp > 256 || Fp % 64 || smem_a > kSmemMax ||
      smem_b > kSmemMax)
    return cudaErrorInvalidConfiguration;
  cudaError_t e = fca == 64 ? run(mlp_bwd_a_kernel<64>, a, grid, smem_a, s)
                            : run(mlp_bwd_a_kernel<32>, a, grid, smem_a, s);
  if (e != cudaSuccess) return e;
  e = reduce(a.vpart_a, dvec, Fp + 2LL * Cp, grid, s);
  if (e != cudaSuccess) return e;
  e = Cp <= 128 ? run(mlp_bwd_b_kernel<16, 64>, a, grid, smem_b, s)
                : run(mlp_bwd_b_kernel<32, 64>, a, grid, smem_b, s);
  if (e != cudaSuccess) return e;
  e = reduce(a.vpart_b, dvec + Fp + 2 * Cp, 2LL * Cp, grid, s);
  if (e != cudaSuccess) return e;
  const long long tokens = a.n_outer * a.P;
  const long long Tp = (tokens + kBT - 1) / kBT * kBT;
  // dW1^T (Fp, Cp) = da^T h ; [dW2^T ; M] (2 Cp, Fp) = [do | dout]^T g
  e = gemm_bf16(a.das, Fp, a.hs, Cp, wpart1, dw1, Tp, Fp, Cp, splits1, s);
  if (e != cudaSuccess) return e;
  e = gemm_bf16(a.dd, 2 * Cp, a.gs, Fp, wpart2, dw2, Tp, 2 * Cp, Fp,
                splits2, s);
  if (e != cudaSuccess) return e;
  dgamma_kernel<bf16><<<(Cp + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      static_cast<const bf16*>(a.w2), dw2 + (long long)Cp * Fp,
      a.vec + 2 * a.C, dvec + Fp + Cp, dvec + Fp + 4 * Cp, a.C, Cp, Fp);
  return cudaGetLastError();
}

// ===========================================================================
// K9: the same backward at any width (slak_mlp_bwd_wide; see the header)
// ===========================================================================

constexpr int kWT = 32;        // tokens a block in the per-token kernels
constexpr int kWPadT = 128;    // the tokens are padded to a multiple of this

// Shared layout of the per-token kernels: tile [kWT][Cp + 1] f32 (the odd
// pitch keeps the token-walking lanes off each other's banks) | mean, inv
// [kWT] f32 | tok [kWT] i64
struct TLayout {
  size_t tile, stats, tok, total;
};

__host__ __device__ inline TLayout t_layout(int Cp) {
  TLayout L;
  size_t o = 0;
  L.tile = take(&o, (size_t)kWT * (Cp + 1) * sizeof(float));
  L.stats = take(&o, 2 * kWT * sizeof(float));
  L.tok = take(&o, kWT * sizeof(long long));
  L.total = o;
  return L;
}

// The LayerNorm (each token's mean and inv to scratch), h rounded -> hs,
// [do | dout] rounded -> dd, and this block's column sums of do (db2) and
// dout -> vpart_a[blockIdx.x]. Padded tokens and channels give zeros.
template <typename T>
__global__ void __launch_bounds__(kThreads) wide_prep_kernel(BArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int C = a.C, Cp = a.Cp, LDW = Cp + 1;
  const TLayout L = t_layout(Cp);
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
  const long long t0 = (long long)blockIdx.x * kWT;

  token_offsets(a, t0, tok);
  __syncthreads();
  for_tile<4>(
      a, tok, [&](long long off) { return off >= 0 ? to_f(y[off]) : 0.f; },
      [&](int t, int c, long long off, float v) {
        tile[t * LDW + c] = off >= 0 ? v + pre[c] : 0.f;
      });
  __syncthreads();
  for (int t = warp; t < kWT; t += kWarps) {
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
  for (int i = tid; i < kWT * Cp; i += kThreads) {
    const int t = i / Cp, c = i - t * Cp;
    h_g[(t0 + t) * Cp + c] = from_f<T>(tile[t * LDW + c]);
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
    for (int t = 0; t < kWT; ++t) {
      const float d = tile[t * LDW + c];
      const float v = d * gm;
      T* row = dd_g + (t0 + t) * 2 * Cp;
      row[c] = from_f<T>(v);
      row[Cp + c] = from_f<T>(d);
      s += v;
      sd += d;
    }
    part[c] = s;
    part[Cp + c] = sd;
  }
}

// The LayerNorm backward from dh (f32 scratch, (Tp, Cp)): dy (f32, through
// the forward's strides) and this block's column sums of dh * xhat
// (dLN-scale) and dh (dLN-bias) -> vpart_b[blockIdx.x].
template <typename T>
__global__ void __launch_bounds__(kThreads)
wide_lnb_kernel(BArgs a, const float* __restrict__ dh) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int C = a.C, Cp = a.Cp, LDW = Cp + 1;
  const TLayout L = t_layout(Cp);
  float* tile = reinterpret_cast<float*>(smem_raw + L.tile);
  float* mean = reinterpret_cast<float*>(smem_raw + L.stats);
  float* inv = mean + kWT;
  long long* tok = reinterpret_cast<long long*>(smem_raw + L.tok);
  const T* __restrict__ y = static_cast<const T*>(a.y);
  float* __restrict__ dy = static_cast<float*>(a.dy);
  const float* __restrict__ ln_s = a.vec;
  const float* __restrict__ pre = a.vec + 4 * C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long t0 = (long long)blockIdx.x * kWT;
  const float* dh_t = dh + t0 * Cp;

  token_offsets(a, t0, tok);
  for (int t = tid; t < kWT; t += kThreads) {
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
    for (int t = 0; t < kWT; ++t) {
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
  for (int t = warp; t < kWT; t += kWarps) {
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
        if (off >= 0) dy[off] = tile[t * LDW + c];
      });
}

// The two token-row products of K9 (row-major operands, pitches in
// elements):
//  fused:  a = h W1^T (B = W1^T rows, [n = f][k = c]) and dg = do W2 (B =
//          W2^T, [k = c][n = f]) over K = Cp; then g = GELU(a + b1) and
//          da = dg gelu'(a + b1), rounded -> g, da (Tp, Fp); the block's
//          column sums of da (db1) -> vpart[blockIdx.x] (row pitch ldo).
//  !fused: dh = da W1 (B = W1^T, [k = f][n = c]) over K = Fp -> dh (Tp, N)
//          f32.
template <typename T>
struct PArgs {
  const T* a0;          // h (fused) or da, [t][k]
  long long lda0;
  const T* a1;          // do (fused), [t][k]
  long long lda1;
  const T* bn;          // [n][k] (fused)
  long long ldbn;
  const T* bk;          // [k][n]
  long long ldbk;
  int K, N;
  const float* b1;      // fused
  T* g;                 // fused outputs, row pitch ldo
  T* da;
  long long ldo;
  float* vpart;
  float* dh;            // !fused output, row pitch N
};

__device__ __forceinline__ void zero16(void* p) {
  *reinterpret_cast<uint4*>(p) = make_uint4(0, 0, 0, 0);
}

// GELU of a = acc + bias, and gelu'(a) * dg
__device__ __forceinline__ void gelu_pair(float acc, float bias, float dg,
                                          float* g, float* da) {
  const float v = acc + bias;
  const float er = erff(v * kInvSqrt2);
  *g = 0.5f * v * (1.f + er);
  *da = dg * (0.5f * (1.f + er) + v * kInvSqrt2Pi * __expf(-0.5f * v * v));
}

// bf16 on the tensor cores (mma.sync m16n8k16 + ldmatrix, f32
// accumulators): a 128-token x 64-column tile a block, 32 x 32 a warp, K in
// steps of 32 through a 2-stage cp.async ring; operands past K or N load as
// zeros.
constexpr int kPM = 128, kPN = 64, kPK = 32;
constexpr int kPLD = kPK + kPad, kPLDN = kPN + kPad;
constexpr int kPStage = 2 * kPM * kPLD + kPN * kPLD + kPK * kPLDN;
constexpr size_t kPSmem = 2 * kPStage * sizeof(bf16) + 4 * kPN * sizeof(float);

template <bool FUSED>
__global__ void __launch_bounds__(kThreads) wide_tc_kernel(PArgs<bf16> p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const Lanes ln(lane);
  const long long m0 = (long long)blockIdx.x * kPM;
  const int n0 = blockIdx.y * kPN;
  const int nk = (p.K + kPK - 1) / kPK;
  constexpr int KV = kPK / 8, NV = kPN / 8;   // 16-byte pieces a row

  auto load = [&](int s, int kt) {
    const int k0 = kt * kPK;
    bf16* a0s = sm + s * kPStage;
    bf16* a1s = a0s + kPM * kPLD;
    bf16* bns = a1s + kPM * kPLD;
    bf16* bks = bns + kPN * kPLD;
    for (int i = tid; i < kPM * KV; i += kThreads) {
      const int r = i / KV, v = (i - r * KV) * 8, k = k0 + v;
      bf16* d0 = a0s + r * kPLD + v;
      if (k < p.K) cp_async16(d0, p.a0 + (m0 + r) * p.lda0 + k);
      else zero16(d0);
      if (FUSED) {
        bf16* d1 = a1s + r * kPLD + v;
        if (k < p.K) cp_async16(d1, p.a1 + (m0 + r) * p.lda1 + k);
        else zero16(d1);
      }
    }
    if (FUSED)
      for (int i = tid; i < kPN * KV; i += kThreads) {
        const int r = i / KV, v = (i - r * KV) * 8, k = k0 + v;
        bf16* d = bns + r * kPLD + v;
        if (k < p.K) cp_async16(d, p.bn + (long long)(n0 + r) * p.ldbn + k);
        else zero16(d);
      }
    for (int i = tid; i < kPK * NV; i += kThreads) {
      const int r = i / NV, v = (i - r * NV) * 8, n = n0 + v;
      bf16* d = bks + r * kPLDN + v;
      if (k0 + r < p.K && n < p.N)
        cp_async16(d, p.bk + (long long)(k0 + r) * p.ldbk + n);
      else
        zero16(d);
    }
  };

  float acc_n[2][4][4], acc_k[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_n[mi][j][e] = acc_k[mi][j][e] = 0.f;

  load(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<0>();
    __syncthreads();               // tile kt landed; tile kt-1 all read
    if (kt + 1 < nk) load((kt + 1) & 1, kt + 1);
    cp_async_commit();
    const bf16* a0s = sm + (kt & 1) * kPStage;
    const bf16* a1s = a0s + kPM * kPLD;
    const bf16* bns = a1s + kPM * kPLD;
    const bf16* bks = bns + kPN * kPLD;
#pragma unroll
    for (int kk = 0; kk < kPK; kk += 16) {
      unsigned a0f[2][4], a1f[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm * 32 + mi * 16 + ln.a_row;
        ldsm_x4(smem_u32(a0s + r * kPLD + kk + ln.a_col), a0f[mi]);
        if (FUSED) ldsm_x4(smem_u32(a1s + r * kPLD + kk + ln.a_col), a1f[mi]);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        unsigned b[4];
        if (FUSED) {
          ldsm_x4(smem_u32(bns + (wn * 32 + np * 16 + ln.b_row) * kPLD + kk +
                           ln.b_col), b);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma_16816(acc_n[mi][2 * np], a0f[mi], b[0], b[1]);
            mma_16816(acc_n[mi][2 * np + 1], a0f[mi], b[2], b[3]);
          }
        }
        ldsm_x4_t(smem_u32(bks + (kk + ln.bt_k) * kPLDN + wn * 32 + np * 16 +
                           ln.bt_n), b);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const unsigned* af = FUSED ? a1f[mi] : a0f[mi];
          mma_16816(acc_k[mi][2 * np], af, b[0], b[1]);
          mma_16816(acc_k[mi][2 * np + 1], af, b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  const int c_lane = 2 * (lane & 3);
  if (!FUSED) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int n = n0 + wn * 32 + nj * 8 + c_lane;
        if (n >= p.N) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const long long row =
              m0 + wm * 32 + mi * 16 + (lane >> 2) + half * 8;
          *reinterpret_cast<float2*>(p.dh + row * p.N + n) = make_float2(
              acc_k[mi][nj][2 * half], acc_k[mi][nj][2 * half + 1]);
        }
      }
    return;
  }
  float* colp =
      reinterpret_cast<float*>(smem_raw + 2 * kPStage * sizeof(bf16));
#pragma unroll
  for (int nj = 0; nj < 4; ++nj) {
    const int fl = wn * 32 + nj * 8 + c_lane, f = n0 + fl;
    const float2 bb = *reinterpret_cast<const float2*>(p.b1 + f);
    float cs0 = 0.f, cs1 = 0.f;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long row = m0 + wm * 32 + mi * 16 + (lane >> 2) + half * 8;
        float g0, g1, d0, d1;
        gelu_pair(acc_n[mi][nj][2 * half], bb.x, acc_k[mi][nj][2 * half],
                  &g0, &d0);
        gelu_pair(acc_n[mi][nj][2 * half + 1], bb.y,
                  acc_k[mi][nj][2 * half + 1], &g1, &d1);
        *reinterpret_cast<unsigned*>(p.g + row * p.ldo + f) =
            pack_bf16x2(g0, g1);
        *reinterpret_cast<unsigned*>(p.da + row * p.ldo + f) =
            pack_bf16x2(d0, d1);
        cs0 += d0;
        cs1 += d1;
      }
    cs0 = rows_sum(cs0);
    cs1 = rows_sum(cs1);
    if (lane < 4) {
      colp[wm * kPN + fl] = cs0;
      colp[wm * kPN + fl + 1] = cs1;
    }
  }
  __syncthreads();
  for (int i = tid; i < kPN; i += kThreads)
    p.vpart[(long long)blockIdx.x * p.ldo + n0 + i] =
        colp[i] + colp[kPN + i] + colp[2 * kPN + i] + colp[3 * kPN + i];
}

// float32 on the CUDA cores: the same products as simt_tile.cuh tiles (64
// x 64 a block, 4 x 4 a thread), K in steps of 16 through shared memory;
// fused runs the two products one after the other over the same rows.
constexpr int kSM = simt_tile::kTile, kSN = simt_tile::kTile, kSK = 16;

template <bool FUSED>
__global__ void __launch_bounds__(kThreads, simt_tile::kMinBlocks)
    wide_simt_kernel(PArgs<float> p) {
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const long long m0 = (long long)blockIdx.x * kSM;
  const int n0 = blockIdx.y * kSN;
  const long long K = p.K;
  auto a0 = [&](int r, long long k) {
    return k < K ? p.a0[(m0 + r) * p.lda0 + k] : 0.f;
  };
  // B = [k][n] (bk): W1^T for dh = da W1, W2^T for dg = do W2
  auto bk = [&](int n, long long k) {
    return k < K && n0 + n < p.N ? p.bk[k * p.ldbk + n0 + n] : 0.f;
  };
  float acc_k[4][4] = {};
  if constexpr (!FUSED) {
    simt_tile::product<kSK, true, false>(a0, bk, 0, K, acc_k);
    for (int i = 0; i < 4; ++i) {
      const long long row = m0 + tr * 4 + i;
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tc * 4 + j;
        if (n < p.N) p.dh[row * p.N + n] = acc_k[i][j];
      }
    }
  } else {
    __shared__ float colp[16][kSN];
    float acc_n[4][4] = {};
    simt_tile::product<kSK, true, true>(
        a0,
        [&](int n, long long k) {
          return k < K ? p.bn[(long long)(n0 + n) * p.ldbn + k] : 0.f;
        },
        0, K, acc_n);
    simt_tile::product<kSK, true, false>(
        [&](int r, long long k) {
          return k < K ? p.a1[(m0 + r) * p.lda1 + k] : 0.f;
        },
        bk, 0, K, acc_k);
    float cs[4] = {0.f, 0.f, 0.f, 0.f};
    for (int i = 0; i < 4; ++i) {
      const long long row = m0 + tr * 4 + i;
      float gv[4], dv[4];
      for (int j = 0; j < 4; ++j) {
        gelu_pair(acc_n[i][j], p.b1[n0 + tc * 4 + j], acc_k[i][j], &gv[j],
                  &dv[j]);
        cs[j] += dv[j];
      }
      *reinterpret_cast<float4*>(p.g + row * p.ldo + n0 + tc * 4) =
          make_float4(gv[0], gv[1], gv[2], gv[3]);
      *reinterpret_cast<float4*>(p.da + row * p.ldo + n0 + tc * 4) =
          make_float4(dv[0], dv[1], dv[2], dv[3]);
    }
    for (int j = 0; j < 4; ++j) colp[tr][tc * 4 + j] = cs[j];
    __syncthreads();
    if (tid < kSN) {
      float s = 0.f;
      for (int r = 0; r < 16; ++r) s += colp[r][tid];
      p.vpart[(long long)blockIdx.x * p.ldo + n0 + tid] = s;
    }
  }
}

cudaError_t run_product(const PArgs<bf16>& p, bool fused, long long Tp,
                        cudaStream_t s) {
  const void* k = fused ? reinterpret_cast<const void*>(wide_tc_kernel<true>)
                        : reinterpret_cast<const void*>(wide_tc_kernel<false>);
  cudaError_t e = allow_smem(k);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)(Tp / kPM), (p.N + kPN - 1) / kPN);
  if (fused)
    wide_tc_kernel<true><<<grid, kThreads, kPSmem, s>>>(p);
  else
    wide_tc_kernel<false><<<grid, kThreads, kPSmem, s>>>(p);
  return cudaGetLastError();
}

cudaError_t run_product(const PArgs<float>& p, bool fused, long long Tp,
                        cudaStream_t s) {
  const dim3 grid((unsigned)(Tp / kSM), (p.N + kSN - 1) / kSN);
  if (fused)
    wide_simt_kernel<true><<<grid, kThreads, 0, s>>>(p);
  else
    wide_simt_kernel<false><<<grid, kThreads, 0, s>>>(p);
  return cudaGetLastError();
}

// Workspace of slak_mlp_bwd_wide, compute dtype of `e` bytes: hs (Tp, Cp),
// dd (Tp, 2 Cp), gs and das (Tp, Fp) in the compute dtype; dh (Tp, Cp),
// stats (Tp, 2), the per-token kernels' partials (Tp / kWT, 2 Cp) twice,
// db1's (Tp / product rows, Fp), wpart1 (s1, Fp, Cp), wpart2 (s2, 2 Cp, Fp)
// float32.
struct WLayout {
  size_t hs, dd, gs, das, dh, stats, vp_prep, vp_lnb, vp_db1, wpart1, wpart2,
      total;
};

inline WLayout w_layout(size_t e, long long Tp, int Cp, int Fp, int s1,
                        int s2) {
  const size_t tp = (size_t)Tp, cp = (size_t)Cp, fp = (size_t)Fp;
  const size_t nb = tp / kWT, nm = tp / (e == 2 ? kPM : kSM);
  WLayout L;
  size_t o = 0;
  L.hs = take(&o, tp * cp * e);
  L.dd = take(&o, tp * 2 * cp * e);
  L.gs = take(&o, tp * fp * e);
  L.das = take(&o, tp * fp * e);
  L.dh = take(&o, tp * cp * sizeof(float));
  L.stats = take(&o, tp * 2 * sizeof(float));
  L.vp_prep = take(&o, nb * 2 * cp * sizeof(float));
  L.vp_lnb = take(&o, nb * 2 * cp * sizeof(float));
  L.vp_db1 = take(&o, nm * fp * sizeof(float));
  L.wpart1 = take(&o, (size_t)s1 * fp * cp * sizeof(float));
  L.wpart2 = take(&o, (size_t)s2 * 2 * cp * fp * sizeof(float));
  L.total = o;
  return L;
}

template <typename T>
cudaError_t launch_wide(BArgs a, void* ws, float* dw1, float* dw2,
                        float* dvec, int s1, int s2, cudaStream_t s) {
  constexpr bool kBf16 = sizeof(T) == 2;
  const int C = a.C, Cp = a.Cp, Fp = a.Fp;
  const long long Tp = (a.n_outer * a.P + kWPadT - 1) / kWPadT * kWPadT;
  const WLayout W = w_layout(sizeof(T), Tp, Cp, Fp, s1, s2);
  unsigned char* base = static_cast<unsigned char*>(ws);
  a.hs = base + W.hs;
  a.dd = base + W.dd;
  a.gs = base + W.gs;
  a.das = base + W.das;
  a.stats = reinterpret_cast<float*>(base + W.stats);
  a.vpart_a = reinterpret_cast<float*>(base + W.vp_prep);
  a.vpart_b = reinterpret_cast<float*>(base + W.vp_lnb);
  a.BT = kWT;
  float* dh = reinterpret_cast<float*>(base + W.dh);
  float* vp_db1 = reinterpret_cast<float*>(base + W.vp_db1);
  float* wpart1 = reinterpret_cast<float*>(base + W.wpart1);
  float* wpart2 = reinterpret_cast<float*>(base + W.wpart2);
  const size_t smem_t = t_layout(Cp).total;
  if (smem_t > kSmemMax) return cudaErrorInvalidConfiguration;
  const int nb = (int)(Tp / kWT);
  const int nm = (int)(Tp / (kBf16 ? kPM : kSM));

  // 1. LayerNorm, h, do, dout; db2 and sum_t dout
  cudaError_t e = run(wide_prep_kernel<T>, a, nb, smem_t, s);
  if (e != cudaSuccess) return e;
  e = reduce(a.vpart_a, dvec + Fp, 2LL * Cp, nb, s);
  if (e != cudaSuccess) return e;
  // 2. a, dg -> g, da; db1
  PArgs<T> p{};
  p.a0 = static_cast<const T*>(a.hs);
  p.lda0 = Cp;
  p.a1 = static_cast<const T*>(a.dd);
  p.lda1 = 2 * Cp;
  p.bn = static_cast<const T*>(a.w1);
  p.ldbn = Cp;
  p.bk = static_cast<const T*>(a.w2);
  p.ldbk = Fp;
  p.K = Cp;
  p.N = Fp;
  p.b1 = a.b1;
  p.g = static_cast<T*>(a.gs);
  p.da = static_cast<T*>(a.das);
  p.ldo = Fp;
  p.vpart = vp_db1;
  e = run_product(p, true, Tp, s);
  if (e != cudaSuccess) return e;
  e = reduce(vp_db1, dvec, Fp, nm, s);
  if (e != cudaSuccess) return e;
  // 3. dh = da W1
  PArgs<T> q{};
  q.a0 = static_cast<const T*>(a.das);
  q.lda0 = Fp;
  q.bk = static_cast<const T*>(a.w1);
  q.ldbk = Cp;
  q.K = Fp;
  q.N = Cp;
  q.dh = dh;
  e = run_product(q, false, Tp, s);
  if (e != cudaSuccess) return e;
  // 4. the LayerNorm backward: dy; dLN-scale, dLN-bias
  e = allow_smem(reinterpret_cast<const void*>(wide_lnb_kernel<T>));
  if (e != cudaSuccess) return e;
  wide_lnb_kernel<T><<<nb, kThreads, smem_t, s>>>(a, dh);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = reduce(a.vpart_b, dvec + Fp + 2 * Cp, 2LL * Cp, nb, s);
  if (e != cudaSuccess) return e;
  // 5. dW1^T = da^T h ; [dW2^T ; M] = [do | dout]^T g ; dgamma
  auto gemm = kBf16 ? gemm_bf16 : gemm_f32;
  e = gemm(a.das, Fp, a.hs, Cp, wpart1, dw1, Tp, Fp, Cp, s1, s);
  if (e != cudaSuccess) return e;
  e = gemm(a.dd, 2 * Cp, a.gs, Fp, wpart2, dw2, Tp, 2 * Cp, Fp, s2, s);
  if (e != cudaSuccess) return e;
  dgamma_kernel<T><<<(Cp + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      static_cast<const T*>(a.w2), dw2 + (long long)Cp * Fp, a.vec + 2 * C,
      dvec + Fp + Cp, dvec + Fp + 4 * Cp, C, Cp, Fp);
  return cudaGetLastError();
}

}  // namespace

// The token tile for dtype (1 = bfloat16; float32 runs slak_mlp_bwd_wide)
// at this width, or -1 when no tile's shared memory fits a block.
extern "C" int slak_mlp_bwd_tile(int dtype, int Cp, int Fp) {
  if (dtype == 1)
    return Cp <= 256 &&
                   a_layout(Cp, Fp, Cp <= 128 ? 64 : 32).total <= kSmemMax &&
                   b_layout(Cp, 64).total <= kSmemMax
               ? kBT
               : -1;
  return -1;
}

// dtype: 1 = bfloat16 (float32 runs slak_mlp_bwd_wide). y, dout, dy:
// strided activations as in slak_fused_mlp; W1^T (Fp, Cp), W2^T (Cp, Fp)
// compute dtype, Cp a multiple of 16, Fp of 64; b1 (Fp), vec (5, C)
// float32; BT from
// slak_mlp_bwd_tile. Scratch, with Tp = tokens rounded up to BT: hs (Tp,
// Cp), dd (Tp, 2 Cp), gs and das (Tp, Fp) in the compute dtype; stats (Tp,
// 2), vpart_a (grid, Fp + 2 Cp), vpart_b (grid, 2 Cp), wpart1 (splits1,
// Fp, Cp), wpart2 (splits2, 2 Cp, Fp) float32. Outputs, float32: dw1 =
// dW1^T (Fp, Cp); dw2 (2 Cp, Fp), whose first Cp rows are dW2^T; dvec =
// [db1 (Fp) | db2 | (sum_t dout) | dlns | dlnb | dgamma (Cp each)].
// Returns the cudaError_t of the launches.
extern "C" int slak_mlp_bwd(int dtype, const void* y, const void* dout,
                            void* dy, const void* w1, const void* w2,
                            const float* b1, const float* vec, void* hs,
                            void* dd, void* gs, void* das, float* stats,
                            float* vpart_a, float* vpart_b, float* wpart1,
                            float* wpart2, float* dw1, float* dw2,
                            float* dvec, long long n_outer, long long P,
                            long long sN, long long sC, long long sP, int C,
                            int Cp, int Fp, int BT, int grid, int splits1,
                            int splits2, void* stream) {
  if (Cp % 16 || Fp % 64 || C > Cp || BT < 16 || BT % 16 || grid < 1 ||
      splits1 < 1 || splits2 < 1)
    return (int)cudaErrorInvalidValue;
  BArgs a{y, dout, dy, w1, w2, b1, vec, hs, dd, gs, das, stats, vpart_a,
          vpart_b, n_outer, P, sN, sC, sP, C, Cp, Fp, BT};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)launch_bf16(a, grid, wpart1, wpart2, dw1, dw2, dvec, splits1,
                            splits2, s);
  return (int)cudaErrorInvalidValue;
}


// K9. The bytes of the workspace slak_mlp_bwd_wide takes for dtype (0 =
// float32, 1 = bfloat16), Tp = the tokens rounded up to 128, and the two
// weight-gradient GEMMs' token splits s1 and s2 (-1 for a bad dtype).
extern "C" long long slak_mlp_bwd_wide_workspace(int dtype, long long Tp,
                                                 int Cp, int Fp, int s1,
                                                 int s2) {
  if (dtype != 0 && dtype != 1) return -1;
  return (long long)w_layout(dtype == 1 ? 2 : 4, Tp, Cp, Fp, s1, s2).total;
}

// K9: the tail's backward at any width. Arguments as slak_mlp_bwd's, but
// one workspace (slak_mlp_bwd_wide_workspace bytes) for every scratch
// buffer, and dy float32 (shaped and strided like y). Outputs as
// slak_mlp_bwd's: dw1 = dW1^T (Fp, Cp), dw2 (2 Cp, Fp) whose first Cp rows
// are dW2^T, dvec = [db1 (Fp) | db2 | (sum_t dout) | dlns | dlnb | dgamma
// (Cp each)]. Returns the cudaError_t of the launches.
extern "C" int slak_mlp_bwd_wide(int dtype, const void* y, const void* dout,
                                 float* dy, const void* w1, const void* w2,
                                 const float* b1, const float* vec, void* ws,
                                 float* dw1, float* dw2, float* dvec,
                                 long long n_outer, long long P, long long sN,
                                 long long sC, long long sP, int C, int Cp,
                                 int Fp, int s1, int s2, void* stream) {
  if (Cp % 16 || Fp % 64 || C < 1 || C > Cp || s1 < 1 || s2 < 1)
    return (int)cudaErrorInvalidValue;
  BArgs a{y, dout, dy, w1, w2, b1, vec, nullptr, nullptr, nullptr, nullptr,
          nullptr, nullptr, nullptr, n_outer, P, sN, sC, sP, C, Cp, Fp, kWT};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_wide<float>(a, ws, dw1, dw2, dvec, s1, s2, s);
  if (dtype == 1)
    return (int)launch_wide<bf16>(a, ws, dw1, dw2, dvec, s1, s2, s);
  return (int)cudaErrorInvalidValue;
}
