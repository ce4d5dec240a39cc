// The float32 tile product of dwconv_stacked.cu's CUDA-core path, the
// float32 tap-stacked conv (K11). A 64 x 64 output tile a block of 256
// threads, 4 x 4 outputs a thread, K in steps of TK through shared memory:
// each shared load feeds four FMAs, and an operand tile is read once for 64
// output rows or columns.
//
// Operands are read through functors f(i, k) -> float that return 0 outside
// the operand: that is how padded channels, ragged edges and the end of a
// token split load as zeros. A layout flag says which of i and k is
// contiguous in memory, so that neighbouring threads load neighbouring
// addresses. The epilogue is the caller's. Every output is one fmaf chain
// over k in order.
#pragma once

namespace simt_tile {

constexpr int kThreads = 256;
constexpr int kTile = 64;              // output rows and columns a block
constexpr int kLD = kTile + 4;         // shared row pitch (16-byte rows)
// A kernel built on product() declares __launch_bounds__(kThreads,
// kMinBlocks): 64 registers a thread, so that four blocks share an SM.
constexpr int kMinBlocks = 4;

// The (i, k) of a tile element e < 64 TK. K_CONTIG: the operand is [i][k]
// in memory (k contiguous); else [k][i].
template <int TK, bool K_CONTIG>
__device__ __forceinline__ void element(int e, int* i, int* k) {
  if (K_CONTIG) {
    *i = e / TK;
    *k = e - *i * TK;
  } else {
    *k = e / kTile;
    *i = e - *k * kTile;
  }
}

// acc[r][c] += sum over k in [k_begin, k_end) of a(4 tr + r, k) *
// b(4 tc + c, k), tr = threadIdx.x / 16 and tc = threadIdx.x % 16: the
// thread's 4 x 4 outputs of the block's tile. Every thread of the block
// calls it (it synchronizes the block). The next K step's operands are
// loaded into registers while the FMAs of this one run.
template <int TK, bool A_K_CONTIG, bool B_K_CONTIG, typename FA, typename FB>
__device__ __forceinline__ void product(const FA& a, const FB& b,
                                        long long k_begin, long long k_end,
                                        float (&acc)[4][4]) {
  constexpr int kPer = kTile * TK / kThreads;   // tile elements a thread
  static_assert(kTile * TK % kThreads == 0, "whole tiles a thread");
  __shared__ __align__(16) float as[TK][kLD];
  __shared__ __align__(16) float bs[TK][kLD];
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  float ra[kPer], rb[kPer];
  auto fetch = [&](long long k0) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      int i, k;
      element<TK, A_K_CONTIG>(threadIdx.x + j * kThreads, &i, &k);
      ra[j] = a(i, k0 + k);
      element<TK, B_K_CONTIG>(threadIdx.x + j * kThreads, &i, &k);
      rb[j] = b(i, k0 + k);
    }
  };
  if (k_begin < k_end) fetch(k_begin);
  for (long long k0 = k_begin; k0 < k_end; k0 += TK) {
    __syncthreads();                 // the previous step's tiles all read
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      int i, k;
      element<TK, A_K_CONTIG>(threadIdx.x + j * kThreads, &i, &k);
      as[k][i] = ra[j];
      element<TK, B_K_CONTIG>(threadIdx.x + j * kThreads, &i, &k);
      bs[k][i] = rb[j];
    }
    __syncthreads();
    if (k0 + TK < k_end) fetch(k0 + TK);
#pragma unroll
    for (int k = 0; k < TK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&as[k][tr * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&bs[k][tc * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
  }
}

}  // namespace simt_tile
