// Hopper building blocks shared by mlp.cu and mlp_bwd.cu (sm_90a): mbarrier
// waits that trap instead of hanging the card, TMA loads and stores
// (cp.async.bulk.tensor) completing on an mbarrier or a bulk group, the
// proxy fence, a warpgroup's named barrier, the 1024-byte-aligned dynamic
// shared memory that the 128-byte swizzle needs, and, on the host, tensor
// maps from cuTensorMapEncodeTiled (through dlopen of libcuda.so.1: no
// link against libcuda), the SM count and the pick of a GEMM's column tile.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <dlfcn.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr unsigned long long kHangNs = 10000000000ull;   // 10 s

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, int parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
  return ok != 0;
}

// Wait for the phase of the given parity to complete. A wait that lasts
// kHangNs traps (the launch then fails) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t b = smem_u32(bar);
  if (mbar_try(b, parity)) return;
  unsigned long long t0, t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t0));
  while (!mbar_try(b, parity)) {
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
    if (t - t0 > kHangNs) __trap();
  }
}

// The box at element (col, row) of a 2-D tensor map into shared memory,
// completing on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(col), "r"(row)
      : "memory");
}

// The shared-memory box at src to element (col, row) of a 2-D tensor map;
// then bulk_commit, and bulk_wait_read<N> before src is written again.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int col,
                                          long long row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)),
         "r"(col), "r"((int)row)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}

// Shared-memory writes of this thread visible to TMA (the async proxy).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier of the 128 threads of consumer warpgroup wg.
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The dynamic shared memory, 1024-byte aligned (the swizzle's period).
__device__ __forceinline__ unsigned char* smem_1k() {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, from libcuda.so.1, which the CUDA runtime
// has loaded (no link against libcuda).
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return lib == nullptr ? nullptr : reinterpret_cast<EncodeTiled>(
                                          dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// A tensor map of the row-major bf16 (or, f32, float32) matrix (rows, cols)
// at base: boxes of box_cols columns x box_rows rows, in the 128-byte
// swizzle (wgmma's operands) or plain; loads fill zeros outside, stores
// clip. Rows are pitch elements apart (default cols).
bool tensor_map(CUtensorMap* map, const void* base, long long rows,
                int cols, int box_rows, int box_cols = 64,
                bool swizzle = true, long long pitch = 0, bool f32 = false) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const size_t elem_bytes = f32 ? sizeof(float) : sizeof(__nv_bfloat16);
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)(pitch > 0 ? pitch : cols) * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            2, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

// The GEMM's column tile: the BN whose waves of tiles (persistent blocks,
// one an SM) take the least time, a tile's time taken as BN + 64 (its
// share of A's loads and its epilogue, in units of B columns).
int pick_bn(long long m_tiles, int N, int sms, std::initializer_list<int> bns) {
  int best = 0;
  long long best_cost = 0;
  for (int bn : bns) {
    const long long tiles = m_tiles * ((N + bn - 1) / bn);
    const long long cost = (tiles + sms - 1) / sms * (bn + 64);
    if (best == 0 || cost < best_cost) {
      best = bn;
      best_cost = cost;
    }
  }
  return best;
}

}  // namespace
