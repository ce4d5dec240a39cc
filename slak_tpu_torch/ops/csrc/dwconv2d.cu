// Depthwise "same" convolution, stride 1, any odd taps, NCHW bf16, on small
// maps (H * W <= 64): one dense product a channel on the tensor cores.
//
// Replaces slak_tpu/ops/pallas_banded.py: dwconv_banded2d_cmajor
// (_fwd2d_kernel), the TPU kernel of stage 4's 7x7 maps. Where H * W is
// small the whole conv of a channel is one product with the doubly blocked
// Toeplitz matrix build_banded2d gives, A2_c[p][q] = w[hq - hp + kh/2]
// [wq - wp + kw/2] (zero off the taps), p = (hp, wp) the output pixel and
// q = (hq, wq) the input pixel:  y_c[n][p] = sum_q A2_c[p][q] x_c[n][q].
// The TPU kernel puts the pixels on the MXU's rows and the batch on its
// 128 lanes, which needs x in a C-major (C, H*W, N) layout. Here the batch
// goes on the 64 rows of the tensor cores' tiles and NCHW is read as it
// lies: for each channel, over a tile of 64 images,
//   Y^T (64 images x P) = X^T (64 images x P) . A2_c^T,
// with mma.sync m16n8k16 (bf16 in, fp32 sums): M = the images (four m16
// tiles, a warp each; a block's 8 warps take the two channels of a run),
// N = the output pixels (P padded to 8: 7 n-tiles at 7x7), k = the input
// pixels (P padded to 16: four k-steps). Both operands
// are k-major as they lie: an image's plane is contiguous in q (X^T's rows,
// the A fragments), and A2's row p is contiguous in q (B's columns, read
// with ldmatrix). A2 is built in shared memory from the taps and never
// written to device memory. The three uses are one kernel body: the
// forward (with `accumulate` the result is added to what `out` holds, one
// rounding, so the pair runs as two launches into one output), the stats
// variant (each channel's sum of the stored y and of its square, in a fixed
// order) and the dgrad, the forward on the taps flipped on both axes
// (A2(flip w) = A2(w)^T; the wrappers flip them).
//
// What bounds it on an H100: the bytes. At stage 4 (C = 998, 7x7, bs128)
// a launch reads 12.5 MB and writes 12.5 MB (7.5 us at 3.35 TB/s); its
// products are about 1 GFLOP (1 us at the bf16 rate). So the design's work
// is keeping loads in flight, moving whole runs, not 2-byte values, and
// spending few instructions a byte: on these maps the instructions that
// address, stage and round each byte, not the bytes, set the time
// (tools/probe_dwconv2d.py --ablate), so the loops have compile-time
// bounds and no divisions: the kernel is instantiated for each n-tile
// count NT (1-8) and mode (plain, accumulate, stats), 8 warps a block:
//
// - Work items. An item is a run of CB = 2 consecutive channels over a tile
//   of 64 images, so each image's slice of the item is one contiguous run of
//   CB * P * 2 bytes of the (N, C * P) view. Blocks are persistent: each
//   walks a contiguous range of the items (run-major, so consecutive tiles
//   of a run share its A2 and its taps are staged once) and, while one
//   item's products and stores run, the next item's runs (and, with
//   `accumulate`, out's) are in flight with cp.async (two staged buffers).
// - Staging. A plane is 98 bytes at 7x7, so the (N, C * 49) view's rows and
//   runs are not 16-byte aligned (at C = 998 the row pitch is 97,804 bytes):
//   neither TMA (16-byte strides) nor a 16-byte cp.async from the run's own
//   start takes them. Each image's run is staged as the aligned 16-byte
//   chunks that cover it (a chunk shares no more than its 16-byte granule
//   with the neighbouring runs, and never leaves the allocation's granule),
//   at a row of its own, the run's offset in its first chunk (the lead)
//   kept; 16 (32 where a run has more than 16 chunks) lanes take a row, a
//   chunk each, so a warp moves whole runs. An A fragment's register holds
//   two neighbouring pixels of one image: two 4-byte shared loads and a
//   funnel shift where the pair is not 4-byte aligned. Pixels past P,
//   images past N and channels past C are masked to zero in the fragments
//   (stale shared memory never reaches a product).
// - A2. Each item builds its channels' A2 (64 rows x 72 bf16, 9 KB a
//   channel) from the staged taps: each lane keeps, in registers, the tap
//   indices of its entries (computed once a block: in the taps' window that
//   reaches the map, a zero slot for the entries off the taps), two entries
//   a 4-byte store.
// - Stores. The fp32 accumulators are rounded once into a staged output
//   run laid out as the global run (the same lead; 2-byte stores, no
//   branch on the pair's alignment), then written back as aligned 16-byte
//   chunks; the two edge chunks of a run, shared with the neighbouring
//   runs, with aligned 2-, 4- and 8-byte stores of the run's own bytes
//   only. With
//   `accumulate` the staged output run first holds out's run (staged like
//   x's), so the add reads shared memory.
// - The stats variant (part != nullptr) sums the stored values and their
//   squares in each thread's store order in fp32 (separate multiply and add,
//   so a plain version can repeat the sums), a butterfly over the warp, the
//   4 m-tiles' warps in order: one partial pair per (image tile, channel);
//   a second launch (dwconv2d_stats_reduce, copied from csrc/dwconv.cu's
//   dwconv_stats_reduce) sums the partials of each channel in a fixed
//   order. No atomics: the sums are the same bits on every run.
//
// ops/dwconv2d.py repeats the geometry (dwconv2d_geometry), the
// decomposition and the sums' order in plain PyTorch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <mutex>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;          // 8 warps: an m16 tile of images
constexpr int kWarps = kThreads / 32;  // (warp & 3) of a channel (warp >> 2)
constexpr int kMI = 64;                // images a tile: the 64 rows
constexpr int kPMax = 64;              // H * W (ops/dwconv.py P_MAX)
constexpr int kRows = 64;              // A2 rows: 8 n-tiles of output pixels
constexpr int kAPitch = 72;            // A2's row pitch in bf16 (64 + 8)
constexpr int kA2Bytes = kRows * kAPitch * 2;
constexpr int kCB = 2;                 // channels a run: a warp's channel
constexpr int kMTiles = 4;             // m16 tiles of a channel's images
constexpr int kLeadMax = 14;           // a run's offset in its first chunk
constexpr int kRedThreads = 256;       // the second pass's block
constexpr int kRedWarps = kRedThreads / 32;
constexpr size_t kSmemMax = 200 * 1024;

struct Geom2d {
  int N, C, H, W, kh, kw;
  int P, NT, KS, QP;       // pixels; n-tiles of 8; k-steps of 16; P to 16
  int CB, R, T, items;     // channels a run; runs; image tiles; R * T
  int NCH, RP;             // 16-byte chunks a staged run at most; row pitch
  int tr0, TR, tc0, TC;    // the taps' window that reaches the map: its
                           // first row and column, its rows and columns
  int KW, KWP;             // its taps (the zero slot at KW), a channel's
                           // slots (KW + 1 to 4)
  int x_off, o_off, o_bufs, a_off, t_off, r_off;   // shared memory
  int smem;
};

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src));
}

__device__ __forceinline__ void cp4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(d), "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned* r, const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
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

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The two bf16 values at byte offset `off` (even) of a staged row (16-byte
// aligned): one 4-byte load where off is 4-byte aligned, else the halves
// of two neighbouring words.
__device__ __forceinline__ unsigned ld_pair(const unsigned char* row,
                                            int off) {
  const unsigned* p = reinterpret_cast<const unsigned*>(row + (off & ~3));
  return __funnelshift_r(p[0], p[1], (off & 2) * 8);
}

__device__ __forceinline__ float bf_at(const unsigned short* p) {
  return __uint_as_float((unsigned)*p << 16);
}

struct Item {
  int t, c0, cb, n0, ni;   // image tile; first channel, channels; images
};

__device__ __forceinline__ Item item_of(const Geom2d& g, int item) {
  Item it;
  const int r = item / g.T;
  it.t = item - r * g.T;
  it.c0 = r * g.CB;
  it.cb = min(g.CB, g.C - it.c0);
  it.n0 = it.t * kMI;
  it.ni = min(kMI, g.N - it.n0);
  return it;
}

// The byte address of image n's run of channels c0 .. of a (N, C, P) bf16
// tensor.
__device__ __forceinline__ uintptr_t run_start(const Geom2d& g,
                                               const void* base, int n,
                                               int c0) {
  return reinterpret_cast<uintptr_t>(base) +
         ((long long)n * g.C + c0) * g.P * 2;
}

// A thread's part in moving the staged runs: chunk sj of the rows sr, sr +
// rpp, .. (16 or 32 lanes a row, so a warp moves whole runs).
struct Lanes {
  int sj, sr, rpp;
};

// The aligned 16-byte chunks that cover each image's run of `src` into
// the rows of `dst` (row r at r * RP, the run's lead kept).
__device__ __forceinline__ void stage_runs(const Geom2d& g, const Item& it,
                                           const Lanes& ln, const void* src,
                                           unsigned char* dst) {
  if (ln.sj >= g.NCH) return;
  const int run = it.cb * g.P * 2;
  for (int r = ln.sr; r < it.ni; r += ln.rpp) {
    const uintptr_t s = run_start(g, src, it.n0 + r, it.c0);
    const uintptr_t a = (s & ~(uintptr_t)15) + 16 * ln.sj;
    if (a < s + run)
      cp16(dst + r * g.RP + 16 * ln.sj, reinterpret_cast<const void*>(a));
  }
}

// One item's loads into buffer b: x's runs, out's runs (ACC) and, where
// the item starts a run of channels (`taps`), the taps' window of its
// channels; one cp.async group.
template <bool ACC>
__device__ __forceinline__ void stage(const Geom2d& g, int item, int b,
                                      bool taps, const Lanes& ln,
                                      const bf16* x, const float* w,
                                      const bf16* out, unsigned char* sm) {
  const Item it = item_of(g, item);
  stage_runs(g, it, ln, x, sm + g.x_off + b * kMI * g.RP);
  if (ACC) stage_runs(g, it, ln, out, sm + g.o_off + b * kMI * g.RP);
  if (!taps) {
    cp_commit();
    return;
  }
  float* ts = reinterpret_cast<float*>(sm + g.t_off) + b * g.CB * g.KWP;
  for (int i = threadIdx.x; i < it.cb * g.KW; i += kThreads) {
    const int ch = i / g.KW, k = i - ch * g.KW;
    const int rr = k / g.TC, cc = k - rr * g.TC;
    cp4(ts + ch * g.KWP + k,
        w + ((long long)(it.c0 + ch) * g.kh + g.tr0 + rr) * g.kw + g.tc0 +
            cc);
  }
  cp_commit();
}

// NT: n-tiles of output pixels (P to 8); ACC: add into out; STATS: the
// stats variant (part: the partial sums).
template <int NT, bool ACC, bool STATS>
__global__ void __launch_bounds__(kThreads)
dwconv2d_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
                bf16* __restrict__ out, Geom2d g, float* __restrict__ part) {
  constexpr int KS = (NT + 1) / 2;          // k-steps of 16 input pixels
  extern __shared__ __align__(16) unsigned char sm[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int mt = warp & (kMTiles - 1), wch = warp / kMTiles;
  float* taps = reinterpret_cast<float*>(sm + g.t_off);
  bf16* a2 = reinterpret_cast<bf16*>(sm + g.a_off);
  float* red = reinterpret_cast<float*>(sm + g.r_off);
  Lanes ln;
  ln.sj = g.NCH <= 16 ? tid & 15 : lane;
  ln.sr = g.NCH <= 16 ? tid >> 4 : warp;
  ln.rpp = g.NCH <= 16 ? kThreads / 16 : kWarps;

  // the block's items: a contiguous range, so consecutive image tiles of
  // a run of channels share its A2 (built once for them)
  int item = (int)((long long)blockIdx.x * g.items / gridDim.x);
  const int item_end = (int)((long long)(blockIdx.x + 1) * g.items /
                             gridDim.x);
  if (item < item_end) stage<ACC>(g, item, 0, true, ln, x, w, out, sm);
  // the lane's A2 entries, pixels 2 lane and + 1 of the rows p = warp + 8 k:
  // their taps' indices in the staged window (KW, the zero slot, off the
  // taps), two 16-bit indices a register; and the zero slot of both tap
  // buffers (cp.async never writes it)
  unsigned tix[NT];
  {
    const int ph = g.kh / 2, pw = g.kw / 2;
#pragma unroll
    for (int k = 0; k < NT; ++k) {
      const int p = warp + 8 * k;
      unsigned v = 0;
      for (int e = 0; e < 2; ++e) {
        const int q = 2 * lane + e;
        int t = g.KW;
        if (p < g.P && q < g.P) {
          const int hp = p / g.W, wp = p - hp * g.W;
          const int hq = q / g.W, wq = q - hq * g.W;
          const int dh = hq - hp + ph, dw = wq - wp + pw;
          if (dh >= 0 && dh < g.kh && dw >= 0 && dw < g.kw)
            t = (dh - g.tr0) * g.TC + dw - g.tc0;
        }
        v |= (unsigned)t << (16 * e);
      }
      tix[k] = v;
    }
  }
  for (int i = tid; i < 2 * g.CB; i += kThreads) taps[i * g.KWP + g.KW] = 0.f;
  // the lane's A fragment masks: pixels q = 16 ks + 8 h + 2 tig and + 1
  unsigned qmask[KS][2];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = 16 * ks + 8 * h + 2 * tig;
      qmask[ks][h] = q + 1 < g.P ? 0xffffffffu : q < g.P ? 0xffffu : 0u;
    }
  const int row0 = 16 * mt + gid, row1 = row0 + 8;
  const bool a2_lane = 2 * lane < 16 * KS;

  for (int k = 0; item < item_end; ++k, ++item) {
    const int b = k & 1;
    cp_wait_all();
    __syncthreads();           // item's loads landed; the last item is done
    const bool new_run = k == 0 || item % g.T == 0;
    if (item + 1 < item_end)
      stage<ACC>(g, item + 1, b ^ 1, (item + 1) % g.T == 0, ln, x, w, out,
                 sm);
    const Item it = item_of(g, item);

    // A2 of the run's channels from the staged taps, two entries a store,
    // where the item starts the block's part of a run
    if (new_run) {
      if (a2_lane) {
        const float* ts = taps + b * g.CB * g.KWP;
        for (int ch = 0; ch < it.cb; ++ch) {
          const float* tc = ts + ch * g.KWP;
          bf16* ac = a2 + ch * kRows * kAPitch + warp * kAPitch + 2 * lane;
#pragma unroll
          for (int kk = 0; kk < NT; ++kk)
            *reinterpret_cast<__nv_bfloat162*>(ac + 8 * kk * kAPitch) =
                __floats2bfloat162_rn(tc[tix[kk] & 0xffffu],
                                      tc[tix[kk] >> 16]);
        }
      }
      __syncthreads();
    }

    unsigned char* os = sm + g.o_off + (ACC ? b : 0) * kMI * g.RP;
    if (wch < it.cb) {
      const unsigned char* xs = sm + g.x_off + b * kMI * g.RP;
      const bool ok0 = row0 < it.ni, ok1 = row1 < it.ni;
      const int cq = wch * g.P * 2;
      const int xl0 = (int)(run_start(g, x, it.n0 + row0, it.c0) & 15) + cq;
      const int xl1 = (int)(run_start(g, x, it.n0 + row1, it.c0) & 15) + cq;
      const unsigned char* xr0 = xs + row0 * g.RP;
      const unsigned char* xr1 = xs + row1 * g.RP;
      float acc[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
      const bf16* ac = a2 + wch * kRows * kAPitch +
                       (((lane >> 4) << 3) + (lane & 7)) * kAPitch +
                       ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        unsigned a[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int off = (16 * ks + 8 * h + 2 * tig) * 2;
          const unsigned m0 = ok0 ? qmask[ks][h] : 0u;
          const unsigned m1 = ok1 ? qmask[ks][h] : 0u;
          a[2 * h] = m0 ? ld_pair(xr0, xl0 + off) & m0 : 0u;
          a[2 * h + 1] = m1 ? ld_pair(xr1, xl1 + off) & m1 : 0u;
        }
#pragma unroll
        for (int np = 0; np < (NT + 1) / 2; ++np) {
          unsigned bb[4];
          ldsm_x4(bb, ac + 16 * np * kAPitch + 16 * ks);
          mma_bf16(acc[2 * np], a, bb[0], bb[1]);
          if (2 * np + 1 < NT) mma_bf16(acc[2 * np + 1], a, bb[2], bb[3]);
        }
      }
      // round once into the staged output run (adding out's value, ACC),
      // 2-byte stores; the stats in this order: n-tile, row, pixel
      const int ol0 = (int)(run_start(g, out, it.n0 + row0, it.c0) & 15);
      const int ol1 = (int)(run_start(g, out, it.n0 + row1, it.c0) & 15);
      unsigned short* o0 = reinterpret_cast<unsigned short*>(
          os + row0 * g.RP + ol0 + cq);
      unsigned short* o1 = reinterpret_cast<unsigned short*>(
          os + row1 * g.RP + ol1 + cq);
      float s = 0.f, q = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int p = 8 * nt + 2 * tig;
        const bool last = nt == NT - 1;     // the only n-tile past P
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!(h ? ok1 : ok0) || (last && p >= g.P)) continue;
          unsigned short* d = (h ? o1 : o0) + p;
          const bool two = !last || p + 1 < g.P;
          float v0 = acc[nt][2 * h], v1 = acc[nt][2 * h + 1];
          if (ACC) {
            v0 += bf_at(d);
            if (two) v1 += bf_at(d + 1);
          }
          const bf16 b0 = __float2bfloat16(v0), b1 = __float2bfloat16(v1);
          d[0] = __bfloat16_as_ushort(b0);
          if (two) d[1] = __bfloat16_as_ushort(b1);
          if (STATS) {
            const float f0 = __bfloat162float(b0);
            s = __fadd_rn(s, f0);
            q = __fadd_rn(q, __fmul_rn(f0, f0));
            if (two) {
              const float f1 = __bfloat162float(b1);
              s = __fadd_rn(s, f1);
              q = __fadd_rn(q, __fmul_rn(f1, f1));
            }
          }
        }
      }
      if (STATS) {
        s = warp_sum(s);
        q = warp_sum(q);
        if (lane == 0) {
          red[(wch * kMTiles + mt) * 2] = s;
          red[(wch * kMTiles + mt) * 2 + 1] = q;
        }
      }
    }
    __syncthreads();                        // the staged output is complete

    if (STATS && tid < it.cb) {             // the m-tiles in order
      float s = 0.f, q = 0.f;
      for (int i = 0; i < kMTiles; ++i) {
        s += red[(tid * kMTiles + i) * 2];
        q += red[(tid * kMTiles + i) * 2 + 1];
      }
      float* dst = part + ((long long)it.t * g.C + it.c0 + tid) * 2;
      dst[0] = s;
      dst[1] = q;
    }
    // the staged runs back: whole chunks inside a run as 16-byte stores,
    // the edge chunks' own bytes as aligned 2-, 4- and 8-byte pieces
    if (ln.sj < g.NCH) {
      const int run = it.cb * g.P * 2;
      for (int r = ln.sr; r < it.ni; r += ln.rpp) {
        const uintptr_t s = run_start(g, out, it.n0 + r, it.c0), e = s + run;
        const uintptr_t a = (s & ~(uintptr_t)15) + 16 * ln.sj;
        if (a >= e) continue;
        const unsigned char* src = os + r * g.RP + 16 * ln.sj;
        if (a >= s && a + 16 <= e) {
          *reinterpret_cast<uint4*>(a) =
              *reinterpret_cast<const uint4*>(src);
        } else {
          uintptr_t d = a < s ? s : a;
          const uintptr_t d_end = a + 16 < e ? a + 16 : e;
          while (d < d_end) {
            const unsigned char* sp = src + (d - a);
            if ((d & 7) == 0 && d + 8 <= d_end) {
              *reinterpret_cast<unsigned long long*>(d) =
                  *reinterpret_cast<const unsigned long long*>(sp);
              d += 8;
            } else if ((d & 3) == 0 && d + 4 <= d_end) {
              *reinterpret_cast<unsigned*>(d) =
                  *reinterpret_cast<const unsigned*>(sp);
              d += 4;
            } else {
              *reinterpret_cast<unsigned short*>(d) =
                  *reinterpret_cast<const unsigned short*>(sp);
              d += 2;
            }
          }
        }
      }
    }
  }
  cp_wait_all();             // no cp.async left in flight at exit
}

// s1[c], s2[c] = the sums of the partials of channel c over the image
// tiles, in a fixed order: one block a channel (csrc/dwconv.cu's
// dwconv_stats_reduce, copied, with one partial a tile).
__global__ void __launch_bounds__(kRedThreads)
dwconv2d_stats_reduce(const float* __restrict__ part, float* __restrict__ s1,
                      float* __restrict__ s2, int T, int C) {
  __shared__ float red[2][kRedWarps];
  const int c = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float s = 0.f, q = 0.f;
  for (int i = threadIdx.x; i < T; i += kRedThreads) {
    const float* src = part + ((long long)i * C + c) * 2;
    s += src[0];
    q += src[1];
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
    for (int w = 0; w < kRedWarps; ++w) {
      a += red[0][w];
      b += red[1][w];
    }
    s1[c] = a;
    s2[c] = b;
  }
}

int round_up(int a, int m) { return (a + m - 1) / m * m; }

// The launch geometry (ops/dwconv2d.py dwconv2d_geometry repeats it):
// false when the shapes do not fit the kernel.
bool geom2d(long long N, int C, int H, int W, int kh, int kw, int accumulate,
            Geom2d* gp) {
  if (N < 1 || N > (1LL << 30) || C < 1 || H < 1 || W < 1 ||
      H * W > kPMax || kh < 1 || kw < 1 || kh % 2 != 1 || kw % 2 != 1)
    return false;
  Geom2d g{};
  g.N = (int)N; g.C = C; g.H = H; g.W = W; g.kh = kh; g.kw = kw;
  g.P = H * W;
  g.NT = (g.P + 7) / 8;
  g.KS = (g.P + 15) / 16;
  g.QP = 16 * g.KS;
  g.CB = C < kCB ? C : kCB;
  g.R = (C + g.CB - 1) / g.CB;
  g.T = (int)((N + kMI - 1) / kMI);
  const long long items = (long long)g.R * g.T;
  if (items > (1LL << 30)) return false;
  g.items = (int)items;
  g.NCH = (kLeadMax + g.CB * g.P * 2 + 15) / 16;     // at most 17 (P = 64)
  // the pair loads read up to 8 bytes past the last chunk; a pitch of 16
  // mod 32 bytes puts the 8 rows of a fragment load on distinct banks
  g.RP = round_up(16 * g.NCH + 8, 16);
  if (g.RP % 32 == 0) g.RP += 16;
  const int ph = kh / 2, pw = kw / 2;
  g.tr0 = ph - (H - 1) > 0 ? ph - (H - 1) : 0;
  g.TR = (ph + H < kh ? ph + H : kh) - g.tr0;
  g.tc0 = pw - (W - 1) > 0 ? pw - (W - 1) : 0;
  g.TC = (pw + W < kw ? pw + W : kw) - g.tc0;
  g.KW = g.TR * g.TC;                        // at most 15 * 15 (H = W = 8)
  g.KWP = round_up(g.KW + 1, 4);
  const int buf = kMI * g.RP;
  g.x_off = 0;
  g.o_off = 2 * buf;
  g.o_bufs = accumulate ? 2 : 1;
  g.a_off = g.o_off + g.o_bufs * buf;
  g.t_off = g.a_off + g.CB * kA2Bytes;
  g.r_off = g.t_off + 2 * g.CB * g.KWP * 4;
  g.smem = g.r_off + g.CB * kMTiles * 2 * 4;
  if ((size_t)g.smem > kSmemMax) return false;
  *gp = g;
  return true;
}

// A launch of one instantiation: every SM filled to the occupancy the
// shared memory allows, no more blocks than items. The device's SM count
// and the occupancy at each shared size are looked up once an
// instantiation (the host's time a launch counts on the small maps).
template <int NT, bool ACC, bool STATS>
cudaError_t launch_t(const Geom2d& g, const void* x, const float* w,
                     void* out, float* part, cudaStream_t stream) {
  auto kernel = dwconv2d_kernel<NT, ACC, STATS>;
  static std::mutex mu;
  static int dev_seen = -1, sms = 0, n_seen = 0;
  static int smem_seen[8], per_seen[8];
  int dev, per = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (dev != dev_seen) {
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmemMax);
      if (e != cudaSuccess) return e;
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (e != cudaSuccess) return e;
      dev_seen = dev;
      n_seen = 0;
    }
    for (int i = 0; i < n_seen; ++i)
      if (smem_seen[i] == g.smem) per = per_seen[i];
    if (per == 0) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel,
                                                        kThreads, g.smem);
      if (e != cudaSuccess) return e;
      if (per < 1) return cudaErrorInvalidConfiguration;
      const int slot = n_seen < 8 ? n_seen++ : 7;
      smem_seen[slot] = g.smem;
      per_seen[slot] = per;
    }
  }
  const long long most = (long long)sms * per;
  const int blocks = (int)(g.items < most ? g.items : most);
  kernel<<<blocks, kThreads, g.smem, stream>>>(
      static_cast<const bf16*>(x), w, static_cast<bf16*>(out), g, part);
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch_nt(const Geom2d& g, int accumulate, const void* x,
                      const float* w, void* out, float* part,
                      cudaStream_t s) {
  if (part != nullptr) return launch_t<NT, false, true>(g, x, w, out, part, s);
  if (accumulate) return launch_t<NT, true, false>(g, x, w, out, part, s);
  return launch_t<NT, false, false>(g, x, w, out, part, s);
}

cudaError_t launch2d(const void* x, const float* w, void* out, long long N,
                     int C, int H, int W, int kh, int kw, int accumulate,
                     float* part, cudaStream_t stream, int* T) {
  Geom2d g;
  if (!geom2d(N, C, H, W, kh, kw, accumulate, &g))
    return cudaErrorInvalidValue;
  *T = g.T;
  switch (g.NT) {
    case 1: return launch_nt<1>(g, accumulate, x, w, out, part, stream);
    case 2: return launch_nt<2>(g, accumulate, x, w, out, part, stream);
    case 3: return launch_nt<3>(g, accumulate, x, w, out, part, stream);
    case 4: return launch_nt<4>(g, accumulate, x, w, out, part, stream);
    case 5: return launch_nt<5>(g, accumulate, x, w, out, part, stream);
    case 6: return launch_nt<6>(g, accumulate, x, w, out, part, stream);
    case 7: return launch_nt<7>(g, accumulate, x, w, out, part, stream);
    case 8: return launch_nt<8>(g, accumulate, x, w, out, part, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x, out: (N, C, H, W) bf16 contiguous, H * W <= 64; w: (C, kh, kw) float32
// taps rounded to bf16, kh and kw odd. out = conv(x, w) (+ out with
// accumulate). Returns the cudaError_t of the launch, cudaErrorInvalidValue
// for shapes it does not take.
extern "C" int slak_dwconv2d(const void* x, const float* w, void* out,
                             long long N, int C, int H, int W, int kh, int kw,
                             int accumulate, void* stream) {
  int T;
  return (int)launch2d(x, w, out, N, C, H, W, kh, kw, accumulate, nullptr,
                       static_cast<cudaStream_t>(stream), &T);
}

// The float32 scratch of the stats variant: 2 * C * image tiles (-1 when
// the kernel does not take the shapes).
extern "C" long long slak_dwconv2d_stats_scratch(long long N, int C, int H,
                                                 int W, int kh, int kw) {
  Geom2d g;
  if (!geom2d(N, C, H, W, kh, kw, 0, &g)) return -1;
  return 2LL * C * g.T;
}

// out = conv(x, w) as slak_dwconv2d (no accumulate), and s1[c], s2[c] =
// the fp32 sum and sum of squares of channel c of the stored out. part:
// slak_dwconv2d_stats_scratch floats. Two launches.
extern "C" int slak_dwconv2d_stats(const void* x, const float* w, void* out,
                                   float* part, float* s1, float* s2,
                                   long long N, int C, int H, int W, int kh,
                                   int kw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int T;
  const cudaError_t e = launch2d(x, w, out, N, C, H, W, kh, kw, 0, part, s,
                                 &T);
  if (e != cudaSuccess) return (int)e;
  dwconv2d_stats_reduce<<<C, kRedThreads, 0, s>>>(part, s1, s2, T, C);
  return (int)cudaGetLastError();
}

// The launch geometry as geom2d computes it, into out[0 .. 17]: P, NT, KS,
// QP, CB, R, T, items, NCH, RP, tr0, TR, tc0, TC, KW, KWP, the shared bytes,
// the staged output buffers. Returns cudaErrorInvalidValue for shapes the
// kernel does not take.
extern "C" int slak_dwconv2d_geom(long long N, int C, int H, int W, int kh,
                                  int kw, int accumulate, long long* out) {
  Geom2d g;
  if (!geom2d(N, C, H, W, kh, kw, accumulate, &g))
    return (int)cudaErrorInvalidValue;
  const long long v[18] = {g.P,  g.NT, g.KS, g.QP, g.CB, g.R,
                           g.T,  g.items, g.NCH, g.RP, g.tr0, g.TR,
                           g.tc0, g.TC, g.KW, g.KWP, g.smem, g.o_bufs};
  for (int i = 0; i < 18; ++i) out[i] = v[i];
  return 0;
}
