"""K1/K4 in bf16 on the band kernel against the tiled kernel, route by route.

    python3 -m slak_tpu_torch.tools.probe_band [--batch 128] [--size 224]
        [--rounds 5]

At SLaK-T 51x51 w1.3's four stage shapes (bf16, NCHW) for an input of
``--size``^2 (224: maps 56/28/14/7, all on ``dwconv_band_kernel``; 512,
the seg crop: 128/64/32/16, stage 1 on ``dwconv_band_slice_kernel``),
both orientations, it launches each route of ``ops/dwconv.py`` (the band
route, the default at every stage; the tiled kernel,
``dwconv_tiled_kernel``, which served them before, and above 64 until the
slice kernel), checks each against the plain version (K1 alone and into
an output, K4's y and sums; K4's sums the same bits on a second launch
and, on the band route, the same bits as ``band_stats_sums`` computes
from the kernel's own y), and times each launch with CUDA events (median
over rounds, fresh inputs each round) beside its bytes bound and one
``F.conv2d(groups=C)`` call on the same operands (the library yardstick).
Needs one CUDA card.

    python3 -m slak_tpu_torch.tools.probe_band --ablate [--batch 128]
        [--size 224]

builds ``ops/csrc/dwconv.cu`` as it is, with phases of the band kernels
removed and with the settings their design chose against, each into its
own library under ``slak_tpu_torch/_build/probe/``, and times each
variant's ``slak_dwconv_band`` at the same shapes (a removed phase's time
is roughly the full launch's minus the variant's). Each removal applies
to both kernels (the whole-image one and the slice one), so a row shows
it for the kernel that shape takes. Removed (``no_``):

- ``mma``: no mma.sync (the fragments still loaded and used);
- ``fragments``: neither mma.sync nor the ldmatrix loads that feed it;
- ``stage``: the chunks after the first are not written to the staged
  operand (nor, since then unused, loaded);
- ``stores``: nothing is stored to device memory;
- ``loads``: the chunks after the first are not read from device memory;
- ``band_build``: the band tiles are not built;
- ``epilogue``: the accumulators are neither rounded nor stored;
- ``halo``: the slice kernel's halo rows are not read (its staged halo
  rows hold whatever the registers held).

Alternatives (``alt_``): ``mt1_like_mt2`` (the small maps with MT = 2's
occupancy, staging registers and warp tile), ``mt4_3_blocks`` (three
blocks an SM at MT = 4), ``taps_rolled`` (the tap loop not unrolled),
``two_rounds`` (chunks of two rounds of warp tiles); for the slice
kernel ``slice_3_blocks`` (three blocks an SM: 80 registers),
``slice_256_blocks`` and ``slice_1024_blocks`` (about 256 or 1024 blocks
a launch instead of 512: more or fewer chunks a block),
``slice_half_rows`` (F-slices half as tall: twice the chunks, each half
the staging). The removal variants compute wrong results by design; only
the unchanged build is a kernel of the port. Needs nvcc besides the card.
"""

from __future__ import annotations

import argparse
import ctypes
import json

import torch

import torch.nn.functional as F

from slak_tpu_torch.ops import dwconv as K1
from slak_tpu_torch.tools import timing
from slak_tpu_torch.tools.timing import (PEAK_BYTES_PER_S, device_line,
                                         require_cuda, time_ms)

# SLaK-T 51x51 w1.3: each stage's channels and long taps
DIMS, KS = (124, 249, 499, 998), (51, 49, 47, 13)


def shapes(size: int = 224):
    """(tag, C, H, K) of each stage for a size^2 input (maps size / 4,
    halved a stage)."""
    return tuple((f"s{i + 1}", c, (size // 4) >> i, k)
                 for i, (c, k) in enumerate(zip(DIMS, KS)))


SHAPES = shapes(224)
TOL = 1e-2             # bf16: one rounding flip at the value's scale
TOL_SUMS = 1e-3


def rel(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp(min=1e-30)).item()


def check(route, x, w, out0):
    """Errors of one route's K1, K1 into an output and K4 against their
    plain versions; raises when one is off."""
    errs = dict(k1=rel(K1.launch(route, x, w), K1.dwconv_plain(x, w)),
                k1_acc=rel(K1.launch(route, x, w, out0.clone()),
                           K1.dwconv_plain(x, w, out0.clone())))
    y, s1, s2 = K1.launch_stats(route, x, w)
    _, t1, t2 = K1.launch_stats(route, x, w)
    yp, p1, p2 = K1.dwconv_stats_plain(x, w)
    scale = yp.float().abs().sum((0, 2, 3)).max().item()
    errs.update(k4_y=rel(y, yp),
                k4_sums=max((s1 - p1).abs().max().item(),
                            (s2 - p2).abs().max().item()) / scale,
                k4_same_bits=bool(torch.equal(s1, t1) and torch.equal(s2, t2)))
    if route == "band":
        m1, m2 = K1.band_stats_sums(y, *w.shape[1:])
        errs["k4_sums_as_band_stats_sums"] = bool(
            torch.equal(s1, m1) and torch.equal(s2, m2))
    bad = [k for k, v in errs.items()
           if v is False or (not isinstance(v, bool)
                             and v > (TOL_SUMS if k == "k4_sums" else TOL))]
    if bad:
        raise RuntimeError(f"probe_band: {bad} off: {errs}")
    return errs


def run(batch: int = 128, rounds: int = 5, size: int = 224):
    """One row a (shape, orientation): each route's errors and ms, and
    the library call's ms."""
    dev = require_cuda("probe_band")
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for tag, c, h, k in shapes(size):
        x = torch.randn(batch, c, h, h, generator=g, device=dev
                        ).to(torch.bfloat16)
        out0 = torch.randn(batch, c, h, h, generator=g, device=dev
                           ).to(torch.bfloat16)

        def fresh():
            x.copy_(torch.randn(x.shape, generator=g, device=dev))
        for taps in ((k, 5), (5, k)):
            w = (torch.randn(c, *taps, generator=g, device=dev) * 0.05
                 ).to(torch.bfloat16).float()
            nbytes = 2 * x.numel() * 2 + 4 * w.numel()
            row = dict(shape=tag, batch=batch, C=c, H=h, taps=list(taps),
                       bytes_bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3)
            row["band_geometry"] = {
                k: v for k, v in K1.band_geometry(batch, c, h, h, *taps
                                                  ).items()
                if k in ("slice", "MT", "NS", "FS", "NMB", "NG", "CPB",
                         "bpc")}
            for name in ("band", "tiled"):
                row[name + "_err"] = check(name, x, w, out0)
                row[name + "_k1_ms"] = time_ms(
                    lambda: K1.launch(name, x, w), fresh, rounds=rounds)
                row[name + "_k4_ms"] = time_ms(
                    lambda: K1.launch_stats(name, x, w), fresh,
                    rounds=rounds)
            wl = w[:, None].to(torch.bfloat16)
            row["conv2d_k1_ms"] = time_ms(
                lambda: F.conv2d(x, wl, padding=(taps[0] // 2, taps[1] // 2),
                                 groups=c), fresh, rounds=rounds)
            rows.append(row)
        del x, out0
        torch.cuda.empty_cache()
    return rows


_MMA = ("mma_bf16(acc[mt][nn], a, b[kt][nn][0], b[kt][nn][1]);",
        "acc[mt][nn][0] += __uint_as_float(a[0] ^ b[kt][nn][0]);")
_PUT = ("  if (r >= g.H || cc >= g.W) return;",
        "  if (r >= g.H || cc >= g.W || v0 != 1.2345f) return;")
_SMMA = ("mma_bf16(acc[i][nn], a, b[i + di][nn][0], b[i + di][nn][1]);",
         "acc[i][nn][0] += __uint_as_float(a[0] ^ b[i + di][nn][0]);")
# phase -> [(text in dwconv.cu, replacement), ...]; each text must be
# there; each phase removed from the whole-image and the slice kernel
EDITS = {
    "mma": [_MMA, _SMMA],
    "fragments": [
        _MMA, _SMMA,
        ("ldsm_x4(r, bs + brow[p] + j * g.P + kt * 16);",
         "r[0] = r[1] = r[2] = r[3] = brow[p] + j + kt;"),
        ("ldsm_x4(a, a_lane + (j * ND + di) * kBandTile);",
         "a[0] = a[1] = a[2] = a[3] = j * ND + di;"),
        ("ldsm_x4(r, bs + brow + j * g.P + kt * 16);",
         "r[0] = r[1] = r[2] = r[3] = brow + j + kt;"),
        ("ldsm_x4(a, a_lane + (j * kSliceND + di) * kBandTile);",
         "a[0] = a[1] = a[2] = a[3] = j * kSliceND + di;")],
    "stage": [("      band_stage<PRE>(g, blk, bsb[(qi + 1) & 1],\n"
               "                      min(g.NB, n_end - n - g.NB), pre);\n",
               ""),
              ("      slice_stage(g, blk, bsb[(qi + 1) & 1], pre, hpre);\n",
               "")],
    "stores": [("    *reinterpret_cast<unsigned*>(dst) =",
                "    if (v0 == 1.2345f) *reinterpret_cast<unsigned*>(dst) =")],
    "loads": [("        band_load<PRE, PAIR>(g, blk, x, n + 2 * g.NB,",
               "        if (0) band_load<PRE, PAIR>(g, blk, x, n + 2 * g.NB,"),
              ("        slice_load<PAIR>(g, blk, x, qq + 2, c, pre, hpre);",
               "        if (0) slice_load<PAIR>(g, blk, x, qq + 2, c, pre, "
               "hpre);")],
    "band_build": [("for (int i = threadIdx.x; i < kShort * ND * 32; "
                    "i += kThreads) {", "for (int i = threadIdx.x; i < 0; "
                    "i += kThreads) {"),
                   ("for (int i = threadIdx.x; i < kShort * kSliceND * 32; "
                    "i += kThreads) {", "for (int i = threadIdx.x; i < 0; "
                    "i += kThreads) {")],
    "epilogue": [_PUT],
    "halo": [("  for (int i = 0; i < kSliceHalo; ++i) {\n"
              "    const int t = threadIdx.x + i * kThreads;\n"
              "    unsigned v = 0u;",
              "  for (int i = 0; i < 0; ++i) {\n"
              "    const int t = threadIdx.x + i * kThreads;\n"
              "    unsigned v = 0u;")],
}
_MIN_BLOCKS = "  return MT == 1 ? 4 : 2;"
_PRE = "  return MT == 1 ? 8 : 16;"
_SLICE_BLOCKS = ("  const int chunks = g.N * g.NS;\n"
                 "  int per = (512 + C - 1) / C;")
# the settings the kernels' design chose against: name -> edits
ALTERNATIVES = {
    # the small maps at MT = 2's setting: 2 blocks an SM, 16 staging
    # registers, 8 n-tiles a warp
    "mt1_like_mt2": [(_MIN_BLOCKS, "  return 2;"),
                     (_PRE, "  return 16;"),
                     ("  return MT <= 2 ? 4 : 2;",
                      "  return MT == 1 ? 8 : MT == 2 ? 4 : 2;")],
    "mt4_3_blocks": [(_MIN_BLOCKS, "  return MT == 1 ? 4 : MT == 4 ? 3 : 2;")],
    "taps_rolled": [("#pragma unroll\n    for (int j = 0; j < kShort; ++j) {",
                     "#pragma unroll 1\n    for (int j = 0; j < kShort; ++j) "
                     "{")],
    # chunks of two rounds of warp tiles, 32 staging registers
    "two_rounds": [("int nb = 8 * band_wn(mt) / g.NTI;",
                    "int nb = 16 * band_wn(mt) / g.NTI;"),
                   (_PRE, "  return MT == 1 ? 8 : 32;")],
    "slice_3_blocks": [("__launch_bounds__(kThreads, 2)\n"
                        "dwconv_band_slice_kernel",
                        "__launch_bounds__(kThreads, 3)\n"
                        "dwconv_band_slice_kernel")],
    "slice_256_blocks": [(_SLICE_BLOCKS,
                          _SLICE_BLOCKS.replace("512 +", "256 +"))],
    "slice_1024_blocks": [(_SLICE_BLOCKS,
                           _SLICE_BLOCKS.replace("512 +", "1024 +"))],
    "slice_half_rows": [("  const int max_nt = kSlicePre * kWarps / g.LB;",
                         "  const int max_nt = kSlicePre * kWarps / g.LB "
                         "/ 2;")],
}


def build_variants():
    """{variant: slak_dwconv_band of its library}: "full", "no_<phase>"
    for each phase of EDITS and "alt_<name>" for each of ALTERNATIVES."""
    libs = timing.build_variants("dwconv", {
        "full": [], **{"no_" + k: v for k, v in EDITS.items()},
        **{"alt_" + k: v for k, v in ALTERNATIVES.items()}})
    fns = {}
    for name, lib in libs.items():
        fn = fns[name] = lib.slak_dwconv_band
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fns


def ablate(batch: int = 128, rounds: int = 5, size: int = 224):
    """One row a (shape, orientation): each variant's ms a launch."""
    dev = require_cuda("probe_band")
    fns = build_variants()
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for tag, c, h, k in shapes(size):
        x = torch.randn(batch, c, h, h, generator=g, device=dev
                        ).to(torch.bfloat16)
        out = torch.empty_like(x)
        for taps in ((k, 5), (5, k)):
            w = (torch.randn(c, *taps, generator=g, device=dev) * 0.05
                 ).to(torch.bfloat16).float()
            row = dict(shape=tag, batch=batch, C=c, H=h, taps=list(taps),
                       bytes_bound_ms=(2 * x.numel() * 2 + 4 * w.numel())
                       / PEAK_BYTES_PER_S * 1e3)
            for name, fn in fns.items():
                def call(fn=fn):
                    err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                             batch, c, h, h, *taps, 0,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{name}: cudaError {err}")
                row[name + "_ms"] = time_ms(call, reps=20, rounds=rounds)
            rows.append(row)
        del x, out
        torch.cuda.empty_cache()
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--size", type=int, default=224,
                    help="the input side: stage maps size / 4, halved a "
                         "stage (512: the seg crop)")
    ap.add_argument("--ablate", action="store_true",
                    help="time the band kernels with phases removed")
    args = ap.parse_args(argv)
    for row in (ablate if args.ablate else run)(args.batch, args.rounds,
                                                args.size):
        print(json.dumps(row), flush=True)
    print(device_line())


if __name__ == "__main__":
    main()
