"""fp32 K1 on the 3xTF32 band kernel against the tiled kernel, shape by shape.

    python3 -m slak_tpu_torch.tools.probe_band_f32 [--rounds 5]

At the ERF's four 1024^2 stage shapes (SLaK-T 51x51 w1.3, batch 1) and the
fp32 eval's four 224^2 ones (batch 64), both orientations, it launches
each fp32 route of ``ops/dwconv.py`` (``band_f32``: the band kernel of
``csrc/dwconv_f32.cu``, the default route; ``tiled``: the tiled kernel of
``csrc/dwconv.cu``, which served fp32 before), checks each against the
plain version (alone and into an output; the band kernel also the same
bits on a second launch) and times each launch with CUDA events (median
over rounds, fresh inputs each round) beside its bound (the bytes against
the lesser of the 3xTF32 and the FFMA operations) and the time of
``F.conv2d(groups=C)``. Needs one CUDA card.

    python3 -m slak_tpu_torch.tools.probe_band_f32 --stats [--rounds 5]
        [--turns 8]

times fp32 K4 (the band kernel's stats variant, route "band_f32" of
``launch_stats``) against K1 on the same kernel, against the tiled
kernel's K4 (which served fp32 K4 before) and against ``F.conv2d`` and the
two sums, at the detection backbone's four 800^2 stage shapes (batch 2)
and the flagship's 224^2 train shapes (batch 128), both orientations;
each K4 is checked against the plain version (y and both sums within
1e-5 of their scale; the band kernel's sums the same bits twice and the
bits ``band_f32_stats_sums`` adds from its y). The two K4 routes are
timed in ``--turns`` alternating turns (tiled, band_f32, band_f32,
tiled, ...), each turn both on CUDA events around the wrapper calls and
as the device time of the route's kernels (``torch.profiler``, summed
over the launch's kernels, the host's gaps left out); a row gives every
turn and each route's median. Needs one CUDA card.

    python3 -m slak_tpu_torch.tools.probe_band_f32 --ablate

builds ``ops/csrc/dwconv_f32.cu`` as it is, with phases of the kernel
removed and with the settings its design chose against, each into its own
library under ``slak_tpu_torch/_build/probe/``, prints each build's
registers and spills, and times each variant's ``slak_dwconv_band_f32`` at
the ERF shapes and the eval's 14^2 and 7^2 ones beside its error against
the plain version. Removed
(``no_``):

- ``products``: no mma.sync (the fragments still loaded and used);
- ``two_passes``: big x big alone, one TF32 pass in place of three;
- ``split``: neither operand split into TF32 planes;
- ``stage``: nothing copied into the staged operand;
- ``stores``: nothing stored to device memory.

Alternatives (``alt_``): ``one_accumulator`` (no partial a tap: all five
taps' products summed by the tensor cores), ``one_block`` (one block an SM,
up to 255 registers), ``taps_unrolled`` (the tap loop unrolled),
``mw2`` (warp tiles of 2 n-tiles along L), ``mw4`` (4 n-tiles along L
on the maps of one or two, too), ``fw1`` (warp tiles of one
f-tile of 16 rows), ``unshifted`` (k-tiles from k = 0: 9 live diagonals
at K = 51, not 8). The removal variants compute wrong results by design;
only the unchanged build is a kernel of the port. Needs nvcc besides the
card.
"""

from __future__ import annotations

import argparse
import ctypes
import json

import torch
import torch.nn.functional as F

from slak_tpu_torch.ops import dwconv as K1
from slak_tpu_torch.tools import timing
from slak_tpu_torch.tools.timing import (PEAK_BYTES_PER_S, conv_macs,
                                         device_line, require_cuda, time_ms)

PEAK_TF32 = 495e12                 # H100 SXM dense TF32 FLOP/s
PEAK_FFMA = 67e12                  # H100 SXM fp32 FLOP/s (no tensor cores)
# (tag, batch, C, H, K): SLaK-T 51x51 w1.3's stages, the ERF at 1024^2 and
# the fp32 eval at 224^2
ERF = (("erf_s1", 1, 124, 256, 51), ("erf_s2", 1, 249, 128, 49),
       ("erf_s3", 1, 499, 64, 47), ("erf_s4", 1, 998, 32, 13))
EVAL = (("eval_s1", 64, 124, 56, 51), ("eval_s2", 64, 249, 28, 49),
        ("eval_s3", 64, 499, 14, 47), ("eval_s4", 64, 998, 7, 13))
TOL = 1e-5                         # TOL_KERNEL["float32"] of chip_smoke.py


def rel(got, want) -> float:
    return ((got - want).abs().max()
            / want.abs().max().clamp(min=1e-30)).item()


def bound(n, c, h, taps, tensors=2) -> dict:
    """The launch's bound: bytes (``tensors`` maps moved once, the taps)
    against the lesser of 3xTF32 (three TF32 passes at 495 TFLOP/s) and
    FFMA (67 TFLOP/s) for the MACs the taps need."""
    flops = 2 * conv_macs(n, c, h, h, *taps)
    b = (tensors * n * c * h * h + c * taps[0] * taps[1]) * 4 \
        / PEAK_BYTES_PER_S * 1e3
    t3, ff = 3 * flops / PEAK_TF32 * 1e3, flops / PEAK_FFMA * 1e3
    return dict(bound_ms=max(b, min(t3, ff)), bytes_ms=b, ops_ms_3xtf32=t3,
                ops_ms_ffma=ff,
                bound_by="bytes" if b >= min(t3, ff) else "operations")


def run(rounds: int = 5):
    """One row a (shape, orientation): each route's errors and ms, the
    bound and the library call's ms. Raises when a route is off."""
    dev = require_cuda("probe_band_f32")
    g = torch.Generator(device=dev).manual_seed(0)
    rows, bad = [], []
    for tag, n, c, h, k in ERF + EVAL:
        x = torch.randn(n, c, h, h, generator=g, device=dev)
        out0 = torch.randn(n, c, h, h, generator=g, device=dev)

        def fresh():
            x.copy_(torch.randn(x.shape, generator=g, device=dev))
        for taps in ((k, 5), (5, k)):
            w = torch.randn(c, *taps, generator=g, device=dev) * 0.05
            geo = K1.band_f32_geometry(n, c, h, h, *taps)
            kgeo = K1.band_f32_kernel_geometry(n, c, h, h, *taps)
            if any(kgeo[key] != geo[key] for key in kgeo):
                bad.append((tag, taps, "geometry", kgeo))
            row = dict(shape=tag, batch=n, C=c, H=h, taps=list(taps),
                       **bound(n, c, h, taps), geometry={
                           key: geo[key] for key in (
                               "ND", "s", "WL", "WF", "stack", "NB", "warps",
                               "blocks", "smem")})
            for name in ("band_f32", "tiled"):
                # the plain version of this route's x (timing refreshes x)
                want = K1.dwconv_plain(x, w)
                want_acc = K1.dwconv_plain(x, w, out0.clone())
                got = K1.launch(name, x, w)
                again = K1.launch(name, x, w)
                acc = K1.launch(name, x, w, out0.clone())
                torch.cuda.synchronize()
                errs = dict(k1=rel(got, want), k1_acc=rel(acc, want_acc),
                            same_bits=bool(torch.equal(got, again)))
                row[name + "_err"] = errs
                if (errs["k1"] > TOL or errs["k1_acc"] > TOL
                        or (name == "band_f32" and not errs["same_bits"])):
                    bad.append((tag, taps, name, errs))
                row[name + "_ms"] = time_ms(lambda: K1.launch(name, x, w),
                                            fresh, rounds=rounds)
            wl = w[:, None]
            row["library_ms"] = time_ms(lambda: F.conv2d(
                x, wl, padding=(taps[0] // 2, taps[1] // 2), groups=c),
                fresh, rounds=rounds)
            rows.append(row)
            print(json.dumps(row), flush=True)
        del x, out0
        torch.cuda.empty_cache()
    if bad:
        raise RuntimeError(f"probe_band_f32: off: {bad}")
    return rows


_MMAS = ("          mma_tf32(d, as[ft], bb[dd][0], bb[dd][1]);\n"
         "          mma_tf32(d, ab[ft], bs[dd][0], bs[dd][1]);\n"
         "          mma_tf32(d, ab[ft], bb[dd][0], bb[dd][1]);\n")
# phase -> [(text in dwconv_f32.cu, replacement), ...]
EDITS = {
    "products": [(_MMAS, "          d[0] += __uint_as_float(\n"
                  "              as[ft][0] ^ as[ft][1] ^ as[ft][2] ^ "
                  "as[ft][3] ^ ab[ft][0] ^\n"
                  "              ab[ft][1] ^ ab[ft][2] ^ ab[ft][3] ^ "
                  "bb[dd][0] ^ bb[dd][1] ^\n"
                  "              bs[dd][0] ^ bs[dd][1]);\n")],
    "two_passes": [(_MMAS, _MMAS.split("\n", 2)[2])],
    "split": [("  big = tf32_bits(v);\n  small = tf32_bits(v - "
               "__uint_as_float(big));", "  big = __float_as_uint(v);\n"
               "  small = big;")],
    "stage": [("    cp_async4(xs + (LONG_H ? kk * g.P + s : s * g.P + kk), "
               "src, ok);\n", "")],
    "stores": [("          *dst = accumulate ? *dst + v : v;",
                "          if (v == 1.2345f) *dst = accumulate ? *dst + v "
                ": v;")],
}
_WIDE = ("  F32_CASE(1, 4) F32_CASE(2, 4) F32_CASE(3, 4) F32_CASE(4, 4) "
         "F32_CASE(5, 4)\n  F32_CASE(6, 4) F32_CASE(7, 4) F32_CASE(8, 4) "
         "F32_CASE(9, 4)\n")
ALTERNATIVES = {
    "one_accumulator": [("          float* d = part[ft][nt];",
                         "          float* d = acc[ft][nt];")],
    "one_block": [("__launch_bounds__(kMaxWarps * 32, 2)",
                   "__launch_bounds__(kMaxWarps * 32, 1)")],
    "taps_unrolled": [("#pragma unroll 1\n  for (int j = 0; j < kShort; "
                       "++j) {", "#pragma unroll\n  for (int j = 0; "
                       "j < kShort; ++j) {")],
    "mw2": [("  g.MW = g.LT == 1 ? 1 : g.LT == 2 ? 2 : 4;",
             "  g.MW = g.LT == 1 ? 1 : 2;"),
            (_WIDE, _WIDE.replace(", 4)", ", 2)"))],
    "mw4": [("  g.MW = g.LT == 1 ? 1 : g.LT == 2 ? 2 : 4;", "  g.MW = 4;")],
    "fw1": [("constexpr int kFW = 2;", "constexpr int kFW = 1;")],
    "unshifted": [("  for (int s = 0; s < 8; ++s) {",
                   "  for (int s = 0; s < 1; ++s) {")],
}


def build_variants():
    """({variant: slak_dwconv_band_f32 of its library}, {variant: ptxas's
    register and spill lines}): "full", "no_<phase>" for each of EDITS,
    "alt_<name>" for each of ALTERNATIVES."""
    logs = {}
    libs = timing.build_variants("dwconv_f32", {
        "full": [], **{"no_" + k: v for k, v in EDITS.items()},
        **{"alt_" + k: v for k, v in ALTERNATIVES.items()}}, logs)
    fns = {}
    for name, lib in libs.items():
        fn = fns[name] = lib.slak_dwconv_band_f32
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    regs = {name: [ln.strip() for ln in log.splitlines()
                   if "registers" in ln or "spill" in ln]
            for name, log in logs.items()}
    return fns, regs


def ablate(rounds: int = 5):
    """One row a (shape, orientation): each variant's ms a launch and its
    error against the plain version."""
    dev = require_cuda("probe_band_f32")
    fns, regs = build_variants()
    for name, lines in regs.items():
        print(json.dumps(dict(variant=name, ptxas=lines)), flush=True)
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for tag, n, c, h, k in ERF + EVAL[2:]:
        x = torch.randn(n, c, h, h, generator=g, device=dev)
        out = torch.empty_like(x)
        stream = torch.cuda.current_stream(dev).cuda_stream
        for taps in ((k, 5), (5, k)):
            w = torch.randn(c, *taps, generator=g, device=dev) * 0.05
            want = K1.dwconv_plain(x, w)
            row = dict(shape=tag, batch=n, C=c, H=h, taps=list(taps),
                       **bound(n, c, h, taps))
            for name, fn in fns.items():
                def call(fn=fn):
                    err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), n,
                             c, h, h, *taps, 0, stream)
                    if err != 0:
                        raise RuntimeError(f"{name}: cudaError {err}")
                call()
                torch.cuda.synchronize()
                row[name + "_err"] = rel(out, want)
                row[name + "_ms"] = time_ms(call, rounds=rounds)
            rows.append(row)
            print(json.dumps(row), flush=True)
        del x, out
        torch.cuda.empty_cache()
    return rows


# (tag, batch, C, H, K): the det backbone at 800^2, the fp32 train step at
# 224^2
STATS = (("det_s1", 2, 124, 200, 51), ("det_s2", 2, 249, 100, 49),
         ("det_s3", 2, 499, 50, 47), ("det_s4", 2, 998, 25, 13),
         ("train_s1", 128, 124, 56, 51), ("train_s2", 128, 249, 28, 49),
         ("train_s3", 128, 499, 14, 47), ("train_s4", 128, 998, 7, 13))


def device_ms(call, n: int = 10) -> float:
    """Device ms a call: the kernels' time over ``n`` calls
    (``probe_mlp.kernel_times``), summed over the call's kernels."""
    from slak_tpu_torch.tools.probe_mlp import kernel_times
    return sum(kernel_times(call, n).values()) * 1e-3


def run_stats(rounds: int = 5, turns: int = 4):
    """One row a (shape, orientation): K4 on the fp32 band kernel and on
    the tiled kernel (errors; ms and device ms in ``turns`` alternating
    turns, and their medians), K1 on the band kernel and the library
    composition (ms), the bound (x read, y written, the sums)."""
    import statistics
    dev = require_cuda("probe_band_f32")
    g = torch.Generator(device=dev).manual_seed(0)
    rows, bad = [], []
    for tag, n, c, h, k in STATS:
        x = torch.randn(n, c, h, h, generator=g, device=dev)

        def fresh():
            x.copy_(torch.randn(x.shape, generator=g, device=dev))
        for taps in ((k, 5), (5, k)):
            w = torch.randn(c, *taps, generator=g, device=dev) * 0.05
            row = dict(shape=tag, batch=n, C=c, H=h, taps=list(taps),
                       **bound(n, c, h, taps))
            for name in ("band_f32", "tiled"):
                # the plain version of this route's x (timing refreshes x)
                yp, p1, p2 = K1.dwconv_stats_plain(x, w)
                scale = yp.abs().sum((0, 2, 3)).max().clamp(min=1e-30)
                y, s1, s2 = K1.launch_stats(name, x, w)
                _, t1, t2 = K1.launch_stats(name, x, w)
                errs = dict(y=rel(y, yp), sums=max(
                    ((a - b).abs().max() / scale).item()
                    for a, b in ((s1, p1), (s2, p2))),
                    same_bits=bool(torch.equal(s1, t1)
                                   and torch.equal(s2, t2)))
                if name == "band_f32":
                    m1, m2 = K1.band_f32_stats_sums(y, *taps)
                    errs["mirror_bits"] = bool(torch.equal(s1, m1)
                                               and torch.equal(s2, m2))
                row[name + "_err"] = errs
                if (errs["y"] > TOL or errs["sums"] > TOL
                        or not errs["same_bits"]
                        or not errs.get("mirror_bits", True)):
                    bad.append((tag, taps, name, errs))
            order = [("tiled", "band_f32", "band_f32", "tiled")[t % 4]
                     for t in range(turns)]
            ms = {"tiled": [], "band_f32": []}
            dms = {"tiled": [], "band_f32": []}
            for name in order:
                def call(name=name):
                    return K1.launch_stats(name, x, w)
                ms[name].append(time_ms(call, fresh, rounds=rounds))
                dms[name].append(device_ms(call))
            for name in ms:
                row[name + "_ms"] = statistics.median(ms[name])
                row[name + "_device_ms"] = statistics.median(dms[name])
                row[name + "_turns_ms"] = ms[name]
                row[name + "_turns_device_ms"] = dms[name]
            row["order"] = order
            row["k1_band_f32_ms"] = time_ms(
                lambda: K1.launch("band_f32", x, w), fresh, rounds=rounds)
            wl = w[:, None]

            def lib():
                y = F.conv2d(x, wl, padding=(taps[0] // 2, taps[1] // 2),
                             groups=c)
                return y.sum((0, 2, 3)), y.square().sum((0, 2, 3))
            row["library_ms"] = time_ms(lib, fresh, rounds=rounds)
            rows.append(row)
            print(json.dumps(row), flush=True)
        del x
        torch.cuda.empty_cache()
    if bad:
        raise RuntimeError(f"probe_band_f32: off: {bad}")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--stats", action="store_true",
                    help="fp32 K4 at the det and train shapes")
    ap.add_argument("--turns", type=int, default=4,
                    help="--stats: alternating turns of the two K4 routes")
    args = ap.parse_args(argv)
    print(device_line(), flush=True)
    rows = (ablate(args.rounds) if args.ablate
            else run_stats(args.rounds, args.turns) if args.stats
            else run(args.rounds))
    print(json.dumps({"probe_band_f32": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
