"""A/B: the tap-stacked banded conv (K11) against K1's band launch.

    python3 -m slak_tpu_torch.tools.probe_stacked [--batch 128]

Port of ``tools/probe_stacked.py``. At SLaK-T 51x51 w1.3's four stage
shapes ((K, 5) taps, NCHW, bf16 and fp32) it times K11
(``ops/dwconv_stacked.py``: in bf16 ``stacked_band_kernel``, g taps
stacked along M so that one B fragment feeds g taps' products, then a
warp-local shift-add; in fp32 CUDA-core FMAs) against K1's band launch
(``dwconv.launch("band", ...)``, bf16: ``dwconv_band_kernel``, the operand
shifted a tap at a time) and K1's own route (``dwconv.dwconv``: at stage 4
K6's kernel, in fp32 the 3xTF32 band kernel) with CUDA events (median over
rounds, fresh inputs each round), checks that they agree, and gives each
its share of the bound: the larger of the bytes (x read once, the output
written once) over the HBM rate and the conv's real operations (taps that
only read padding skipped) over the dtype's peak (989 TFLOP/s bf16 on the
tensor cores, 67 fp32). ``banded_flops`` counts what K11's products do (in
bf16 the m16n8k16 products of the live band tiles, their zero padding
included). Needs one CUDA card.

    python3 -m slak_tpu_torch.tools.probe_stacked --ablate [--batch 128]

builds ``ops/csrc/dwconv_stacked.cu`` as it is, with phases of the bf16
kernel removed and with a setting its design chose against, each into its
own library under ``slak_tpu_torch/_build/probe/`` (with ptxas's registers
and spills), and times each variant's ``slak_dwconv_stacked`` called
directly at the four stage shapes in bf16 with CUDA events. Removed
(``no_``): ``products`` (no fragment loads or mma.sync), ``shift_add``
(neither the warp's Z tile written nor its rows added), ``stores`` (the
outputs computed but not stored), ``prefetch`` (only each block's first
chunk loaded), ``band`` (the band tiles not built). Alternatives
(``alt_``): ``rounds2`` (two rounds of the 8 warps' tiles a chunk),
``min_blocks3`` (registers held to 3 blocks an SM: at most 85). The
removal variants compute wrong results by design; only the unchanged
build is a kernel of the port. Needs nvcc besides the card.
"""

from __future__ import annotations

import argparse
import ctypes
import json

import torch

from slak_tpu_torch.ops import dwconv as K1
from slak_tpu_torch.ops.dwconv_stacked import (dwconv_stacked, stack_group,
                                               stacked_band_products)
from slak_tpu_torch.tools import timing
from slak_tpu_torch.tools.timing import (bound_ms, conv_macs, device_line,
                                         require_cuda, time_ms)

# (tag, C, H, K): SLaK-T 51x51 w1.3 at 224^2
SHAPES = (("s1", 124, 56, 51), ("s2", 249, 28, 49), ("s3", 499, 14, 47),
          ("s4", 998, 7, 13))
S = 5


def banded_flops(n, c, h, w, kh, kw, dtype) -> int:
    """Operations K11's products issue: bf16, 2 * 16 * 8 * 16 for each
    m16n8k16 product of the live band tiles (``stacked_band_products``);
    fp32, per plane and chunk a (g*H x H) @ (H x W + kw - 1) product."""
    if dtype == torch.bfloat16:
        return 2 * 16 * 8 * 16 * stacked_band_products(h, w, kh, kw, n, c)
    g = stack_group(h, kw)
    return 2 * n * c * -(-kw // g) * g * h * h * (w + kw - 1)


def run(batch: int = 128, dtypes=(torch.bfloat16, torch.float32),
        rounds: int = 5):
    dev = require_cuda("probe_stacked")
    g = torch.Generator(device=dev).manual_seed(2)
    rows = []
    for dtype in dtypes:
        bf16 = dtype == torch.bfloat16
        for tag, c, h, k in SHAPES:
            x = torch.randn(batch, c, h, h, generator=g, device=dev
                            ).to(dtype)
            w = (torch.randn(c, k, S, generator=g, device=dev) * 0.1
                 ).to(dtype).float()

            def fresh():
                x.copy_(torch.randn(x.shape, generator=g, device=dev))
            got, want = dwconv_stacked(x, w), K1.dwconv(x, w)
            d = (got.float() - want.float()).abs().max().item()
            rel = d / max(want.float().abs().max().item(), 1e-30)
            bound, by = bound_ms(2 * x.numel() * x.element_size(),
                                 2 * conv_macs(batch, c, h, h, k, S), dtype)
            stacked = time_ms(lambda: dwconv_stacked(x, w), fresh,
                              rounds=rounds)
            k1 = time_ms(lambda: K1.dwconv(x, w), fresh, rounds=rounds)
            row = dict(
                shape=tag, batch=batch, C=c, H=h, taps=[k, S],
                dtype=str(dtype).split(".")[1], g=stack_group(h, S),
                stacked_ms=stacked, k1_ms=k1, k1_route=K1._route_of(x, w),
                bound_ms=bound, bound_by=by,
                stacked_bound_share=bound / stacked,
                k1_bound_share=bound / k1,
                banded_flops=banded_flops(batch, c, h, h, k, S, dtype),
                max_abs_diff_vs_k1=d, rel_diff_vs_k1=rel)
            if bf16:
                band = time_ms(lambda: K1.launch("band", x, w), fresh,
                               rounds=rounds)
                row.update(k1_band_ms=band, speedup_vs_band=band / stacked)
            rows.append(row)
            del x, got, want
    return rows


# phase -> [(text in dwconv_stacked.cu, replacement), ...]
EDITS = {
    "products": [("    for (int q = 0; q < g.nc; ++q) {\n"
                  "      const unsigned live = mask[q];",
                  "    for (int q = 0; q < 0; ++q) {\n"
                  "      const unsigned live = mask[q];")],
    "shift_add": [("    if (g.g > 1) {\n#pragma unroll",
                   "    if (0) {\n#pragma unroll"),
                  ("for (int t = 1; t < g.g; ++t, zr += g.H * g.ZP) {",
                   "for (int t = 1; t < 1; ++t, zr += g.H * g.ZP) {")],
    "stores": [("          stacked_put<PAIR>(g, out, plane, h, w, v0, v1);",
                "          if (g.N < 0) stacked_put<PAIR>(g, out, plane, h, "
                "w, v0, v1);")],
    "prefetch": [("  if (nq > 1)\n    stacked_load",
                  "  if (0)\n    stacked_load"),
                 ("      if (qi + 2 < nq)\n        stacked_load",
                  "      if (0)\n        stacked_load")],
    "band": [("i < (TOEP ? g.nc * (2 * MQ - 1) * 32 : 0);",
              "i < 0;"),
             ("i < (TOEP ? 0 : g.nc * MQ * g.KT * 32);", "i < 0;")],
}
ALTERNATIVES = {
    "rounds2": [("  int nb = kWarps / g.TPI;",
                 "  int nb = 2 * kWarps / g.TPI;")],
    "min_blocks3": [("__global__ void __launch_bounds__(kThreads, 2)\n"
                     "stacked_band_kernel(",
                     "__global__ void __launch_bounds__(kThreads, 3)\n"
                     "stacked_band_kernel(")],
}


def build_variants(logs=None):
    """{variant: slak_dwconv_stacked of its library}: "full", "no_<phase>"
    for each phase of EDITS and "alt_<name>" for each of ALTERNATIVES."""
    libs = timing.build_variants("dwconv_stacked", {
        "full": [], **{"no_" + k: v for k, v in EDITS.items()},
        **{"alt_" + k: v for k, v in ALTERNATIVES.items()}}, logs)
    fns = {}
    for name, lib in libs.items():
        fn = fns[name] = lib.slak_dwconv_stacked
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                       + [ctypes.c_longlong] + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fns


def ptxas_lines(log: str):
    """ptxas's registers and spills of the bf16 kernel's instantiations."""
    out, cur = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            cur = "stacked_band_kernel" in line
        elif cur and ("registers" in line or "spill" in line):
            out.append(line.strip())
    return out


def ablate(batch: int = 128, rounds: int = 5):
    """One row a stage shape: each variant's ms a bf16 launch (and the sum
    over the four shapes); then each variant's ptxas lines."""
    dev = require_cuda("probe_stacked")
    logs = {}
    fns = build_variants(logs)
    g = torch.Generator(device=dev).manual_seed(3)
    rows, total = [], {}
    for tag, c, h, k in SHAPES:
        x = torch.randn(batch, c, h, h, generator=g, device=dev
                        ).to(torch.bfloat16)
        w = (torch.randn(c, k, S, generator=g, device=dev) * 0.1
             ).to(torch.bfloat16).float()
        out = torch.empty_like(x)
        row = dict(shape=tag, batch=batch, C=c, H=h, taps=[k, S],
                   g=stack_group(h, S),
                   bytes_bound_ms=bound_ms(2 * x.numel() * 2, 0,
                                           torch.bfloat16)[0])
        for name, fn in fns.items():
            def call(fn=fn, name=name):
                err = fn(1, x.data_ptr(), w.data_ptr(), out.data_ptr(),
                         batch, c, h, h, k, S,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: cudaError {err}")
            row[name + "_ms"] = time_ms(call, reps=20, rounds=rounds)
            total[name] = total.get(name, 0.0) + row[name + "_ms"]
        row["k1_band_ms"] = time_ms(lambda: K1.launch("band", x, w), reps=20,
                                    rounds=rounds)
        total["k1_band"] = total.get("k1_band", 0.0) + row["k1_band_ms"]
        rows.append(row)
        del x, out
        torch.cuda.empty_cache()
    rows.append({"sum_ms": total})
    rows.append({"ptxas": {k: ptxas_lines(v) for k, v in logs.items()}})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--ablate", action="store_true",
                    help="time the bf16 kernel with phases removed")
    args = ap.parse_args(argv)
    rows = (ablate(args.batch, args.rounds) if args.ablate
            else run(args.batch, rounds=args.rounds))
    for row in rows:
        print(json.dumps(row), flush=True)
    print(device_line())


if __name__ == "__main__":
    main()
