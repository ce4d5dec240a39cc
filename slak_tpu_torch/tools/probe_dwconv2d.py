"""K6 on stage 4's 7x7 maps: the Toeplitz kernel against the band kernel,
a use at a time.

    python3 -m slak_tpu_torch.tools.probe_dwconv2d [--rounds 5]

At SLaK-T 51x51 w1.3's stage 4 (C = 998, 7x7, taps (13, 5) and (5, 13),
bf16) and batches 64, 128 and 256, each use of K1's function there -- the
eval pair (the (5, 13) launch adding into the (13, 5) one's output), the
K4 pair and the dgrad pair (the flipped taps) -- on each route of
``ops/dwconv.py`` (``toeplitz2d``, the route stage 4 takes; ``band``,
which served it before), checked against the plain versions, then timed
four ways: through the wrapper with CUDA events (``ms``, what a caller
sees; on these maps the host's time a launch can set it), the device's
busy time under torch.profiler (``device_ms``, the kernels' summed
durations), the host's time a call (``host_us``: the wall time of 100
calls without a sync), beside the bytes bound. Needs one CUDA card.

    python3 -m slak_tpu_torch.tools.probe_dwconv2d --ablate [--batch 128]

builds ``ops/csrc/dwconv2d.cu`` as it is, with phases of the kernel
removed and with the settings its design chose against, each into its own
library under ``slak_tpu_torch/_build/probe/`` (with ptxas's registers and
spills), and times each variant's ``slak_dwconv2d`` called directly (no
Python wrapper), without and with ``accumulate``, at stage 4's (13, 5)
taps, on CUDA events and as device time. Removed (``no_``):

- ``products``: no A fragment loads, ldmatrix or mma.sync;
- ``mma``: no mma.sync (the fragments still loaded and used);
- ``a2``: A2 is not built (nor its taps read);
- ``epilogue``: nothing is rounded into the staged output run;
- ``stores``: nothing is stored to device memory;
- ``prefetch``: the next item's runs are not staged (only each block's
  first item is loaded).

Alternatives (``alt_``): ``cb1`` (1 channel a run: 4 of the 8 warps
idle), ``grid_items`` (a block an item: no persistent blocks, no
prefetch), ``min_blocks3`` (registers held to 3 blocks an SM: at most 85,
against 90 at NT = 7, where the registers allow 2). The removal variants compute wrong results by design; only the
unchanged build is a kernel of the port. Needs nvcc besides the card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import time

import torch

from slak_tpu_torch.ops import dwconv as K1
from slak_tpu_torch.tools import timing
from slak_tpu_torch.tools.timing import (PEAK_BYTES_PER_S, device_line,
                                         require_cuda, time_ms)

C, H, K = 998, 7, 13              # SLaK-T 51x51 w1.3's stage 4 at 224^2
BATCHES = (64, 128, 256)
ROUTES = ("band", "toeplitz2d")
TOL = 1e-2                        # bf16: one rounding flip at the scale


def rel(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp(min=1e-30)).item()


def device_ms(fn, calls: int = 20) -> float:
    """The device's busy time a call: the kernels' summed durations under
    torch.profiler over ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us += getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0.0))
    return us / calls / 1e3


def host_us(fn, calls: int = 100) -> float:
    """The host's time a call: wall time of ``calls`` calls without a
    sync (the queue stays far from full)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def uses(x, ws):
    """{use: (fn(route), plain(), bytes)}: the eval pair, the K4 pair and
    the dgrad pair at these operands."""
    flipped = [w.flip(1, 2).contiguous() for w in ws]
    nb = x.numel() * x.element_size()
    return {
        "k1_pair": (lambda r: K1.launch(r, x, ws[1], K1.launch(r, x, ws[0])),
                    lambda: K1.dwconv_plain(x, ws[1],
                                            K1.dwconv_plain(x, ws[0])),
                    5 * nb),
        "k4_pair": (lambda r: [K1.launch_stats(r, x, w) for w in ws],
                    lambda: [K1.dwconv_stats_plain(x, w) for w in ws],
                    4 * nb),
        "dgrad_pair": (lambda r: [K1.launch(r, x, w) for w in flipped],
                       lambda: [K1.dwconv_plain(x, w) for w in flipped],
                       4 * nb)}


def _flat(v):
    return v if isinstance(v, torch.Tensor) else torch.cat(
        [t.flatten().float() for u in v for t in
         (u if isinstance(u, tuple) else (u,))])


def run(rounds: int = 5):
    """One row a batch and use: each route's error, ms, device ms and host
    us, the bound."""
    dev = require_cuda("probe_dwconv2d")
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for batch in BATCHES:
        x = torch.randn(batch, C, H, H, generator=g, device=dev
                        ).to(torch.bfloat16)
        ws = [(torch.randn(C, *t, generator=g, device=dev) * 0.05
               ).to(torch.bfloat16).float() for t in ((K, 5), (5, K))]
        for use, (fn, plain, nbytes) in uses(x, ws).items():
            want = _flat(plain())
            row = dict(use=use, batch=batch, C=C, H=H, taps=[K, 5],
                       bytes_bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3)
            for r in ROUTES:
                row[r + "_err"] = rel(_flat(fn(r)), want)
                row[r + "_ms"] = time_ms(lambda: fn(r), rounds=rounds)
                row[r + "_device_ms"] = device_ms(lambda: fn(r))
                row[r + "_host_us"] = host_us(lambda: fn(r))
            if max(row[r + "_err"] for r in ROUTES) > TOL:
                raise RuntimeError(f"probe_dwconv2d: {use} bs{batch} off: "
                                   f"{row}")
            rows.append(row)
        del x
        torch.cuda.empty_cache()
    return rows


_GRID = "  const int blocks = (int)(g.items < most ? g.items : most);"
# phase -> [(text in dwconv2d.cu, replacement), ...]; each text must be there
EDITS = {
    "products": [("      for (int ks = 0; ks < KS; ++ks) {\n"
                  "        unsigned a[4];",
                  "      for (int ks = 0; ks < 0; ++ks) {\n"
                  "        unsigned a[4];")],
    "mma": [("          mma_bf16(acc[2 * np], a, bb[0], bb[1]);",
             "          acc[2 * np][0] += __uint_as_float(a[0] ^ bb[0]);"),
            ("          if (2 * np + 1 < NT) mma_bf16(acc[2 * np + 1], a, "
             "bb[2], bb[3]);",
             "          acc[0][1] += __uint_as_float(a[1] ^ bb[2]);")],
    "a2": [("        for (int ch = 0; ch < it.cb; ++ch) {\n"
            "          const float* tc",
            "        for (int ch = 0; ch < 0; ++ch) {\n"
            "          const float* tc")],
    "epilogue": [("      for (int nt = 0; nt < NT; ++nt) {\n"
                  "        const int p = 8 * nt + 2 * tig;",
                  "      for (int nt = 0; nt < 0; ++nt) {\n"
                  "        const int p = 8 * nt + 2 * tig;")],
    "stores": [("      for (int r = ln.sr; r < it.ni; r += ln.rpp) {\n"
                "        const uintptr_t s = run_start(g, out",
                "      for (int r = ln.sr; r < 0; r += ln.rpp) {\n"
                "        const uintptr_t s = run_start(g, out")],
    "prefetch": [("    if (item + 1 < item_end)\n      stage<",
                  "    if (0)\n      stage<")],
}
# the settings the kernel's design chose against: name -> edits
ALTERNATIVES = {
    "cb1": [("constexpr int kCB = 2;", "constexpr int kCB = 1;")],
    "grid_items": [(_GRID, "  const int blocks = g.items;")],
    "min_blocks3": [("__global__ void __launch_bounds__(kThreads)\n"
                     "dwconv2d_kernel(",
                     "__global__ void __launch_bounds__(kThreads, 3)\n"
                     "dwconv2d_kernel(")],
}


def build_variants(logs=None):
    """{variant: slak_dwconv2d of its library}: "full", "no_<phase>" for
    each phase of EDITS and "alt_<name>" for each of ALTERNATIVES."""
    libs = timing.build_variants("dwconv2d", {
        "full": [], **{"no_" + k: v for k, v in EDITS.items()},
        **{"alt_" + k: v for k, v in ALTERNATIVES.items()}}, logs)
    fns = {}
    for name, lib in libs.items():
        fn = fns[name] = lib.slak_dwconv2d
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fns


def ptxas_lines(log: str):
    """ptxas's registers and spills of the Toeplitz kernel."""
    out, cur = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            cur = "dwconv2d_kernel" in line
        elif cur and ("registers" in line or "spill" in line):
            out.append(line.strip())
    return out


def ablate(batch: int = 128, rounds: int = 5):
    """One row a mode (a launch, a launch adding into out): each variant's
    ms and device ms a launch; then each variant's ptxas lines."""
    dev = require_cuda("probe_dwconv2d")
    logs = {}
    fns = build_variants(logs)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(batch, C, H, H, generator=g, device=dev
                    ).to(torch.bfloat16)
    w = (torch.randn(C, K, 5, generator=g, device=dev) * 0.05
         ).to(torch.bfloat16).float()
    out = torch.empty_like(x)
    nb = x.numel() * x.element_size()
    rows = []
    for acc in (0, 1):
        row = dict(batch=batch, C=C, H=H, taps=[K, 5], accumulate=acc,
                   bytes_bound_ms=(2 + acc) * nb / PEAK_BYTES_PER_S * 1e3)
        for name, fn in fns.items():
            def call(fn=fn, name=name):
                err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), batch,
                         C, H, H, K, 5, acc,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: cudaError {err}")
            row[name + "_ms"] = time_ms(call, reps=50, rounds=rounds)
            row[name + "_device_ms"] = device_ms(call)
        rows.append(row)
    rows.append({"ptxas": {k: ptxas_lines(v) for k, v in logs.items()}})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--ablate", action="store_true",
                    help="time the kernel with phases removed")
    args = ap.parse_args(argv)
    rows = ablate(args.batch, args.rounds) if args.ablate else run(
        args.rounds)
    for row in rows:
        print(json.dumps(row), flush=True)
    print(device_line())


if __name__ == "__main__":
    main()
