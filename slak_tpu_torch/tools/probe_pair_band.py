"""K10 in bf16 on the band kernel against ``dwpair_kernel``, a launch at a
time.

    python3 -m slak_tpu_torch.tools.probe_pair_band [--batch 64] [--rounds 5]

At SLaK-T 51x51 w1.3's four dual stage shapes (224^2, bf16), the dual
stage's launch (``dualboth``, the raw pair y1, y2q) on each route of
``ops/dwpair.py`` (the band kernel, ``dwpair_band_kernel``, the route the
dual stages take; ``dwpair_kernel``, the taps on the CUDA cores, which
served them before), each checked against ``dwpair_plain`` and the band
route against its own bits on a second launch, then timed with CUDA
events (median over rounds, fresh inputs each round) beside the bytes
bound and the bf16 K1 band pair at the same shapes (two launches of
``dwconv_band_kernel``, one a branch). Needs one CUDA card.

    python3 -m slak_tpu_torch.tools.probe_pair_band --ablate [--batch 64]

builds ``ops/csrc/dwpair.cu`` as it is, with phases of the band kernel
removed and with the per-MT settings its design chose against, each into
its own library under ``slak_tpu_torch/_build/probe/`` (with ptxas's
registers and spills), and times each variant's ``slak_dwpair_band`` at
the same shapes (a removed phase's time is roughly the full launch's minus
the variant's). Removed (``no_``):

- ``mma``: no mma.sync (the fragments still loaded and used);
- ``fragments``: neither mma.sync nor the ldmatrix loads that feed it (no
  products);
- ``stage``: the chunks after the first are not written to the staged
  operand (no staging);
- ``loads``: the chunks after the first are not read from device memory;
- ``stores``: nothing is stored to device memory;
- ``band_build``: the band tiles are not built;
- ``branch2``: the launch has branch 1's blocks alone (one branch).

Alternatives (``alt_``), each a per-MT setting: ``mt1_like_mt2`` (the
small maps with MT = 2's occupancy, staging registers and warp tile),
``mt4_3_blocks`` (three blocks an SM at MT = 4), ``mt3_3_blocks`` (three at
MT = 2 and 3), ``wn4`` (4 n-tiles a warp at MT = 3 and 4), ``two_rounds``
(chunks of two rounds of warp tiles, 32 staging registers). The removal
variants compute wrong results by design; only the unchanged build is a
kernel of the port. Needs nvcc besides the card.
"""

from __future__ import annotations

import argparse
import ctypes
import json

import torch

from slak_tpu_torch.ops import dwconv as K1
from slak_tpu_torch.ops import dwpair as K10
from slak_tpu_torch.tools import timing
from slak_tpu_torch.tools.timing import (PEAK_BYTES_PER_S, device_line,
                                         require_cuda, time_ms)

# (tag, C, H, K): SLaK-T 51x51 w1.3's dual stages at 224^2
SHAPES = (("s1", 124, 56, 51), ("s2", 249, 28, 49), ("s3", 499, 14, 47),
          ("s4", 998, 7, 13))
TOL = 1e-2             # bf16: one rounding flip at the value's scale


def rel(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp(min=1e-30)).item()


def inputs(g, batch, c, h, k):
    """x, xq, and (K, 5) / (5, K) taps rounded to bf16."""
    dev = g.device
    x = torch.randn(batch, c, h, h, generator=g, device=dev
                    ).to(torch.bfloat16)
    w1, w2 = ((torch.randn(c, *t, generator=g, device=dev) * 0.05
               ).to(torch.bfloat16).float() for t in ((k, 5), (5, k)))
    return x, x.transpose(2, 3).contiguous(), w1, w2


def bytes_bound_ms(x, w1) -> float:
    """x and xq read once, y1 and y2q written once, both taps read."""
    return (4 * x.numel() * x.element_size() + 8 * w1.numel()) \
        / PEAK_BYTES_PER_S * 1e3


def run(batch: int = 64, rounds: int = 5):
    """One row a stage shape: each route's errors and ms a launch, the K1
    band pair's ms, the bound."""
    dev = require_cuda("probe_pair_band")
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for tag, c, h, k in SHAPES:
        x, xq, w1, w2 = inputs(g, batch, c, h, k)
        args = (x, w1, w2, "dualboth", xq, False)

        def fresh():
            x.copy_(torch.randn(x.shape, generator=g, device=dev))
            xq.copy_(x.transpose(2, 3))
        want = K10.dwpair_plain(*args)
        row = dict(shape=tag, batch=batch, C=c, H=h, taps=[k, 5],
                   bytes_bound_ms=bytes_bound_ms(x, w1))
        # both routes checked before any timing draws fresh inputs
        for route in ("band", "simt"):
            got = K10.launch(route, *args)
            row[route + "_err"] = max(rel(a, b) for a, b in zip(got, want))
            if route == "band":
                again = K10.launch(route, *args)
                row["band_same_bits"] = all(
                    torch.equal(a, b) for a, b in zip(got, again))
        for route in ("band", "simt"):
            row[route + "_ms"] = time_ms(lambda: K10.launch(route, *args),
                                         fresh, rounds=rounds)
        row["k1_band_pair_ms"] = time_ms(
            lambda: [K1.launch("band", x, w) for w in (w1, w2)], fresh,
            rounds=rounds)
        row["band_bound_share"] = row["bytes_bound_ms"] / row["band_ms"]
        bad = [r for r in ("band", "simt") if row[r + "_err"] > TOL]
        if bad or not row["band_same_bits"]:
            raise RuntimeError(f"probe_pair_band: {tag} off: {row}")
        rows.append(row)
        del x, xq
        torch.cuda.empty_cache()
    return rows


_MMA = ("mma_bf16(acc[mt][nn], a, b[kt][nn][0], b[kt][nn][1]);",
        "acc[mt][nn][0] += __uint_as_float(a[0] ^ b[kt][nn][0]);")
# phase -> [(text in dwpair.cu, replacement), ...]; each text must be there
EDITS = {
    "mma": [_MMA],
    "fragments": [
        _MMA,
        ("ldsm_x4(r, bs + brow[p] + j * g.P + kt * 16);",
         "r[0] = r[1] = r[2] = r[3] = brow[p] + j + kt;"),
        ("ldsm_x4(a, a_lane + (j * ND + di) * kBandTile);",
         "a[0] = a[1] = a[2] = a[3] = j * ND + di;")],
    "stage": [("      pair_stage<PRE>(g, blk, bsb[(qi + 1) & 1],\n"
               "                      min(g.NB, n_end - n - g.NB), pre);\n",
               "")],
    "loads": [("        pair_load<PRE, PAIR>(g, blk, src, n + 2 * g.NB,",
               "        if (0) pair_load<PRE, PAIR>(g, blk, src, "
               "n + 2 * g.NB,")],
    "stores": [("  if (r >= g.S || cc >= g.S) return;",
                "  if (r >= g.S || cc >= g.S || v0 != 1.2345f) return;")],
    "band_build": [("for (int i = threadIdx.x; i < kBandShort * ND * 32; "
                    "i += kThreads) {", "for (int i = threadIdx.x; i < 0; "
                    "i += kThreads) {")],
    "branch2": [("kernel<<<(unsigned)(2 * g.C * g.bpc), kThreads",
                 "kernel<<<(unsigned)(g.C * g.bpc), kThreads")],
}
_MIN_BLOCKS = "  return MT == 1 ? 4 : 2;"
_PRE = "  return MT == 1 ? 8 : 16;"
_WN = "  return MT <= 2 ? 4 : 2;"
# the settings the kernel's design chose against: name -> edits
ALTERNATIVES = {
    "mt1_like_mt2": [(_MIN_BLOCKS, "  return 2;"), (_PRE, "  return 16;"),
                     (_WN, "  return MT == 1 ? 8 : MT == 2 ? 4 : 2;")],
    "mt4_3_blocks": [(_MIN_BLOCKS, "  return MT == 1 ? 4 : MT == 4 ? 3 : 2;")],
    "mt3_3_blocks": [(_MIN_BLOCKS, "  return MT == 1 ? 4 : MT == 4 ? 2 : 3;")],
    "wn4": [(_WN, "  return 4;")],
    "two_rounds": [("int nb = 8 * pair_wn(mt) / g.NTI;",
                    "int nb = 16 * pair_wn(mt) / g.NTI;"),
                   (_PRE, "  return MT == 1 ? 8 : 32;")],
}


def build_variants(logs=None):
    """{variant: slak_dwpair_band of its library}: "full", "no_<phase>"
    for each phase of EDITS and "alt_<name>" for each of ALTERNATIVES."""
    libs = timing.build_variants("dwpair", {
        "full": [], **{"no_" + k: v for k, v in EDITS.items()},
        **{"alt_" + k: v for k, v in ALTERNATIVES.items()}}, logs)
    fns = {}
    for name, lib in libs.items():
        fn = fns[name] = lib.slak_dwpair_band
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fns


def ptxas_lines(log: str):
    """ptxas's registers and spills of the band kernel's instantiations."""
    out, cur = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            cur = "dwpair_band_kernel" in line
            if cur:
                out.append(line.split("'")[1] if "'" in line else line)
        elif cur and ("registers" in line or "spill" in line):
            out.append(line.strip())
    return out


def ablate(batch: int = 64, rounds: int = 5):
    """One row a stage shape: each variant's ms a launch; then each
    variant's ptxas lines."""
    dev = require_cuda("probe_pair_band")
    logs = {}
    fns = build_variants(logs)
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for tag, c, h, k in SHAPES:
        x, xq, w1, w2 = inputs(g, batch, c, h, k)
        y1, y2q = torch.empty_like(x), torch.empty_like(xq)
        row = dict(shape=tag, batch=batch, C=c, H=h, taps=[k, 5],
                   bytes_bound_ms=bytes_bound_ms(x, w1))
        for name, fn in fns.items():
            def call(fn=fn, name=name):
                err = fn(x.data_ptr(), xq.data_ptr(), w1.data_ptr(),
                         w2.data_ptr(), y1.data_ptr(), y2q.data_ptr(),
                         batch, c, h, h, k, 5,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: cudaError {err}")
            row[name + "_ms"] = time_ms(call, reps=20, rounds=rounds)
        rows.append(row)
        del x, xq, y1, y2q
        torch.cuda.empty_cache()
    rows.append({"ptxas": {k: ptxas_lines(v) for k, v in logs.items()}})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--ablate", action="store_true",
                    help="time the band kernel with phases removed")
    args = ap.parse_args(argv)
    for row in (ablate if args.ablate else run)(args.batch, args.rounds):
        print(json.dumps(row), flush=True)
    print(device_line())


if __name__ == "__main__":
    main()
