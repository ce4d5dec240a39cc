"""K5/K7 in bf16 on the band kernel against the tiled kernel, route by route.

    python3 -m slak_tpu_torch.tools.probe_wgrad [--batch 128] [--rounds 5]

At SLaK-T 51x51 w1.3's four stage shapes (224^2, bf16, NCHW), both
orientations, it launches each route of ``ops/dwconv_wgrad.py`` (the band
kernel, ``wgrad_band_kernel``, the default route at all four; the tiled
kernel, ``wgrad_tiled_kernel``, which served them before), checks each
against the plain version (within 1e-4 of its scale, the same bits on a
second launch, the taps that only read padding exactly 0), and times
each launch with CUDA events (median over rounds, fresh inputs each
round) beside its bytes bound. Needs one CUDA card.

    python3 -m slak_tpu_torch.tools.probe_wgrad --ablate [--batch 128]

builds ``ops/csrc/dwconv_wgrad.cu`` as it is and with phases of the band
kernel removed, each into its own library under
``slak_tpu_torch/_build/probe/``, and times each variant's
``slak_dwconv_wgrad_band`` at the same shapes (a removed phase's time is
roughly the full launch's minus the variant's). Removed (``no_``):

- ``products``: no mma.sync (the fragments still loaded and used);
- ``fragments``: neither mma.sync nor the ldmatrix loads that feed it;
- ``stage``: the chunks after the first are not written to the staged
  operands (nor, since then unused, loaded);
- ``loads``: the chunks after the first are not read from device memory;
- ``fold``: each tap's diagonal is not summed (one term of it is read);
- ``stores``: no partial is stored to device memory.

Alternatives (``alt_``): ``pair_loads`` (4-byte value pairs a lane where
W is a multiple of 8 too, not 16-byte rows), ``mt1_kgroups_8`` (8
k-groups of 10 unit slots at MT = 1, 3 blocks an SM, not 4 of 5 and 4),
``mt2_kgroups_2`` (2 k-groups of 5 unit slots at MT = 2, 2 blocks an SM,
not 1 of 3 and 3), ``mt4_pre_8`` (8 staging blocks a lane at MT = 4, not
16: chunks of one image at stage 1), ``block_cost_8`` (the blocks a
channel chosen as if a block's set-up and fold cost 8 chunks, not 2:
fewer blocks). The removal variants compute wrong results by design;
only the unchanged build is a kernel of the port. Needs nvcc besides the
card.
"""

from __future__ import annotations

import argparse
import ctypes
import json

import torch

from slak_tpu_torch.ops import dwconv_wgrad as KW
from slak_tpu_torch.tools import timing
from slak_tpu_torch.tools.timing import (PEAK_BYTES_PER_S, device_line,
                                         require_cuda, time_ms)

# (tag, C, H, K): SLaK-T 51x51 w1.3 at 224^2
SHAPES = (("s1", 124, 56, 51), ("s2", 249, 28, 49), ("s3", 499, 14, 47),
          ("s4", 998, 7, 13))
TOL = 1e-4             # fp32 sums over N*H*W products in another order


def dead_taps(dw: torch.Tensor, H: int, W: int) -> float:
    """max |dw| over the taps that only ever read padding."""
    kh, kw = dw.shape[1:]
    ti = torch.arange(kh, device=dw.device)[:, None]
    tj = torch.arange(kw, device=dw.device)[None, :]
    dead = ((ti - kh // 2).abs() >= H) | ((tj - kw // 2).abs() >= W)
    return dw[:, dead].abs().max().item() if bool(dead.any()) else 0.0


def check(route, x, dy, kh, kw):
    """One route's errors against the plain version; raises when one is
    off."""
    got = KW.launch(route, x, dy, kh, kw)
    again = KW.launch(route, x, dy, kh, kw)
    want = KW.dwconv_wgrad_plain(x, dy, kh, kw)
    d = (got - want).abs().max().item()
    errs = dict(max_abs_err=d, rel_err=d / want.abs().max().item(),
                same_bits=bool(torch.equal(got, again)),
                dead_taps=dead_taps(got, *x.shape[2:]))
    if (errs["rel_err"] > TOL or not errs["same_bits"]
            or errs["dead_taps"] != 0.0):
        raise RuntimeError(f"probe_wgrad {route} {tuple(x.shape)} "
                           f"{(kh, kw)}: {errs}")
    return errs


def bytes_bound_ms(x, kh, kw) -> float:
    """x and dy read once, the fp32 taps written once."""
    return (2 * x.numel() * x.element_size() + 4 * x.shape[1] * kh * kw
            ) / PEAK_BYTES_PER_S * 1e3


def run(batch: int = 128, rounds: int = 5):
    """One row a (shape, orientation): each route's errors and ms."""
    dev = require_cuda("probe_wgrad")
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for tag, c, h, k in SHAPES:
        x, dy = (torch.randn(batch, c, h, h, generator=g, device=dev
                             ).to(torch.bfloat16) for _ in range(2))

        def fresh():
            x.copy_(torch.randn(x.shape, generator=g, device=dev))
        for taps in ((k, 5), (5, k)):
            row = dict(shape=tag, batch=batch, C=c, H=h, taps=list(taps),
                       bytes_bound_ms=bytes_bound_ms(x, *taps))
            for name in ("band", "tiled"):
                row[name + "_err"] = check(name, x, dy, *taps)
                row[name + "_ms"] = time_ms(
                    lambda: KW.launch(name, x, dy, *taps), fresh,
                    rounds=rounds)
            rows.append(row)
        del x, dy
        torch.cuda.empty_cache()
    return rows


# phase -> [(text in dwconv_wgrad.cu, replacement), ...]; each text must be
# there
_MMA = ("mma_bf16(acc[u][m], a[m], b[u][0], b[u][1]);",
        "acc[u][m][0] += __uint_as_float(a[m][0] ^ b[u][0] ^ b[u][1]);")
EDITS = {
    "products": [_MMA],
    "fragments": [
        _MMA,
        ("for (int m = 0; m < MW; ++m) ldsm_x4_t(a[m], ds + r0 + 16 * m);",
         "for (int m = 0; m < MW; ++m) a[m][0] = a[m][1] = a[m][2] = "
         "a[m][3] = r0 + m;"),
        ("        ldsm_x2_t(b[u], xs + r0 + boff[u]);",
         "        b[u][0] = b[u][1] = r0 + boff[u];")],
    "stage": [("      stage(bsb[(qi + 1) & 1]);\n", "")],
    "loads": [("      if (qi + 2 < nq) load(n + 2 * g.NB,",
               "      if (0) load(n + 2 * g.NB,")],
    "fold": [("    for (int a = a0; a < a1; ++a) s += d[a * (g.GP + 1)];",
              "    if (a0 < a1) s += d[a0 * (g.GP + 1)];")],
    "stores": [("    dst[g.long_h ? i * kShort + j : j * g.K + i] = s;",
                "    if (s == 1.2345f) dst[g.long_h ? i * kShort + j : "
                "j * g.K + i] = s;")],
}
# the settings the kernel's design chose against: name -> edits
_KGROUPS = "  return MT == 1 ? 4 : 1;"
_SLOTS = "  return MT == 2 ? 3 : MT == 3 ? 4 : 5;"
_MIN_BLOCKS = "  return MT == 1 ? 4 : MT == 2 ? 3 : MT == 3 ? 2 : 1;"
ALTERNATIVES = {
    "pair_loads": [("  *LD = W % 8 == 0 && ptrs % 16 == 0 ? 8 :",
                    "  *LD = false ? 8 :")],
    "mt1_kgroups_8": [(_KGROUPS, "  return MT == 1 ? 8 : 1;"),
                      (_SLOTS, "  return MT == 1 ? 10 : MT == 2 ? 3 : "
                       "MT == 3 ? 4 : 5;"),
                      (_MIN_BLOCKS, "  return MT == 1 ? 3 : MT == 2 ? 3 : "
                       "MT == 3 ? 2 : 1;")],
    "mt2_kgroups_2": [(_KGROUPS, "  return MT == 1 ? 4 : MT == 2 ? 2 : 1;"),
                      (_SLOTS, "  return MT == 3 ? 4 : 5;"),
                      (_MIN_BLOCKS,
                       "  return MT == 1 ? 4 : MT <= 3 ? 2 : 1;")],
    "mt4_pre_8": [("  return MT == 1 ? 8 : 16;",
                   "  return MT == 1 || MT == 4 ? 8 : 16;")],
    "block_cost_8": [("constexpr int kBlockCost = 2;",
                      "constexpr int kBlockCost = 8;")],
}


def build_variants():
    """{variant: slak_dwconv_wgrad_band of its library, with the scratch
    entry}: "full", "no_<phase>" for each phase of EDITS and "alt_<name>"
    for each of ALTERNATIVES."""
    libs = timing.build_variants("dwconv_wgrad", {
        "full": [], **{"no_" + k: v for k, v in EDITS.items()},
        **{"alt_" + k: v for k, v in ALTERNATIVES.items()}})
    fns = {}
    for name, lib in libs.items():
        scratch = lib.slak_dwconv_wgrad_band_scratch
        scratch.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 5
        scratch.restype = ctypes.c_longlong
        fn = lib.slak_dwconv_wgrad_band
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = (scratch, fn)
    return fns


def ablate(batch: int = 128, rounds: int = 5):
    """One row a (shape, orientation): each variant's ms a launch."""
    dev = require_cuda("probe_wgrad")
    fns = build_variants()
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for tag, c, h, k in SHAPES:
        x, dy = (torch.randn(batch, c, h, h, generator=g, device=dev
                             ).to(torch.bfloat16) for _ in range(2))
        for taps in ((k, 5), (5, k)):
            row = dict(shape=tag, batch=batch, C=c, H=h, taps=list(taps),
                       bytes_bound_ms=bytes_bound_ms(x, *taps))
            dw = torch.empty(c, *taps, device=dev)
            for name, (scratch, fn) in fns.items():
                part = torch.empty(scratch(batch, c, h, h, *taps),
                                   device=dev)

                def call(fn=fn, part=part):
                    err = fn(x.data_ptr(), dy.data_ptr(), part.data_ptr(),
                             dw.data_ptr(), batch, c, h, h, *taps,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{name}: cudaError {err}")
                row[name + "_ms"] = time_ms(call, reps=20, rounds=rounds)
            rows.append(row)
        del x, dy
        torch.cuda.empty_cache()
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--ablate", action="store_true",
                    help="time the band kernel with phases removed")
    args = ap.parse_args(argv)
    for row in (ablate if args.ablate else run)(args.batch, args.rounds):
        print(json.dumps(row), flush=True)
    print(device_line())


if __name__ == "__main__":
    main()
