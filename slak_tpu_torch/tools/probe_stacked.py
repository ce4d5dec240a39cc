"""A/B: the tap-stacked banded conv (K11) against K1.

    python3 -m slak_tpu_torch.tools.probe_stacked [--batch 128]

Port of ``tools/probe_stacked.py``. At SLaK-T 51x51 w1.3's four stage
shapes ((K, 5) taps, NCHW, bf16 and fp32) it times K11
(``ops/dwconv_stacked.py``, banded products on the tensor cores in bf16)
and K1 (``ops/dwconv.py``, the taps on the CUDA cores) with CUDA events
(median over rounds, fresh inputs each round), checks that the two agree,
and gives each its share of the bound: the larger of the bytes (x read
once, the output written once) over the HBM rate and the conv's real
operations (taps that only read padding skipped) over the dtype's peak
(989 TFLOP/s bf16 on the tensor cores, 67 fp32). ``banded_flops`` counts
what K11's products do (their zero padding included). Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json

import torch

from slak_tpu_torch.ops.dwconv import dwconv
from slak_tpu_torch.ops.dwconv_stacked import dwconv_stacked, stack_group
from slak_tpu_torch.tools.timing import (bound_ms, conv_macs, device_line,
                                         require_cuda, time_ms)

# (tag, C, H, K): SLaK-T 51x51 w1.3 at 224^2
SHAPES = (("s1", 124, 56, 51), ("s2", 249, 28, 49), ("s3", 499, 14, 47),
          ("s4", 998, 7, 13))
S = 5


def _up(n, m):
    return -(-n // m) * m


def banded_flops(n, c, h, w, kw, dtype) -> int:
    """Operations K11's products issue: per plane and chunk a (g*H x H) @
    (H x W + kw - 1) product, padded to the tensor-core tiles in bf16."""
    g = stack_group(h, kw)
    nc = -(-kw // g)
    if dtype == torch.bfloat16:
        m, k, cols = _up(g * h, 16), _up(h, 16), _up(w + kw - 1, 8)
    else:
        m, k, cols = g * h, h, w + kw - 1
    return 2 * n * c * nc * m * k * cols


def run(batch: int = 128, dtypes=(torch.bfloat16, torch.float32),
        rounds: int = 5):
    dev = require_cuda("probe_stacked")
    g = torch.Generator(device=dev).manual_seed(2)
    rows = []
    for dtype in dtypes:
        for tag, c, h, k in SHAPES:
            x = torch.randn(batch, c, h, h, generator=g, device=dev
                            ).to(dtype)
            w = (torch.randn(c, k, S, generator=g, device=dev) * 0.1
                 ).to(dtype).float()

            def fresh():
                x.copy_(torch.randn(x.shape, generator=g, device=dev))
            got, want = dwconv_stacked(x, w), dwconv(x, w)
            d = (got.float() - want.float()).abs().max().item()
            rel = d / max(want.float().abs().max().item(), 1e-30)
            bound, by = bound_ms(2 * x.numel() * x.element_size(),
                                 2 * conv_macs(batch, c, h, h, k, S), dtype)
            stacked = time_ms(lambda: dwconv_stacked(x, w), fresh,
                              rounds=rounds)
            k1 = time_ms(lambda: dwconv(x, w), fresh, rounds=rounds)
            rows.append(dict(
                shape=tag, batch=batch, C=c, H=h, taps=[k, S],
                dtype=str(dtype).split(".")[1], g=stack_group(h, S),
                stacked_ms=stacked, k1_ms=k1, speedup=k1 / stacked,
                bound_ms=bound, bound_by=by,
                stacked_bound_share=bound / stacked,
                k1_bound_share=bound / k1,
                banded_flops=banded_flops(batch, c, h, h, S, dtype),
                max_abs_diff_vs_k1=d, rel_diff_vs_k1=rel))
            del x, got, want
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    args = ap.parse_args(argv)
    for row in run(args.batch):
        print(json.dumps(row), flush=True)
    print(device_line())


if __name__ == "__main__":
    main()
