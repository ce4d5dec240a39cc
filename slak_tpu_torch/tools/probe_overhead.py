"""Where K1's time goes: the tap-limited probe K13 against K1.

    python3 -m slak_tpu_torch.tools.probe_overhead [--batch 128]

Port of ``tools/probe_overhead.py``. At SLaK-T 51x51 w1.3's stage 1-3
shapes (bf16, (K, 5) taps, NCHW) it decomposes the band kernel's time
(``dwconv_band_kernel``, which every bf16 (K, 5) K1 launch at these shapes
takes) with K13 on the band route, timed with CUDA events (median over
rounds, fresh inputs each round): the copy-only twin (``ntaps = 0``: the
band kernel's chunks staged and stored, no band tile built, no product),
one tap column, all 5 (K1's own band launch) and K1 through ``dwconv``.
The TPU probe's channel-block sweep has no counterpart: the port's kernel
picks its own tile. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json

import torch

from slak_tpu_torch.ops.dwconv import dwconv, dwconv_probe
from slak_tpu_torch.tools.timing import (device_line, require_cuda,
                                         time_ms)

# (tag, C, H, K): SLaK-T 51x51 w1.3 stages 1-3 at 224^2
SHAPES = (("s1", 124, 56, 51), ("s2", 249, 28, 49), ("s3", 499, 14, 47))
S = 5


def run_variant(x: torch.Tensor, w: torch.Tensor, ntaps: int
                ) -> torch.Tensor:
    """K1 on (K, 5) taps with the first ``ntaps`` tap columns (0: copy), on
    the band kernel in bf16."""
    return dwconv_probe(x, w, ntaps)


def run(batch: int = 128, dtype=torch.bfloat16, rounds: int = 5):
    """One row a shape: ms of each variant."""
    dev = require_cuda("probe_overhead")
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for tag, c, h, k in SHAPES:
        x = torch.randn(batch, c, h, h, generator=g, device=dev).to(dtype)
        w = (torch.randn(c, k, S, generator=g, device=dev) * 0.1
             ).to(dtype).float()

        def fresh():
            x.copy_(torch.randn(x.shape, generator=g, device=dev))
        row = dict(shape=tag, batch=batch, C=c, H=h, taps=[k, S],
                   dtype=str(dtype).split(".")[1])
        for name, nt in (("copy_only", 0), ("one_tap", 1), ("all_taps", S)):
            row[name + "_ms"] = time_ms(lambda: run_variant(x, w, nt), fresh,
                                        rounds=rounds)
        row["k1_ms"] = time_ms(lambda: dwconv(x, w), fresh, rounds=rounds)
        rows.append(row)
        del x
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
