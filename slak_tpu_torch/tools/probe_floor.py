"""The timing floor under K1: what a pass over the activation costs.

    python3 -m slak_tpu_torch.tools.probe_floor [--batch 128]

Port of ``tools/probe_floor.py``. The TPU probe asked whether its chain
harness or the kernel set the time; CUDA events time the kernels alone, so
here it decomposes K1's time at stage 1-2 shapes (bf16, (K, 5) taps) into
floors, each with CUDA events (median over rounds, fresh inputs): a read
and write of the activation by PyTorch (``clone``), one elementwise pass
(``tanh``), the copy-only probe twin (K13, ``ntaps = 0``) and the full
probe conv (all 5 tap columns), beside the bytes bound of one read and one
write. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json

import torch

from slak_tpu_torch.tools.probe_overhead import S, SHAPES, run_variant
from slak_tpu_torch.tools.timing import (bound_ms, device_line, require_cuda,
                                         time_ms)


def run(batch: int = 128, dtype=torch.bfloat16, rounds: int = 5):
    dev = require_cuda("probe_floor")
    g = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for tag, c, h, k in SHAPES[:2]:
        x = torch.randn(batch, c, h, h, generator=g, device=dev).to(dtype)
        w = (torch.randn(c, k, S, generator=g, device=dev) * 0.1
             ).to(dtype).float()

        def fresh():
            x.copy_(torch.randn(x.shape, generator=g, device=dev))
        rows.append(dict(
            shape=tag, batch=batch, C=c, H=h, dtype=str(dtype).split(".")[1],
            bytes_bound_ms=bound_ms(2 * x.numel() * x.element_size(), 0,
                                    dtype)[0],
            clone_ms=time_ms(lambda: x.clone(), fresh, rounds=rounds),
            tanh_ms=time_ms(lambda: torch.tanh(x), fresh, rounds=rounds),
            probe_copy_ms=time_ms(lambda: run_variant(x, w, 0), fresh,
                                  rounds=rounds),
            probe_full_ms=time_ms(lambda: run_variant(x, w, S), fresh,
                                  rounds=rounds)))
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
