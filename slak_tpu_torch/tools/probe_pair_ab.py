"""Model-level A/B of the eval pair dispatch (``ops/depthwise.PAIR_IMPL``).

    python3 -m slak_tpu_torch.tools.probe_pair_ab [--batch 256] [impl ...]

Port of ``tools/probe_pair_ab.py``: the SLaK-T 51x51 w1.3 eval forward
(bf16, 224^2, the NCHW route) with the pair as two K1 launches
(``split``) or one K10 launch in each mode (``fused-kernel``,
``fused-input``, ``fused-dualout``, ``fused-dualboth``); CUDA events
around back-to-back forwards, median over rounds, fresh images each
round. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json

import torch

from slak_tpu_torch.models import apply, create_model
from slak_tpu_torch.ops import depthwise
from slak_tpu_torch.tools.timing import device_line, require_cuda, time_ms

MODEL_KW = dict(kernel_size=(51, 49, 47, 13, 5), width_factor=1.3)


def run(batch: int = 256, impls=depthwise.PAIR_IMPLS, rounds: int = 5,
        model=None):
    dev = require_cuda("probe_pair_ab")
    if model is None:
        model = create_model("SLaK_tiny", dtype=torch.bfloat16, **MODEL_KW)
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(batch, 224, 224, 3, generator=g, device=dev
                    ).to(torch.bfloat16)

    def fresh():
        x.copy_(torch.randn(x.shape, generator=g, device=dev))
    rows = []
    saved = depthwise.PAIR_IMPL
    try:
        for impl in impls:
            depthwise.PAIR_IMPL = impl
            ms = time_ms(lambda: apply(model, x), fresh, reps=3,
                         rounds=rounds)
            rows.append(dict(pair_impl=impl, batch=batch, ms=ms,
                             img_per_s=batch / ms * 1e3))
    finally:
        depthwise.PAIR_IMPL = saved
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("impls", nargs="*", default=list(depthwise.PAIR_IMPLS))
    args = ap.parse_args(argv)
    for row in run(args.batch, args.impls):
        print(json.dumps(row), flush=True)
    print(device_line())


if __name__ == "__main__":
    main()
