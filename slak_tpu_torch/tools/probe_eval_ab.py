"""Model-level A/B of the eval layouts: ``eval_layout="dual"`` against the
default NCHW route.

    python3 -m slak_tpu_torch.tools.probe_eval_ab [--batch 256]

Port of ``tools/probe_eval_ab.py``: the SLaK-T 51x51 w1.3 eval forward
(bf16, 224^2) with the same weights on the dual stages (18 K10 + 18 K12
launches) and on the default route (``split``: 36 K1 + 18 K2/K3; the
port's ``auto``, ``cmajor`` and ``nhwc`` are this one route); CUDA events
around back-to-back forwards, median over rounds, fresh images each
round, peak device memory beside each. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from slak_tpu_torch.models import apply, create_model
from slak_tpu_torch.tools.probe_pair_ab import MODEL_KW
from slak_tpu_torch.tools.timing import device_line, require_cuda, time_ms

LAYOUTS = {"dual": "dual", "split": "auto"}


def run(batch: int = 256, variants=("dual", "split"), rounds: int = 5,
        model=None):
    dev = require_cuda("probe_eval_ab")
    if model is None:
        model = create_model("SLaK_tiny", dtype=torch.bfloat16, **MODEL_KW)
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(batch, 224, 224, 3, generator=g, device=dev
                    ).to(torch.bfloat16)

    def fresh():
        x.copy_(torch.randn(x.shape, generator=g, device=dev))
    rows = []
    cfg = model.cfg
    try:
        for v in variants:
            model.cfg = dataclasses.replace(cfg, eval_layout=LAYOUTS[v])
            torch.cuda.reset_peak_memory_stats()
            ms = time_ms(lambda: apply(model, x), fresh, reps=3,
                         rounds=rounds)
            rows.append(dict(
                eval_layout=v, batch=batch, ms=ms,
                img_per_s=batch / ms * 1e3,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30))
    finally:
        model.cfg = cfg
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("variants", nargs="*", default=list(LAYOUTS))
    args = ap.parse_args(argv)
    for row in run(args.batch, args.variants):
        print(json.dumps(row), flush=True)
    print(device_line())


if __name__ == "__main__":
    main()
