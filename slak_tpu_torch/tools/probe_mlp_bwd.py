"""Where the fused MLP backward's time goes: device time by kernel of one
K8/K9 launch sequence (``ops/csrc/mlp_bwd.cu``).

    python3 -m slak_tpu_torch.tools.probe_mlp_bwd [--size 1024] [--dtype float32]

At the flagship's four stage shapes (SLaK-T 51x51 w1.3, batch 1, NCHW; at
1024^2 in float32, the ERF's shapes) it times ``fused_mlp_bwd`` (C <= 256)
or ``fused_mlp_bwd_wide`` with CUDA events in the full mode and in dy-only
mode (the ERF's), and lists each launch's device time under torch.profiler:
the prep, the weights' TF32 split (float32), the products, the LayerNorm
backward, the token reductions and the sums. Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import json

import torch

from slak_tpu_torch.models.slak import config_for
from slak_tpu_torch.ops import mlp as K2
from slak_tpu_torch.tools.probe_mlp import kernel_times
from slak_tpu_torch.tools.timing import device_line, require_cuda, time_ms

MODEL_KW = dict(kernel_size=(51, 49, 47, 13, 5), width_factor=1.3)


def run(size: int = 1024, dtype: torch.dtype = torch.float32,
        rounds: int = 5):
    """Rows {stage, C, T, mode, ms, kernel_us: {kernel: device us}}."""
    dev = require_cuda("probe_mlp_bwd")
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for i, C in enumerate(config_for("SLaK_tiny", **MODEL_KW).widened_dims):
        H = (size // 4) >> i
        y = torch.randn(1, C, H, H, generator=g, device=dev).to(dtype)
        dout = (0.1 * torch.randn(1, C, H, H, generator=g, device=dev)
                ).to(dtype)

        def vec(n, shift=0.0):
            return 0.1 * torch.randn(n, generator=g, device=dev) + shift
        pk = K2.pack_mlp(vec(C, 1.0), vec(C),
                         torch.randn(C, 4 * C, generator=g, device=dev)
                         * C ** -0.5, vec(4 * C),
                         torch.randn(4 * C, C, generator=g, device=dev)
                         * (4 * C) ** -0.5, vec(C), vec(C, 0.3), vec(C),
                         dtype)
        bwd = K2.fused_mlp_bwd if C <= K2.BWD_C_MAX else K2.fused_mlp_bwd_wide
        for mode in ("full", "dy_only"):
            only = mode == "dy_only"

            def call():
                return bwd(y, dout, pk, 1, dy_only=only)
            rows.append(dict(stage=i + 1, C=C, T=H * H, mode=mode,
                             ms=time_ms(call, rounds=rounds),
                             kernel_us=kernel_times(call)))
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    args = ap.parse_args()
    for row in run(args.size, getattr(torch, args.dtype)):
        print(json.dumps(row), flush=True)
    print(device_line())


if __name__ == "__main__":
    main()
