"""Where the float32 fused MLP's time goes (K2/K3 on the ERF path,
``ops/csrc/mlp.cu`` with ``csrc/tf32_gemm.cuh``).

    python3 -m slak_tpu_torch.tools.probe_mlp_f32 [--size 1024]

At the flagship's four stage shapes (SLaK-T 51x51 w1.3, batch 1, NCHW,
float32; at 1024^2 the ERF's shapes) it times one ``slak_fused_mlp`` call
with CUDA events for each build of the kernel source:

- ``f32``: the source as it is;
- ``f32_no_gelu``: the first product's epilogue stores a + b1, not its
  exact-erf GELU (the GELU's share of the call);
- ``f32_no_products``: no 3xTF32 wgmma in either product (the tensor cores'
  share; the loads, the sums and the epilogues stay);
- ``f32_bn128``: tiles of 128 x 128 instead of 128 x 64 (half the re-reads
  of A's planes, twice the accumulator registers).

It also lists each launch's device time of the ``f32`` build under
torch.profiler, in launch order (the weights' two splits, the LayerNorm
into h's planes, the GELU product, the second product, the residual
epilogue), beside each product's operations bound (three TF32 passes at
495 TFLOP/s); the device's busy time and the span from the first launch's
start to the last one's end, a call, over back-to-back calls; and the host
time a call takes to enqueue its launches. The variants
compute wrong results by design; only the unchanged build is a kernel of
the port. Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from slak_tpu_torch.models.slak import config_for
from slak_tpu_torch.ops.mlp import bind, pack_mlp, token_strides
from slak_tpu_torch.tools import timing
from slak_tpu_torch.tools.timing import device_line, require_cuda, time_ms

MODEL_KW = dict(kernel_size=(51, 49, 47, 13, 5), width_factor=1.3)
PEAK_TF32 = 495e12                      # H100 SXM dense TF32, FLOP/s
# variant -> [(text in mlp.cu or a csrc header, replacement)]; the
# names differ from probe_mlp's, whose libraries share the directory
VARIANTS = {
    "f32": [],
    "f32_no_gelu": [("gelu(sum[4 * j + 2 * h] + bb.x)",
                     "(sum[4 * j + 2 * h] + bb.x)"),
                    ("gelu(sum[4 * j + 2 * h + 1] + bb.y)",
                     "(sum[4 * j + 2 * h + 1] + bb.y)")],
    "f32_no_products": [("        mma_3xtf32(p, a, as, b, bs);\n", "")],
    "f32_bn128": [("constexpr int kBNf = 64;", "constexpr int kBNf = 128;")],
}


def launches(y, res, pk, out, ws, lib):
    """A call of ``slak_fused_mlp`` from ``lib`` on NCHW float32 tensors."""
    _, fn, _ = bind(lib)
    n_outer, p, s_n, s_c, s_p = token_strides(y.shape, 1)
    fp, cp = pk.w1.shape

    def call():
        err = fn(0, y.data_ptr(), res.data_ptr(), out.data_ptr(),
                 pk.w1.data_ptr(), pk.w2.data_ptr(), pk.b1.data_ptr(),
                 pk.vec.data_ptr(), n_outer, p, s_n, s_c, s_p, pk.c, cp, fp,
                 1, ws.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"cudaError {err}")
    return call


def short_name(name: str) -> str:
    """A kernel's name without its argument list and namespaces (template
    arguments kept, parentheses in them too)."""
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            return name[:i]
    return name


def timeline(call, n: int = 10):
    """Over n back-to-back calls: (each launch's device us in launch order
    [(kernel, us)], device busy us a call, span us a call, host enqueue us
    a call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        call()
    host_us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    ks = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                key=lambda e: e.time_range.start)
    per = len(ks) // n
    launches = [(short_name(ks[i].name),
                 sum(ks[i + per * c].time_range.elapsed_us()
                     for c in range(n)) / n) for i in range(per)]
    busy = sum(e.time_range.elapsed_us() for e in ks) / n
    span = (ks[-1].time_range.end - ks[0].time_range.start) / n
    return launches, busy, span, host_us


def run(size: int = 1024, rounds: int = 5):
    """Rows {stage, C, T, {variant}_ms, rel_diff, launch_us, busy_us,
    span_us, host_us, product_ms_3xtf32} at ``size``."""
    dev = require_cuda("probe_mlp_f32")
    libs = timing.build_variants("mlp", VARIANTS)
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for i, C in enumerate(config_for("SLaK_tiny", **MODEL_KW).widened_dims):
        H = (size // 4) >> i
        T, F4 = H * H, 4 * C
        y = torch.randn(1, C, H, H, generator=g, device=dev)
        res = torch.randn_like(y)
        pk = pack_mlp(1 + 0.1 * torch.randn(C, generator=g, device=dev),
                      0.1 * torch.randn(C, generator=g, device=dev),
                      torch.randn(C, F4, generator=g, device=dev) * C ** -0.5,
                      0.1 * torch.randn(F4, generator=g, device=dev),
                      torch.randn(F4, C, generator=g, device=dev)
                      * F4 ** -0.5,
                      0.1 * torch.randn(C, generator=g, device=dev))
        out = torch.empty_like(y)
        fp, cp = pk.w1.shape
        ws = torch.empty(bind(libs["f32"])[0](0, T, cp, fp),
                         dtype=torch.uint8, device=dev)
        # each product's 2 T C 4C operations, three TF32 passes
        product_ms = 3 * 2 * T * C * F4 / PEAK_TF32 * 1e3
        row = dict(stage=i + 1, C=C, T=T, product_ms_3xtf32=product_ms)
        outs = {}
        for name, lib in libs.items():
            row[name + "_ms"] = time_ms(launches(y, res, pk, out, ws, lib),
                                        rounds=rounds)
            outs[name] = out.clone()
        # each build's output against the unchanged build's, max |diff| over
        # max |out| (only the tile-shape variant computes the same function)
        scale = outs["f32"].abs().max().item()
        row["rel_diff"] = {n: (o - outs["f32"]).abs().max().item() / scale
                           for n, o in outs.items() if n != "f32"}
        (row["launch_us"], row["busy_us"], row["span_us"],
         row["host_us"]) = timeline(launches(y, res, pk, out, ws,
                                             libs["f32"]))
        rows.append(row)
        del y, res, out, ws
        torch.cuda.empty_cache()
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=1024)
    args = ap.parse_args()
    for row in run(args.size):
        print(json.dumps(row), flush=True)
    print(device_line())


if __name__ == "__main__":
    main()
