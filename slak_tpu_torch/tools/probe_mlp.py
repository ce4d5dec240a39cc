"""Where the bf16 fused-MLP kernels' time goes: ablations of ``ops/csrc/mlp.cu``.

    python3 -m slak_tpu_torch.tools.probe_mlp [--batch 64]

Builds the kernel source as it is and with phases removed, each into its
own library under ``slak_tpu_torch/_build/probe/``, and times every variant
with CUDA events at the flagship's stage widths (SLaK-T 51x51 w1.3, NCHW,
bf16): the LayerNorm launch, then the fused kernel at stages 1-2 (C <=
256) or the two TMA + wgmma GEMMs at stages 3-4. A removed phase's time is
roughly the full call's minus the variant's. Phases (each removal keeps
every product's result in use, so that the compiler drops nothing else):

- ``products``: no wgmma (both products of the fused kernel, the GEMMs'
  K loop);
- ``gelu``: the fused kernel's hidden activations without the GELU;
- ``epi_gelu``: the first GEMM's epilogue without the GELU;
- ``prefetch``: the fused kernel's residual read in the epilogue, not
  copied ahead with cp.async;
- ``tma``: no weight or operand copies (the producer arrives on the
  barriers without bytes);
- ``stores``: the epilogues store nothing to device memory;
- ``epi_sync``: the residual epilogue's staging passes without their
  barriers;
- ``ln``: no LayerNorm launch (h is whatever the workspace holds).

It also prints each launch's device time at every stage (torch.profiler),
which splits the wide stages' time between the LayerNorm and the two
GEMMs. The variants compute wrong results by design; only the unchanged
build is a kernel of the port. Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse

import torch

from slak_tpu_torch.ops.mlp import bind, pack_mlp, token_strides
from slak_tpu_torch.tools import timing
from slak_tpu_torch.tools.timing import device_line, require_cuda, time_ms

# phase -> [(text in mlp.cu, replacement), ...]; each text must be present
EDITS = {
    "products": [
        ("wgmma::ss<kFC>(a1, da + 2 * kk, db + 2 * kk, kb | kk);", ";"),
        ("for (int kk = 0; kk < 4; ++kk) wgmma::rs<NP>(acc, g[kk], "
         "dw2 + 2 * kk, 1);", ""),
        ("wgmma::ss<BN>(acc, da + 2 * kk, db + 2 * kk, kb | kk);", ";")],
    "gelu": [("gelu(a1[", "(a1[")],
    "epi_gelu": [("gelu(v[0] + bb.x), gelu(v[1] + bb.y)",
                  "v[0] + bb.x, v[1] + bb.y")],
    "tma": [
        ("mbar_expect_tx(&full1[s1], KB * kBox);",
         "mbar_arrive(&full1[s1]);"),
        ("          for (int kb = 0; kb < KB; ++kb)\n"
         "            tma_load(w1 + kb * kBox, &map_w1, &full1[s1], "
         "kb * kBK,\n                     ch * kFC);\n", ""),
        ("mbar_expect_tx(&full2[s2], L::kW2Bytes);",
         "mbar_arrive(&full2[s2]);"),
        ("          tma_load(sm + L::kRing2 + s2 * L::kW2Bytes, &map_w2, "
         "&full2[s2],\n                   ch * kFC, 0);\n", ""),
        ("mbar_expect_tx(&full[s], L::kStageBytes);",
         "mbar_arrive(&full[s]);"),
        ("          tma_load(st, &map_a, &full[s], kb * kBK, m0);\n"
         "          tma_load(st + L::kABytes, &map_b, &full[s], kb * kBK, "
         "n0);\n", "")],
    "stores": [("    out[o + c * sC] = x;", "    if (o == -7) out[o + c * sC] = x;"),
               ("      tma_store(map_g, buf, n0 + p * 32, m0);\n", "")],
    "epi_sync": [("    wg_sync(wg);\n#pragma unroll\n    for (int j = 0; j < "
                  "kEpiCols / 8; ++j)", "#pragma unroll\n    for (int j = 0; "
                  "j < kEpiCols / 8; ++j)"),
                 ("    wg_sync(wg);\n#pragma unroll\n    for (int k = 0; "
                  "k < kEpiPer; ++k) {", "#pragma unroll\n    for (int k = 0; "
                  "k < kEpiPer; ++k) {")],
    "prefetch": [("if (a.add_residual && a.sP == 1",
                  "if (false && a.add_residual && a.sP == 1")],
    "ln": [("ln_bf16_kernel<A><<<", "if (0) ln_bf16_kernel<A><<<")],
}
# (variant, phases removed)
VARIANTS = [
    ("full", []),
    ("no_products", ["products"]),
    ("no_gelu", ["gelu"]),
    ("no_epi_gelu", ["epi_gelu"]),
    ("no_tma", ["tma"]),
    ("no_stores", ["stores"]),
    ("no_epi_sync", ["epi_sync"]),
    ("no_prefetch", ["prefetch"]),
    ("no_ln", ["ln"]),
]
STAGES = ((124, 56), (249, 28), (499, 14), (998, 7))   # (C, H)


def build_variants():
    """{variant: its library} for VARIANTS."""
    return timing.build_variants("mlp", {
        name: [e for r in removed for e in EDITS[r]]
        for name, removed in VARIANTS})


def launches(y, res, pk, out, ws, lib):
    """A call of ``slak_fused_mlp`` from ``lib`` on NCHW bf16 tensors."""
    _, fn, _ = bind(lib)
    n_outer, p, s_n, s_c, s_p = token_strides(y.shape, 1)
    fp, cp = pk.w1.shape

    def call():
        err = fn(1, y.data_ptr(), res.data_ptr(), out.data_ptr(),
                 pk.w1.data_ptr(), pk.w2.data_ptr(), pk.b1.data_ptr(),
                 pk.vec.data_ptr(), n_outer, p, s_n, s_c, s_p, pk.c, cp, fp,
                 1, ws.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"cudaError {err}")
    return call


def kernel_times(call, n=10):
    """{kernel name: device us a call} over n calls (torch.profiler); the
    name keeps its template arguments, so that two instantiations of one
    kernel stay apart."""
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", 0) or getattr(
            e, "cuda_time_total", 0)
        if t > 0:
            name = e.key.replace("(anonymous namespace)::", "").replace(
                "void ", "")
            depth, cut = 0, len(name)
            for i, ch in enumerate(name):   # the parameter list's "("
                depth += (ch == "<") - (ch == ">")
                if ch == "(" and depth == 0:
                    cut = i
                    break
            out[name[:cut]] = out.get(name[:cut], 0.0) + t / n
    return out


def run(batch: int, rounds: int = 5):
    """Rows {stage, C, variant ms..., kernel us...} at ``batch``."""
    dev = require_cuda("probe_mlp")
    libs = build_variants()
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for stage, (C, H) in enumerate(STAGES, 1):
        y = torch.randn(batch, C, H, H, generator=g, device=dev
                        ).bfloat16()
        res = torch.randn_like(y)
        pk = pack_mlp(torch.ones(C, device=dev), torch.zeros(C, device=dev),
                      torch.randn(C, 4 * C, generator=g, device=dev) * 0.05,
                      torch.zeros(4 * C, device=dev),
                      torch.randn(4 * C, C, generator=g, device=dev) * 0.05,
                      torch.zeros(C, device=dev), dtype=torch.bfloat16)
        out = torch.empty_like(y)
        ws_fn = bind(libs["full"])[0]
        fp, cp = pk.w1.shape
        ws = torch.empty(max(1, ws_fn(1, y.numel() // C, cp, fp)),
                         dtype=torch.uint8, device=dev)
        row = dict(stage=stage, C=C, batch=batch)
        for name, lib in libs.items():
            row[name + "_ms"] = time_ms(launches(y, res, pk, out, ws, lib),
                                        reps=20, warmup=3, rounds=rounds)
        row["kernel_us"] = kernel_times(launches(y, res, pk, out, ws,
                                                 libs["full"]))
        rows.append(row)
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    args = ap.parse_args()
    import json
    for row in run(args.batch):
        print(json.dumps(row), flush=True)
    print(device_line())


if __name__ == "__main__":
    main()
