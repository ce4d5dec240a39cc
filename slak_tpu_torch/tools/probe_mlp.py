"""Where the fused-MLP kernel's time goes: ablations of ``ops/csrc/mlp.cu``.

    python3 -m slak_tpu_torch.tools.probe_mlp [--batch 64]

Builds the kernel source as it is and with phases removed (GELU, product 1,
product 2, the weight copies, the activation loads and stores, the
LayerNorm, the chunk loop), alone and in groups, each into its own library
under ``slak_tpu_torch/_build/probe/``, and times every variant with CUDA
events at the flagship's stage widths (SLaK-T 51x51 w1.3, NCHW, bf16). A
removed phase's time is roughly the full kernel's minus the variant's. The
product, GELU and weight-copy ablations edit the WMMA kernel, which runs
at C > 512 (stage 4); the loads, stores, LayerNorm and chunk loop are
shared or mirrored by all. The variants compute wrong results by design;
only the unchanged build is a kernel of the port. Needs one CUDA card and
nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import subprocess

import torch

from slak_tpu_torch.ops import _build
from slak_tpu_torch.ops.mlp import pack_mlp, token_strides

# phase -> [(text in mlp.cu, replacement), ...]
EDITS = {
    "gelu": [("gs[t * LDF + f] = from_f<bf16>(gelu(v));",
              "gs[t * LDF + f] = from_f<bf16>(v);")],
    "gemm1": [("job < tiles_1 * KS; job += kWarps", "job < 0; ++job")],
    "gemm2": [("for (int k = 0; k < FC; k += 16) {\n"
               "      wmma::fragment<wmma::matrix_a",
               "for (int k = 0; k < 0; k += 16) {\n"
               "      wmma::fragment<wmma::matrix_a")],
    "wcopy": [("  load_weights_w1<FC>(a, 0, w1s, LDA);", ""),
              ("  load_weights_w2<FC>(a, 0, w2s, LDF);", ""),
              ("if (f0 + FC < Fp) load_weights_w1", "if (0) load_weights_w1"),
              ("if (f0 + FC < Fp) load_weights_w2", "if (0) load_weights_w2")],
    "io": [("off >= 0 ? to_f<T>(y[off]) : 0.f;", "(float)(off & 7);"),
           ("off >= 0 && a.add_residual ? to_f<T>(res[off]) : 0.f;",
            "(float)(off & 7);"),
           ("        if (off >= 0)\n          out[off]",
            "        if (off == -7)\n          out[off]")],
    "ln": [("for (int t0 = warp * R; t0 < a.BT; t0 += kWarps * R) {",
            "for (int t0 = warp * R; t0 < 0; t0 += kWarps * R) {")],
    "chunks": [("for (int f0 = 0; f0 < Fp; f0 += FC) {",
                "for (int f0 = 0; f0 < 0; f0 += FC) {")],
}
# (variant, phases removed)
VARIANTS = [
    ("full", []),
    ("no_gelu", ["gelu"]),
    ("no_gemm1", ["gemm1"]),
    ("no_gemm2", ["gemm2"]),
    ("no_wcopy", ["wcopy"]),
    ("no_io", ["io"]),
    ("skeleton", ["gelu", "gemm1", "gemm2", "wcopy"]),
    ("bare", ["gelu", "gemm1", "gemm2", "wcopy", "io"]),
    ("bare_no_ln", ["gelu", "gemm1", "gemm2", "wcopy", "io", "ln"]),
    ("bare_no_chunks", ["gelu", "gemm1", "gemm2", "wcopy", "io", "chunks"]),
    ("only_io", ["gelu", "gemm1", "gemm2", "wcopy", "ln", "chunks"]),
]


def build_variants():
    src = open(_build.source_path("mlp")).read()
    out_dir = os.path.join(_build.BUILD_DIR, "probe")
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for name, removed in VARIANTS:
        text = src
        for old, new in (e for r in removed for e in EDITS[r]):
            if old not in text:
                raise RuntimeError(f"{name}: pattern not found: {old!r}")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"mlp_{name}.cu")
        so = os.path.join(out_dir, f"libmlp_{name}.so")
        with open(cu, "w") as f:
            f.write(text)
        procs.append((name, so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, so, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        libs[name] = ctypes.CDLL(so)
    return libs


def time_ms(fn, reps=20, rounds=5):
    """Device ms a call: events around `reps` back-to-back calls, median of
    `rounds`."""
    for _ in range(3):
        fn()
    ts = []
    for _ in range(rounds):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) / reps)
    return statistics.median(ts)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    args = ap.parse_args()
    libs = build_variants()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for stage, (C, H) in enumerate(((124, 56), (249, 28), (499, 14),
                                    (998, 7)), 1):
        y = torch.randn(args.batch, C, H, H, generator=g, device=dev
                        ).bfloat16()
        res = torch.randn_like(y)
        pk = pack_mlp(torch.ones(C, device=dev), torch.zeros(C, device=dev),
                      torch.randn(C, 4 * C, generator=g, device=dev) * 0.05,
                      torch.zeros(4 * C, device=dev),
                      torch.randn(4 * C, C, generator=g, device=dev) * 0.05,
                      torch.zeros(C, device=dev), dtype=torch.bfloat16)
        out = torch.empty_like(y)
        n_outer, p, s_n, s_c, s_p = token_strides(y.shape, 1)
        fp, cp = pk.w1.shape
        row = [f"stage {stage} C={C}"]
        for name, lib in libs.items():
            fn = lib.slak_fused_mlp
            fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                           + [ctypes.c_longlong] * 5 + [ctypes.c_int] * 4
                           + [ctypes.c_void_p])

            def call():
                err = fn(1, y.data_ptr(), res.data_ptr(), out.data_ptr(),
                         pk.w1.data_ptr(), pk.w2.data_ptr(),
                         pk.b1.data_ptr(), pk.vec.data_ptr(), n_outer, p,
                         s_n, s_c, s_p, C, cp, fp, 1,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: cudaError {err}")
            row.append(f"{name} {time_ms(call):.3f}")
        print(" | ".join(row) + "  (ms)", flush=True)


if __name__ == "__main__":
    main()
