"""Where the fused MLP backward's time goes: device time by kernel of one
K8/K9 launch sequence (``ops/csrc/mlp_bwd.cu``).

    python3 -m slak_tpu_torch.tools.probe_mlp_bwd [--size 1024] [--batch 1]
        [--dtype float32] [--base DIR] [--ablate]

At the flagship's four stage shapes (SLaK-T 51x51 w1.3, NCHW; at 1024^2,
batch 1, in float32 the ERF's shapes; at 800^2, batch 2, the det path's)
it times ``fused_mlp_bwd`` (C <= 256) or ``fused_mlp_bwd_wide`` with CUDA
events in the full mode and in dy-only mode (the ERF's), and lists each
launch's device time under torch.profiler: the prep, the weights' TF32
split (float32), the products, the LayerNorm backward, the token
reductions and the sums. A full-mode row also gives step 5 alone (the
token-reduction products' kernels) beside its bound: 6 T C 4C operations
on FFMA at 67 TFLOP/s and as three TF32 passes at 495. ``--base DIR``
first runs the same rows on another checkout's ``mlp_bwd.cu``, bound by
that checkout's own ``ops/mlp.py`` (``chip_smoke.base_module``; run from
the repository's root). ``--ablate`` (float32) times step 5's kernel,
``wgrad_tf32_kernel``, in copies of ``mlp_bwd.cu`` built without parts of
its work (their outputs are wrong; only the time is read): ``one_plane_b``
loads B's big plane alone (a third less traffic a stage), ``no_loads``
issues no TMA load (the consumers' work alone), ``two_passes`` drops the
small A x big B product, ``no_prefetch`` waits for a block's products
before it reads the next block's A fragments (the same bits). Needs one
CUDA card and nvcc.
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
# the token-reduction products' kernels: the 3xTF32 design, the FFMA one
STEP5_KERNELS = ("wgrad_tf32_kernel", "mlp_bwd_gemm_f32_kernel",
                 "bwd_gemm_kernel<128, false, true, true>")
PEAK_FFMA, PEAK_TF32 = 67e12, 495e12


def step5(kernel_us, T, C, F4):
    """Step 5's device us (the token-reduction products' kernels, their
    split sums left out) beside its operations bounds in us."""
    ops = 6 * T * C * F4
    return dict(step5_us=sum(v for k, v in kernel_us.items()
                             if k.startswith(STEP5_KERNELS)),
                step5_ffma_bound_us=ops / PEAK_FFMA * 1e6,
                step5_3xtf32_bound_us=3 * ops / PEAK_TF32 * 1e6)


def run(size: int = 1024, dtype: torch.dtype = torch.float32,
        rounds: int = 5, batch: int = 1, mod=K2, design: str = "change"):
    """Rows {design, stage, C, T, mode, ms, kernel_us[, step5...]}; ``mod``
    holds the wrappers to time (another checkout's for ``--base``)."""
    dev = require_cuda("probe_mlp_bwd")
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for i, C in enumerate(config_for("SLaK_tiny", **MODEL_KW).widened_dims):
        H = (size // 4) >> i
        y = torch.randn(batch, C, H, H, generator=g, device=dev).to(dtype)
        dout = (0.1 * torch.randn(batch, C, H, H, generator=g, device=dev)
                ).to(dtype)

        def vec(n, shift=0.0):
            return 0.1 * torch.randn(n, generator=g, device=dev) + shift
        pk = K2.pack_mlp(vec(C, 1.0), vec(C),
                         torch.randn(C, 4 * C, generator=g, device=dev)
                         * C ** -0.5, vec(4 * C),
                         torch.randn(4 * C, C, generator=g, device=dev)
                         * (4 * C) ** -0.5, vec(C), vec(C, 0.3), vec(C),
                         dtype)
        bwd = mod.fused_mlp_bwd if C <= K2.BWD_C_MAX else \
            mod.fused_mlp_bwd_wide
        T = batch * H * H
        for mode in ("full", "dy_only"):
            only = mode == "dy_only"

            def call():
                return bwd(y, dout, pk, 1, dy_only=only)
            us = kernel_times(call)
            rows.append(dict(design=design, stage=i + 1, C=C, T=T, mode=mode,
                             ms=time_ms(call, rounds=rounds), kernel_us=us,
                             **(step5(us, T, C, 4 * C) if not only else {})))
    return rows


# (text, replacement) edits of ops/csrc/mlp_bwd.cu, each unique to
# wgrad_tf32_kernel
_EXPECT = ("          mbar_expect_tx(&full[s], L::kStageBytes);\n"
           "          // A's boxes")
_SMALL_B = ("          tma_load(st + L::kABytes + L::kBBytes, &map_b, &full[s],\n"
            "                   kb * kWKt, gm.N + n0);\n")
ABLATIONS = {
    "full": [],
    "one_plane_b": [
        (_EXPECT, "          mbar_expect_tx(&full[s], L::kStageBytes - "
                  "L::kBBytes);\n          // A's boxes"),
        (_SMALL_B, ""),
        ("wgmma::tf32_rs<kWBN>(p, bg[kk], bs + 2 * kk, 1);",
         "wgmma::tf32_rs<kWBN>(p, bg[kk], b + 2 * kk, 1);")],
    "no_loads": [
        (_EXPECT, "          mbar_arrive(&full[s]);\n          if (false) {"
                  "\n          // A's boxes"),
        (_SMALL_B, _SMALL_B + "          }\n")],
    "two_passes": [
        ("          wgmma::tf32_rs<kWBN>(p, sl[kk], b + 2 * kk, kk);\n",
         "")],
    "no_prefetch": [
        ("        wgmma::commit();\n        const int s2",
         "        wgmma::commit();\n        wgmma::wait<0>();\n"
         "        const int s2")],
}


def variant_module(lib):
    """This tree's ops/mlp.py as a module of its own whose K8/K9 entry
    points are bound to ``lib``."""
    import importlib.util
    from slak_tpu_torch.ops import _build
    spec = importlib.util.spec_from_file_location("probe_mlp_variant",
                                                  K2.__file__)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    own = _build.load
    _build.load = lambda name: lib
    try:
        mod._bwd_entries()
    finally:
        _build.load = own
    return mod


def ablate(size: int, batch: int):
    """Rows {variant, stage, wgrad_us, bound, ptxas}: step 5's kernel's
    device us a full-mode launch at each stage shape in each ABLATIONS
    build, with ptxas's report of the kernel."""
    from slak_tpu_torch.tools.timing import build_variants
    logs = {}
    libs = build_variants("mlp_bwd", ABLATIONS, logs)
    rows = []
    for variant, lib in libs.items():
        lines = logs[variant].splitlines()
        at = next(i for i, ln in enumerate(lines)
                  if "Compiling entry" in ln and "wgrad_tf32_kernel" in ln)
        ptxas = [ln.strip() for ln in lines[at + 1:at + 4]]
        for row in run(size, torch.float32, 1, batch, variant_module(lib),
                       variant):
            if row["mode"] == "full":
                rows.append(dict(variant=variant, stage=row["stage"],
                                 wgrad_us=row["kernel_us"].get(
                                     "wgrad_tf32_kernel"),
                                 step5_3xtf32_bound_us=row[
                                     "step5_3xtf32_bound_us"],
                                 ptxas=ptxas))
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--base", help="another checkout (e.g. the parent "
                    "commit unpacked into a git-ignored directory)")
    ap.add_argument("--ablate", action="store_true")
    args = ap.parse_args()
    dtype = getattr(torch, args.dtype)
    if args.ablate:
        for row in ablate(args.size, args.batch):
            print(json.dumps(row), flush=True)
        print(device_line())
        return
    designs = [("change", K2)]
    if args.base:
        from chip_smoke import base_module
        designs.insert(0, ("base", base_module(
            args.base, "mlp_bwd", "mlp", ("_bwd_entries",),
            "probe_mlp_bwd")))
    for design, mod in designs:
        for row in run(args.size, dtype, batch=args.batch, mod=mod,
                       design=design):
            print(json.dumps(row), flush=True)
    print(device_line())


if __name__ == "__main__":
    main()
