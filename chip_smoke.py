#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``slak_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, needs one CUDA card
    python3 chip_smoke.py --phases build,kernels

Phases (any failure exits non-zero):
  build    nvcc-build every kernel under slak_tpu_torch/ops/csrc/.
  kernels  each kernel against its plain PyTorch version on the card at the
           flagship's shapes (SLaK-T 51x51 w1.3, the main path's batch): the
           dwconv pair at the four stages' (K,5)/(5,K) taps, the fused MLP
           in NCHW, NHWC and (C, M) strides, bf16 and fp32; times with CUDA
           events (median), the bound, the plain version's time and the
           library yardstick's.
  forward  the main path: create_model + make_eval_step on a few batches of
           synthetic labels, bf16 and fp32, with the launch counters set to 0
           just before and read just after; logits held against the same
           weights through the plain versions.
  timing   bf16 eval forward at batch 256 (bench.py's batch): img/s.
  train_kernels
           the train kernels against their plain versions at the train
           shapes (batch 128): the stats-fused conv (K4), the weight
           gradient (K5/K7) and K1 as the dgrad (flipped taps) at the four
           stages' (K,5)/(5,K) taps, the fused MLP backward (K8) at C = 124
           and 249 in NCHW; bf16 and fp32; times, bound, plain and library
           (or unfused) times.
  train    the train path: create_model (drop-path 0.1) +
           create_train_state (SNIP masks at 40% sparsity, random growth,
           refresh every 2 steps, EMA) + make_train_step, 4 bf16 steps at
           batch 128 with the launch counters set to 0 just before and read
           just after; DST refreshes, mask counts and masked weights
           checked; one step from the same state held against the plain
           route (bf16 at 128, fp32 at 32): loss, every gradient, BN stats.
  train_timing
           the bf16 batch-128 train step, kernel route and plain route.
  profile  (not in the default run) one eval forward and one train step
           under torch.profiler: device time by kernel, idle share, traces
           in chiprun_out/.

Prints the card's name and power limit, then a {"kernels": [...]} line, and
as its last line {"ok": true, "device": {...}}. TF32 is off for cuDNN and
for matmul throughout. Long output goes to chiprun_out/chip_smoke/.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

MAIN_BATCH = 64
TIMING_BATCH = 256
TRAIN_BATCH = 128
TRAIN_STEPS = 4
CHECK_BATCH_FP32 = 32
N_BATCHES = 3
REPS = 10                                   # launches a timed round
MODEL_KW = dict(kernel_size=(51, 49, 47, 13, 5), width_factor=1.3)
PEAK_BYTES_PER_S = 3.35e12                  # H100 SXM HBM3
OUT_DIR = os.path.join("chiprun_out", "chip_smoke")
# tolerances on max|kernel - plain| / max|plain|; bf16 allows the one-ulp
# rounding flips (2^-8) that a different fp32 summation order can cause
TOL_KERNEL = {"float32": 1e-5, "bfloat16": 1e-2}
TOL_MLP = {"float32": 1e-4, "bfloat16": 1e-2}
TOL_LOGITS = {"float32": 1e-3, "bfloat16": 5e-2}
# BN sums: max |kernel - plain| / max_c sum_{n,h,w} |y| (fp32 sums of the
# same stored y in another order; in bf16 also the y's own rounding flips)
TOL_SUMS = {"float32": 1e-5, "bfloat16": 1e-3}
# weight gradient: max |kernel - plain| / max |plain|, fp32 sums over
# N*H*W products in another order
TOL_WGRAD = {"float32": 1e-4, "bfloat16": 1e-4}
# the MLP backward: each output's max |kernel - plain| / max |plain|; in
# bf16 a rounding flip of g or da moves the products by an ulp of bf16
TOL_MLP_BWD = {"float32": 1e-3, "bfloat16": 2e-2}
# one train step, kernel route vs plain route from the same state: loss
# (relative), each gradient (relative norm error), BN running stats
# (max |diff| / max |plain|)
TOL_STEP = {"float32": dict(loss=1e-4, grad=1e-3, bn=1e-4),
            "bfloat16": dict(loss=2e-2, grad=1e-1, bn=2e-2)}


class PhaseError(RuntimeError):
    pass


def _check(ok: bool, msg: str):
    if not ok:
        raise PhaseError(msg)


def smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else \
        f"nvidia-smi failed: {r.stderr.strip()}"


def time_ms(fn, reps: int = REPS, warmup: int = 2, rounds: int = 5) -> float:
    """Device ms a call: CUDA events around `reps` back-to-back calls (so
    host launch overhead hides behind queued work), median of `rounds`."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def rel_err(got, want):
    d = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    return d, d / max(scale, 1e-30)


def peak_flops(dtype) -> float:
    import torch
    # H100 SXM peak: 989 TFLOP/s dense bf16, 67 fp32 (no TF32)
    return 989e12 if dtype == torch.bfloat16 else 67e12


def bounds(byts, flops, dtype):
    """(ms to move `byts` at the HBM rate, ms for `flops` at the peak of
    `dtype`): the bound is the larger."""
    return (byts / PEAK_BYTES_PER_S * 1e3, flops / peak_flops(dtype) * 1e3)


def dwconv_macs(N, C, H, W, kh, kw) -> int:
    """MACs a same-padded conv needs: taps that only see padding skipped."""
    def span(L, k):
        p = k // 2
        return sum(min(k, L + p - i) - max(0, p - i) for i in range(L))
    return N * C * span(H, kh) * span(W, kw)


def stage_shapes(cfg):
    dims = cfg.widened_dims
    for i in range(4):
        H = 56 >> i
        yield i, dims[i], H, cfg.stage_kernel(i), cfg.small_kernel, \
            cfg.depths[i]


# ---------------------------------------------------------------------------


def phase_build(ptxas: bool):
    from slak_tpu_torch.ops import _build
    t0 = time.perf_counter()
    logs = _build.build(ptxas_verbose=ptxas)
    print(f"[build] {time.perf_counter() - t0:.1f} s wall for "
          f"{sorted(logs) or 'nothing (up to date)'}")
    os.makedirs(OUT_DIR, exist_ok=True)
    for name, (sec, log) in logs.items():
        print(f"[build] {name}: {sec:.1f} s")
        with open(os.path.join(OUT_DIR, f"ptxas_{name}.txt"), "w") as f:
            f.write(log)
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")


def phase_kernels(cfg, batch):
    """Each kernel against its plain version at the main path's shapes."""
    import torch
    import torch.nn.functional as F
    from slak_tpu_torch.ops import dwconv as K1
    from slak_tpu_torch.ops import mlp as K2
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    totals = {"dwconv": dict(ms=0.0, plain_ms=0.0, library_ms=0.0,
                             bound_ms=0.0, bytes_ms=0.0, ops_ms=0.0,
                             err=0.0),
              "fused_mlp": dict(ms=0.0, plain_ms=0.0, unfused_torch_ms=0.0,
                                bound_ms=0.0, bytes_ms=0.0, ops_ms=0.0,
                                err=0.0)}
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        item = torch.tensor([], dtype=dtype).element_size()
        for i, C, H, K, s, depth in stage_shapes(cfg):
            x = torch.randn(batch, C, H, H, generator=g, device=dev
                            ).to(dtype)
            w1 = (torch.randn(C, K, s, generator=g, device=dev) * 0.05
                  ).to(dtype).float()
            w2 = (torch.randn(C, s, K, generator=g, device=dev) * 0.05
                  ).to(dtype).float()

            def pair(conv=K1.dwconv):
                y = conv(x, w1)
                return conv(x, w2, out=y)

            want = pair(K1.dwconv_plain)
            got = pair()
            torch.cuda.synchronize()
            d, r = rel_err(got, want)
            _check(r <= TOL_KERNEL[dn],
                   f"dwconv stage {i + 1} {dn}: rel err {r:.3g} > "
                   f"{TOL_KERNEL[dn]}")
            ms = time_ms(pair)
            plain_ms = time_ms(lambda: pair(K1.dwconv_plain))
            wl1 = w1.to(dtype)[:, None]
            wl2 = w2.to(dtype)[:, None]
            lib_ms = time_ms(lambda: (
                F.conv2d(x, wl1, padding=(K // 2, s // 2), groups=C),
                F.conv2d(x, wl2, padding=(s // 2, K // 2), groups=C)))
            # launch 1 reads x and writes y; launch 2 also reads y
            bound = bytes_ms = ops_ms = 0.0
            for (kh, kw), tensors in (((K, s), 2), ((s, K), 3)):
                b_ms, o_ms = bounds(
                    tensors * x.numel() * item + 4 * C * kh * kw,
                    2 * dwconv_macs(batch, C, H, H, kh, kw), dtype)
                bound += max(b_ms, o_ms)
                bytes_ms += b_ms
                ops_ms += o_ms
            row = dict(kernel="dwconv", dtype=dn, stage=i + 1, C=C, H=H,
                       taps=[K, s], batch=batch, max_abs_err=d, rel_err=r,
                       tol=TOL_KERNEL[dn], ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=bound,
                       launches_per_forward=2 * depth)
            print("[kernels] " + json.dumps(row), flush=True)
            if dtype == torch.bfloat16:
                t = totals["dwconv"]
                for k in ("ms", "plain_ms", "library_ms"):
                    t[k] += depth * row[k]
                t["bound_ms"] += depth * bound
                t["bytes_ms"] += depth * bytes_ms
                t["ops_ms"] += depth * ops_ms
                t["err"] = max(t["err"], d)
            del x

            # fused MLP at this stage's width
            F4 = 4 * C
            y = torch.randn(batch, C, H, H, generator=g, device=dev
                            ).to(dtype)
            res = torch.randn(batch, C, H, H, generator=g, device=dev
                              ).to(dtype)

            def vec(scale, shift, n=C):
                return torch.randn(n, generator=g, device=dev) * scale + shift
            pk = K2.pack_mlp(vec(0.1, 1.0), vec(0.1, 0.0),
                             torch.randn(C, F4, generator=g, device=dev)
                             * C ** -0.5, vec(0.1, 0.0, F4),
                             torch.randn(F4, C, generator=g, device=dev)
                             * F4 ** -0.5, vec(0.1, 0.0),
                             vec(0.1, 0.5), vec(0.1, 0.0), dtype)
            for layout, yy, rr, cd in (
                    ("NCHW", y, res, 1),
                    ("NHWC", y.permute(0, 2, 3, 1).contiguous(),
                     res.permute(0, 2, 3, 1).contiguous(), 3),
                    ("CM", y.transpose(0, 1).reshape(C, -1).contiguous(),
                     res.transpose(0, 1).reshape(C, -1).contiguous(), 0)):
                want = K2.fused_mlp_plain(yy, rr, pk, cd)
                got = K2.fused_mlp(yy, rr, pk, cd)
                torch.cuda.synchronize()
                d, r = rel_err(got, want)
                _check(r <= TOL_MLP[dn],
                       f"fused_mlp stage {i + 1} {layout} {dn}: rel err "
                       f"{r:.3g} > {TOL_MLP[dn]}")
                row = dict(kernel="fused_mlp", dtype=dn, stage=i + 1, C=C,
                           layout=layout, batch=batch, max_abs_err=d,
                           rel_err=r, tol=TOL_MLP[dn])
                if layout == "NCHW":
                    T = batch * H * H
                    ms = time_ms(lambda: K2.fused_mlp(y, res, pk, 1))
                    plain_ms = time_ms(
                        lambda: K2.fused_mlp_plain(y, res, pk, 1))
                    ln_s, ln_b, b2, gam, pre = pk.vec
                    w1d = pk.w1[:F4, :C].contiguous()
                    w2d = pk.w2[:C, :F4].contiguous()
                    b1d, b2d = pk.b1[:F4].to(dtype), b2.to(dtype)
                    lnd = (ln_s.to(dtype), ln_b.to(dtype))
                    gd, pd = gam.to(dtype), pre.to(dtype)

                    def unfused():
                        z = (y + pd[:, None, None]).permute(0, 2, 3, 1)
                        z = F.layer_norm(z, (C,), *lnd, eps=1e-6)
                        z = F.linear(F.gelu(F.linear(z, w1d, b1d)), w2d, b2d)
                        return res + (gd * z).permute(0, 3, 1, 2)
                    unf_ms = time_ms(unfused)
                    b_ms, o_ms = bounds(
                        3 * T * C * item + 2 * C * F4 * item,
                        4 * T * C * F4, dtype)
                    row.update(ms=ms, plain_ms=plain_ms,
                               unfused_torch_ms=unf_ms,
                               bound_ms=max(b_ms, o_ms),
                               launches_per_forward=depth)
                    if dtype == torch.bfloat16:
                        t = totals["fused_mlp"]
                        for k in ("ms", "plain_ms", "unfused_torch_ms",
                                  "bound_ms"):
                            t[k] += depth * row[k]
                        t["bytes_ms"] += depth * b_ms
                        t["ops_ms"] += depth * o_ms
                if dtype == torch.bfloat16:
                    totals["fused_mlp"]["err"] = max(
                        totals["fused_mlp"]["err"], d)
                print("[kernels] " + json.dumps(row), flush=True)
            del y, res, pk
            torch.cuda.empty_cache()
    return totals


def randomize(model, seed: int):
    """Random weights from a seed that make every block matter: gamma near
    0.2 (not 1e-6), BN statistics and affines away from identity."""
    import torch
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            noise = torch.randn(p.shape, generator=g).to(p.device)
            if name.endswith("gamma"):
                p.copy_(0.2 + 0.05 * noise)
            elif ".bn." in name or p.ndim == 1:
                p.add_(0.05 * noise)
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(0.05 * torch.randn(b.shape, generator=g))
            elif name.endswith("running_var"):
                b.copy_(1.0 + 0.2 * torch.rand(b.shape, generator=g))


def phase_forward(batch):
    """The main path; returns the launch counts of the bf16 run."""
    import torch
    from slak_tpu_torch.models import apply, create_model
    from slak_tpu_torch.ops import dwconv as K1
    from slak_tpu_torch.ops import mlp as K2
    from slak_tpu_torch.train.engine import make_eval_step
    model = create_model("SLaK_tiny", dtype=torch.bfloat16, seed=0,
                         **MODEL_KW)
    randomize(model, 1)
    n_blocks = sum(model.cfg.depths)
    n_conv = sum(len(b.prepared(torch.bfloat16, torch.device("cuda"))[0])
                 for s in model.stages for b in s)
    print(f"[forward] SLaK-T 51x51 w1.3: dims {model.cfg.widened_dims}, "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.2f} M params,"
          f" {n_conv} conv + {n_blocks} MLP launches per forward")
    g = torch.Generator().manual_seed(2)
    batches = [(torch.randn(batch, 224, 224, 3, generator=g),
                torch.randint(0, 1000, (batch,), generator=g))
               for _ in range(N_BATCHES)]
    counts = None
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        step = make_eval_step(model, dtype)
        step(batches[0])                     # pack weights, warm up
        torch.cuda.synchronize()
        K1.launch_count = 0
        K2.launch_count = 0
        t0 = time.perf_counter()
        outs = [step(b) for b in batches]
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        got = (K1.launch_count, K2.launch_count)
        if dtype == torch.bfloat16:
            counts = got
        print(f"[forward] {dn}: {N_BATCHES} batches of {batch} in "
              f"{sec:.3f} s; launches dwconv {got[0]}, fused_mlp {got[1]}")
        _check(got == (n_conv * N_BATCHES, n_blocks * N_BATCHES),
               f"{dn} launch counts {got}, want "
               f"{(n_conv * N_BATCHES, n_blocks * N_BATCHES)}")
        for j, (o, (x, y)) in enumerate(zip(outs, batches)):
            lg = o["logits"]
            _check(lg.shape == (batch, 1000) and bool(
                torch.isfinite(lg).all()), f"{dn} logits bad: {lg.shape}")
            want = apply(model, x.to("cuda", dtype), plain=True)
            d, r = rel_err(lg, want)
            top1 = (lg.argmax(-1) == want.argmax(-1)).float().mean().item()
            print(f"[forward] {dn} batch {j}: loss {o['loss'].item():.6f} "
                  f"acc1 {o['acc1'].item():.4f} acc5 {o['acc5'].item():.4f}"
                  f" | vs plain: max abs {d:.4g}, rel {r:.4g} (tol "
                  f"{TOL_LOGITS[dn]}), top-1 agreement {top1:.4f}")
            _check(r <= TOL_LOGITS[dn], f"{dn} logits rel err {r:.3g}")
    return model, counts


def phase_timing(model, batch):
    import torch
    from slak_tpu_torch.models import apply
    x = torch.randn(batch, 224, 224, 3, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(3)
                    ).to(torch.bfloat16)
    ms = time_ms(lambda: apply(model, x))
    plain_ms = time_ms(lambda: apply(model, x, plain=True), 3, warmup=1)
    print(f"[timing] bf16 eval forward bs{batch}: kernels {ms:.3f} ms "
          f"({batch / ms * 1e3:.1f} img/s); plain versions {plain_ms:.3f} ms"
          f" ({batch / plain_ms * 1e3:.1f} img/s); peak mem "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return ms


def dead_taps(K: int, L: int):
    """Tap indices along a K-long axis that only ever read padding on a
    map of extent L."""
    return [i for i in range(K) if abs(i - K // 2) >= L]


def phase_train_kernels(cfg, batch):
    """K4, the weight gradient, the K1 dgrad and K8 against their plain
    versions at the train shapes; returns per-train-step totals (bf16) for
    the JSON line."""
    import torch
    import torch.nn.functional as F
    from slak_tpu_torch.ops import dwconv as K1
    from slak_tpu_torch.ops import dwconv_wgrad as KW
    from slak_tpu_torch.ops import mlp as K2
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(10)
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bytes_ms",
            "ops_ms")
    totals = {n: dict({k: 0.0 for k in keys}, err=0.0)
              for n in ("dwconv_stats", "dwconv_wgrad", "dwconv_dgrad",
                        "mlp_bwd")}
    # the 7x7 maps' share (stage 4: the TPU's K6 forward/dgrad and K7)
    on_7x7 = {n: dict.fromkeys(keys[:4], 0.0) for n in totals}

    def add(name, row, depth, b_ms, o_ms):
        t = totals[name]
        for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
            t[k] += depth * row[k]
            if row.get("H") == 7:
                on_7x7[name][k] += depth * row[k]
        t["bytes_ms"] += depth * b_ms
        t["ops_ms"] += depth * o_ms
        t["err"] = max(t["err"], row["max_abs_err"])

    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        item = torch.tensor([], dtype=dtype).element_size()
        for i, C, H, K, s, depth in stage_shapes(cfg):
            x = torch.randn(batch, C, H, H, generator=g, device=dev).to(dtype)
            dy = torch.randn(batch, C, H, H, generator=g, device=dev
                             ).to(dtype)
            taps = [(K, s), (s, K)]
            ws = [(torch.randn(C, kh, kw, generator=g, device=dev) * 0.05
                   ).to(dtype).float() for kh, kw in taps]
            # K4: the pair of stats-fused convs
            d_max = s_err = 0.0
            for w in ws:
                y, s1, s2 = K1.dwconv_stats(x, w)
                yp, p1, p2 = K1.dwconv_stats_plain(x, w)
                torch.cuda.synchronize()
                d, r = rel_err(y, yp)
                _check(r <= TOL_KERNEL[dn], f"dwconv_stats stage {i + 1} "
                       f"{tuple(w.shape[1:])} {dn}: y rel err {r:.3g}")
                scale = yp.float().abs().sum((0, 2, 3)).max().item()
                for a, b in ((s1, p1), (s2, p2)):
                    e = (a - b).abs().max().item() / scale
                    _check(e <= TOL_SUMS[dn], f"dwconv_stats stage {i + 1} "
                           f"{dn}: sums rel err {e:.3g}")
                    s_err = max(s_err, e)
                d_max = max(d_max, d)
            ms = time_ms(lambda: [K1.dwconv_stats(x, w) for w in ws])
            plain_ms = time_ms(lambda: [K1.dwconv_stats_plain(x, w)
                                        for w in ws])
            wl = [w.to(dtype)[:, None] for w in ws]

            def lib():
                for w, (kh, kw) in zip(wl, taps):
                    yy = F.conv2d(x, w, padding=(kh // 2, kw // 2), groups=C)
                    yf = yy.float()
                    yf.sum((0, 2, 3)), yf.square().sum((0, 2, 3))
            lib_ms = time_ms(lib)
            b_ms = o_ms = bound = 0.0
            for kh, kw in taps:
                bb, oo = bounds(2 * x.numel() * item + 4 * C * (kh * kw + 2),
                                2 * dwconv_macs(batch, C, H, H, kh, kw),
                                dtype)
                b_ms, o_ms, bound = b_ms + bb, o_ms + oo, bound + max(bb, oo)
            row = dict(kernel="dwconv_stats", dtype=dn, stage=i + 1, C=C,
                       H=H, taps=[K, s], batch=batch, max_abs_err=d_max,
                       sums_rel_err=s_err, tol=TOL_KERNEL[dn],
                       tol_sums=TOL_SUMS[dn], ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=bound,
                       launches_per_step=2 * depth)
            print("[train_kernels] " + json.dumps(row), flush=True)
            if dtype == torch.bfloat16:
                add("dwconv_stats", row, depth, b_ms, o_ms)

            # the weight gradient of the pair
            d_max = r_max = 0.0
            for kh, kw in taps:
                got = KW.dwconv_wgrad(x, dy, kh, kw)
                want = KW.dwconv_wgrad_plain(x, dy, kh, kw)
                torch.cuda.synchronize()
                d, r = rel_err(got, want)
                _check(r <= TOL_WGRAD[dn], f"dwconv_wgrad stage {i + 1} "
                       f"{(kh, kw)} {dn}: rel err {r:.3g}")
                dead = (got[:, dead_taps(kh, H)].abs().max().item()
                        if kh > kw and dead_taps(kh, H) else
                        got[:, :, dead_taps(kw, H)].abs().max().item()
                        if dead_taps(kw, H) else 0.0)
                _check(dead == 0.0, f"dwconv_wgrad stage {i + 1}: taps "
                       f"that only read padding got {dead}")
                d_max, r_max = max(d_max, d), max(r_max, r)
            ms = time_ms(lambda: [KW.dwconv_wgrad(x, dy, kh, kw)
                                  for kh, kw in taps])
            plain_ms = time_ms(lambda: [KW.dwconv_wgrad_plain(x, dy, kh, kw)
                                        for kh, kw in taps])
            lib_ms = time_ms(lambda: [torch.nn.grad.conv2d_weight(
                x, (C, 1, kh, kw), dy, padding=(kh // 2, kw // 2), groups=C)
                for kh, kw in taps])
            b_ms = o_ms = bound = 0.0
            for kh, kw in taps:
                bb, oo = bounds(2 * x.numel() * item + 4 * C * kh * kw,
                                2 * dwconv_macs(batch, C, H, H, kh, kw),
                                dtype)
                b_ms, o_ms, bound = b_ms + bb, o_ms + oo, bound + max(bb, oo)
            row = dict(kernel="dwconv_wgrad", dtype=dn, stage=i + 1, C=C,
                       H=H, taps=[K, s], batch=batch, max_abs_err=d_max,
                       rel_err=r_max, tol=TOL_WGRAD[dn], ms=ms,
                       plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                       launches_per_step=2 * depth)
            print("[train_kernels] " + json.dumps(row), flush=True)
            if dtype == torch.bfloat16:
                add("dwconv_wgrad", row, depth, b_ms, o_ms)

            # K1 as each branch's dgrad: its taps flipped on both axes
            flipped = [w.flip(1, 2).contiguous() for w in ws]
            d_max = 0.0
            for w in flipped:
                got, want = K1.dwconv(dy, w), K1.dwconv_plain(dy, w)
                torch.cuda.synchronize()
                d, r = rel_err(got, want)
                _check(r <= TOL_KERNEL[dn], f"dwconv dgrad stage {i + 1} "
                       f"{tuple(w.shape[1:])} {dn}: rel err {r:.3g}")
                d_max = max(d_max, d)
            ms = time_ms(lambda: [K1.dwconv(dy, w) for w in flipped])
            plain_ms = time_ms(lambda: [K1.dwconv_plain(dy, w)
                                        for w in flipped])
            lib_ms = time_ms(lambda: [F.conv2d(
                dy, w.to(dtype)[:, None], padding=(kh // 2, kw // 2),
                groups=C) for w, (kh, kw) in zip(flipped, taps)])
            b_ms = o_ms = bound = 0.0
            for kh, kw in taps:
                bb, oo = bounds(2 * x.numel() * item + 4 * C * kh * kw,
                                2 * dwconv_macs(batch, C, H, H, kh, kw),
                                dtype)
                b_ms, o_ms, bound = b_ms + bb, o_ms + oo, bound + max(bb, oo)
            row = dict(kernel="dwconv_dgrad", dtype=dn, stage=i + 1, C=C,
                       H=H, taps=[K, s], batch=batch, max_abs_err=d_max,
                       tol=TOL_KERNEL[dn], ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=bound,
                       launches_per_step=2 * depth)
            print("[train_kernels] " + json.dumps(row), flush=True)
            if dtype == torch.bfloat16:
                add("dwconv_dgrad", row, depth, b_ms, o_ms)
            del x, dy

            if C > K2.BWD_C_MAX:
                continue
            # K8 at this stage's width, NCHW
            F4 = 4 * C
            y = torch.randn(batch, C, H, H, generator=g, device=dev).to(dtype)
            dout = (torch.randn(batch, C, H, H, generator=g, device=dev)
                    * 0.1).to(dtype)

            def vec(scale, shift, n=C):
                return torch.randn(n, generator=g, device=dev) * scale + shift
            pk = K2.pack_mlp(vec(0.1, 1.0), vec(0.1, 0.0),
                             torch.randn(C, F4, generator=g, device=dev)
                             * C ** -0.5, vec(0.1, 0.0, F4),
                             torch.randn(F4, C, generator=g, device=dev)
                             * F4 ** -0.5, vec(0.1, 0.0), vec(0.1, 0.5),
                             None, dtype)
            got = K2.fused_mlp_bwd(y, dout, pk, 1)
            want = K2.fused_mlp_bwd_plain(y, dout, pk, 1)
            torch.cuda.synchronize()
            names = ("dy", "dW1", "dW2", "db1", "db2", "dgamma", "dln_scale",
                     "dln_bias")
            errs = {}
            for nm, a, b in zip(names, got, want):
                d, r = rel_err(a, b)
                errs[nm] = r
                _check(r <= TOL_MLP_BWD[dn], f"mlp_bwd stage {i + 1} {dn}: "
                       f"{nm} rel err {r:.3g} > {TOL_MLP_BWD[dn]}")
            d_max = max(rel_err(a, b)[0] for a, b in zip(got, want))
            ms = time_ms(lambda: K2.fused_mlp_bwd(y, dout, pk, 1))
            plain_ms = time_ms(lambda: K2.fused_mlp_bwd_plain(y, dout, pk, 1),
                               3, warmup=1)
            # the unfused autograd composition's backward (no single call)
            ln_s, ln_b, b2, gam, _ = pk.vec
            leaves = [t.to(dtype).detach().requires_grad_() for t in (
                ln_s, ln_b, pk.w1[:F4, :C], pk.b1[:F4], pk.w2[:C, :F4], b2,
                gam)]
            yl = y.detach().requires_grad_()
            z = yl.permute(0, 2, 3, 1)
            z = F.layer_norm(z, (C,), leaves[0], leaves[1], eps=1e-6)
            z = F.linear(F.gelu(F.linear(z, leaves[2], leaves[3])),
                         leaves[4], leaves[5])
            out = (leaves[6] * z).permute(0, 3, 1, 2)
            dperm = dout
            unf_ms = time_ms(lambda: torch.autograd.grad(
                out, [yl] + leaves, dperm, retain_graph=True), 3, warmup=1)
            del out, z
            T = batch * H * H
            b_ms, o_ms = bounds(3 * T * C * item + 2 * C * F4 * item
                                + 4 * (2 * C * F4 + F4 + 4 * C),
                                12 * T * C * F4, dtype)
            row = dict(kernel="mlp_bwd", dtype=dn, stage=i + 1, C=C,
                       layout="NCHW", batch=batch, max_abs_err=d_max,
                       rel_err=errs, tol=TOL_MLP_BWD[dn], ms=ms,
                       plain_ms=plain_ms, library_ms=None,
                       unfused_torch_ms=unf_ms, bound_ms=max(b_ms, o_ms),
                       launches_per_step=depth)
            print("[train_kernels] " + json.dumps(row), flush=True)
            if dtype == torch.bfloat16:
                row = dict(row, library_ms=unf_ms)
                add("mlp_bwd", row, depth, b_ms, o_ms)
            del y, dout, pk, leaves, yl
            torch.cuda.empty_cache()
    print("[train_kernels] per bf16 step, of which on the 7x7 maps: "
          + json.dumps({n: {k: round(v, 4) for k, v in t.items()}
                        for n, t in on_7x7.items() if t["ms"]}), flush=True)
    return totals


def _counters():
    from slak_tpu_torch.ops import dwconv as K1
    from slak_tpu_torch.ops import dwconv_wgrad as KW
    from slak_tpu_torch.ops import mlp as K2
    return K1, KW, K2


def reset_counts():
    K1, KW, K2 = _counters()
    K1.launch_count = K1.stats_launch_count = KW.launch_count = 0
    K2.launch_count = K2.bwd_launch_count = 0


def read_counts():
    K1, KW, K2 = _counters()
    return {"dwconv": K1.launch_count, "dwconv_stats": K1.stats_launch_count,
            "dwconv_wgrad": KW.launch_count, "fused_mlp": K2.launch_count,
            "mlp_bwd": K2.bwd_launch_count}


def train_setup(batch, dtype, mask_kw, seed=0, snip=True, masks=None,
                model_state=None):
    """(model, train state, step fn, batches) of the flagship train path."""
    import torch
    from slak_tpu_torch.models import apply, create_model
    from slak_tpu_torch.sparsity.masking import MaskConfig
    from slak_tpu_torch.train import losses as L
    from slak_tpu_torch.train.engine import (TrainConfig, create_train_state,
                                             make_train_step)
    from slak_tpu_torch.train.optim import cosine_schedule_array
    model = create_model("SLaK_tiny", dtype=dtype, seed=seed,
                         drop_path_rate=0.1, **MODEL_KW)
    if model_state is not None:
        model.load_state_dict(model_state)
    else:
        randomize(model, 1)
    g = torch.Generator(device="cuda").manual_seed(7)
    batches = [(torch.randn(batch, 224, 224, 3, generator=g, device="cuda"),
                torch.randint(0, 1000, (batch,), generator=g, device="cuda"))
               for _ in range(2)]
    mc = MaskConfig(**mask_kw)
    tc = TrainConfig(compute_dtype=dtype, weight_decay=0.05,
                     ema_decay=0.9999, prune_t_max=100)

    def snip_loss():
        x, y = batches[0]
        return L.cross_entropy(apply(model, x.to(dtype)), y)
    state = create_train_state(model, tc, mc,
                               snip_loss if snip and masks is None else None,
                               masks=masks, seed=seed)
    lr = cosine_schedule_array(1e-3, 1e-6, 1, 100)
    return model, state, tc, mc, lr, batches


TRAIN_MASK = dict(sparsity=0.4, sparse_init="snip", prune_mode="magnitude",
                  growth_mode="random", prune_rate=0.5, update_frequency=2)


def phase_train(batch):
    """The train path; returns the launch counts of its bf16 steps."""
    import copy
    import torch
    from slak_tpu_torch.train.engine import make_train_step
    dtype = torch.bfloat16
    t0 = time.perf_counter()
    model, state, tc, mc, lr, batches = train_setup(batch, dtype, TRAIN_MASK)
    masks0 = {n: m.clone() for n, m in state.mask_state.masks.items()}
    sd0 = copy.deepcopy(model.state_dict())
    dens = (sum(float(m.sum()) for m in masks0.values())
            / sum(m.numel() for m in masks0.values()))
    print(f"[train] set-up (SNIP masks, {len(masks0)} masked tensors, "
          f"density {dens:.4f}) {time.perf_counter() - t0:.1f} s",
          flush=True)
    step = make_train_step(model, tc, mc, lr)
    named = dict(model.named_parameters())
    gen = torch.Generator(device="cuda").manual_seed(11)
    n_refresh = 0
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for k in range(TRAIN_STEPS):
        before = {n: m.clone() for n, m in state.mask_state.masks.items()}
        state, met = step(state, batches[k % 2], gen)
        masks = state.mask_state.masks
        changed = any(not torch.equal(before[n], masks[n]) for n in masks)
        n_refresh += changed
        loss = met["loss"].item()
        _check(math.isfinite(loss), f"step {k}: loss {loss}")
        for n, m in masks.items():
            z = (named[n].detach() * (1 - m)).abs().max().item()
            _check(z == 0.0, f"step {k}: masked weights of {n} not 0 ({z})")
        if changed:
            # random growth regrows Binomial(zeros, regrowth / zeros)
            for n, m in masks.items():
                nb, na = before[n].sum().item(), m.sum().item()
                _check(abs(na - nb) <= 6 * max(nb, 1) ** 0.5 + 1,
                       f"step {k}: {n} count {nb} -> {na}")
        print(f"[train] step {k}: loss {loss:.5f} grad_norm "
              f"{met['grad_norm'].item():.4f} lr {met['lr'].item():.3g} "
              f"refresh {bool(changed)}", flush=True)
    torch.cuda.synchronize()
    counts = read_counts()
    sec = time.perf_counter() - t0
    n_blocks = sum(model.cfg.depths)
    fused = sum(d for d, c in zip(model.cfg.depths, model.cfg.widened_dims)
                if c <= 256)
    want = {"dwconv": 2 * n_blocks * TRAIN_STEPS,
            "dwconv_stats": 2 * n_blocks * TRAIN_STEPS,
            "dwconv_wgrad": 2 * n_blocks * TRAIN_STEPS,
            "fused_mlp": fused * TRAIN_STEPS,
            "mlp_bwd": fused * TRAIN_STEPS}
    print(f"[train] {TRAIN_STEPS} bf16 steps at batch {batch} in {sec:.2f} s;"
          f" launches {counts}; refreshes {n_refresh}", flush=True)
    _check(counts == want, f"launch counts {counts}, want {want}")
    _check(n_refresh == TRAIN_STEPS // mc.update_frequency,
           f"{n_refresh} DST refreshes, want "
           f"{TRAIN_STEPS // mc.update_frequency}")
    ema = state.ema
    _check(all(bool(torch.isfinite(v).all()) for v in ema.values()),
           "EMA not finite")
    del model, state, step, batches
    torch.cuda.empty_cache()

    # one step from the same state, kernel route vs plain route
    for dtype, b in ((torch.bfloat16, batch),
                     (torch.float32, CHECK_BATCH_FP32)):
        dn = str(dtype).split(".")[1]
        runs = []
        for plain in (False, True):
            model, state, tc, mc, lr, batches = train_setup(
                b, dtype, TRAIN_MASK, masks={n: m.clone() for n, m in
                                             masks0.items()},
                model_state=sd0)
            step = make_train_step(model, tc, mc, lr, plain=plain)
            state, met = step(state, batches[0],
                              torch.Generator(device="cuda").manual_seed(5))
            grads = {n: p.grad.detach().float().clone()
                     for n, p in model.named_parameters()}
            bn = {n: v.clone() for n, v in model.state_dict().items()
                  if "running" in n}
            runs.append((met["loss"].item(), grads, bn))
            del model, state, step, batches
            torch.cuda.empty_cache()
        (lk, gk, bk), (lp, gp, bp) = runs
        tol = TOL_STEP[dn]
        le = abs(lk - lp) / abs(lp)
        ge = {n: ((gk[n] - gp[n]).norm() / gp[n].norm().clamp(min=1e-30)
                  ).item() for n in gp}
        worst = max(ge, key=ge.get)
        be = max(rel_err(bk[n], bp[n])[1] for n in bp)
        print(f"[train] one {dn} step at batch {b}, kernels vs plain: loss "
              f"{lk:.6f} vs {lp:.6f} (rel {le:.3g}, tol {tol['loss']}); "
              f"grad rel norm err max {ge[worst]:.3g} ({worst}), median "
              f"{statistics.median(ge.values()):.3g} (tol {tol['grad']}); "
              f"BN running stats rel {be:.3g} (tol {tol['bn']})", flush=True)
        _check(le <= tol["loss"], f"{dn} step loss rel err {le:.3g}")
        _check(ge[worst] <= tol["grad"], f"{dn} grad {worst} rel err "
               f"{ge[worst]:.3g}")
        _check(be <= tol["bn"], f"{dn} BN stats rel err {be:.3g}")
    return counts


def phase_train_timing(batch):
    """The bf16 train step (DST refresh every 100 steps, the reference's
    interval, so none falls in the window), kernel route and plain route
    timed in this run."""
    import torch
    from slak_tpu_torch.train.engine import make_train_step
    out = {}
    mask_kw = dict(TRAIN_MASK, sparse_init="ERK", update_frequency=100)
    for plain in (False, True):
        model, state, tc, mc, lr, batches = train_setup(
            batch, torch.bfloat16, mask_kw, snip=False)
        step = make_train_step(model, tc, mc, lr, plain=plain)
        gen = torch.Generator(device="cuda").manual_seed(3)
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(lambda: step(state, batches[0], gen),
                     *((3, 1, 3) if plain else (5, 2, 5)))
        out["plain" if plain else "kernels"] = (
            ms, torch.cuda.max_memory_allocated() / 2**30)
        del model, state, step, batches
        torch.cuda.empty_cache()
    (k_ms, k_gb), (p_ms, p_gb) = out["kernels"], out["plain"]
    print(f"[train_timing] bf16 train step bs{batch}: kernels {k_ms:.3f} ms "
          f"({batch / k_ms * 1e3:.1f} img/s, peak {k_gb:.2f} GiB); plain "
          f"versions {p_ms:.3f} ms ({batch / p_ms * 1e3:.1f} img/s, peak "
          f"{p_gb:.2f} GiB)", flush=True)
    return k_ms


def _profile_rows(prof):
    """Device-side rows only (the kernels; the aten ops above them would
    count the same time again), longest first."""
    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    rows = [e for e in prof.key_averages() if dev_us(e) > 0
            and str(getattr(e, "device_type", "")).endswith("CUDA")]
    rows.sort(key=dev_us, reverse=True)
    return rows, dev_us


# kernel name -> share of the device time: the port's kernels by source,
# then what stock PyTorch runs (first match wins: mlp_bwd.cu's kernels
# before the wgrad group's "wgrad_")
_GROUPS = (("mlp_bwd.cu (K8)", ("mlp_bwd_", "sum_partials")),
           ("dwconv.cu (K1/K4)", ("dwconv_kernel", "dwconv_tiled",
                                  "dwconv_stats_reduce")),
           ("dwconv_wgrad.cu (K5/K7)", ("wgrad_",)),
           ("mlp.cu (K2/K3)", ("mlp_rf_", "mlp_tc_", "mlp_simt_")),
           ("GEMM (cuBLAS/CUTLASS)", ("gemm", "cutlass")),
           ("stock conv (cuDNN/ATen)", ("conv_depthwise", "cudnn",
                                        "implicit_convolve", "nchwToNhwc",
                                        "nhwcToNchw")),
           ("reductions", ("reduce_kernel",)),
           ("elementwise, copies, foreach", ("elementwise", "copy",
                                              "multi_tensor", "foreach")))


def print_profile(tag, prof, wall_ms, top):
    """Busy time, idle share, the time by group and the `top` kernels."""
    rows, dev_us = _profile_rows(prof)
    busy_ms = sum(dev_us(e) for e in rows) / 1e3
    print(f"[profile] {tag}: wall {wall_ms:.3f} ms (under the profiler), "
          f"device busy {busy_ms:.3f} ms, idle share "
          f"{max(0.0, 1 - busy_ms / wall_ms):.4f}")
    groups = {}
    for e in rows:
        name = next((g for g, keys in _GROUPS
                     if any(k in e.key for k in keys)), "other")
        groups[name] = groups.get(name, 0.0) + dev_us(e) / 1e3
    print("[profile]   by group (ms): " + json.dumps(
        {k: round(v, 3) for k, v in sorted(groups.items(),
                                           key=lambda kv: -kv[1])}))
    for e in rows[:top]:
        print(f"[profile]   {dev_us(e) / 1e3:9.3f} ms  x{e.count:<4d} "
              f"{e.key[:90]}")


def phase_profile_train(batch):
    """One bf16 train step under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from slak_tpu_torch.train.engine import make_train_step
    model, state, tc, mc, lr, batches = train_setup(
        batch, torch.bfloat16, dict(TRAIN_MASK, sparse_init="ERK",
                                    update_frequency=100), snip=False)
    step = make_train_step(model, tc, mc, lr)
    for _ in range(2):
        step(state, batches[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batches[0])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    print_profile(f"bf16 train step bs{batch}", prof, wall_ms, 20)
    os.makedirs(OUT_DIR, exist_ok=True)
    prof.export_chrome_trace(os.path.join(OUT_DIR, "train_trace.json"))


def phase_profile(model, batch):
    """One bf16 forward under torch.profiler: device time by kernel and the
    share of the forward's wall time the card was busy."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from slak_tpu_torch.models import apply
    x = torch.randn(batch, 224, 224, 3, device="cuda").to(torch.bfloat16)
    for _ in range(2):
        apply(model, x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        apply(model, x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    print_profile(f"bf16 forward bs{batch}", prof, wall_ms, 12)
    os.makedirs(OUT_DIR, exist_ok=True)
    prof.export_chrome_trace(os.path.join(OUT_DIR, "forward_trace.json"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="build,kernels,forward,timing,"
                    "train_kernels,train,train_timing")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from slak_tpu_torch.models.slak import config_for
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__},"
          f" cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    cfg = config_for("SLaK_tiny", **MODEL_KW)
    totals, counts = None, None
    train_totals, train_counts = None, None
    t_start = time.perf_counter()
    try:
        if "build" in phases:
            phase_build(ptxas=True)
        if "kernels" in phases:
            totals = phase_kernels(cfg, MAIN_BATCH)
        model = None
        if "forward" in phases:
            model, counts = phase_forward(MAIN_BATCH)
        if "timing" in phases:
            if model is None:
                from slak_tpu_torch.models import create_model
                model = create_model("SLaK_tiny", dtype=torch.bfloat16,
                                     **MODEL_KW)
            phase_timing(model, TIMING_BATCH)
        if "profile" in phases:
            if model is None:
                from slak_tpu_torch.models import create_model
                model = create_model("SLaK_tiny", dtype=torch.bfloat16,
                                     **MODEL_KW)
            phase_profile(model, TIMING_BATCH)
        del model
        torch.cuda.empty_cache()
        if "train_kernels" in phases:
            train_totals = phase_train_kernels(cfg, TRAIN_BATCH)
        if "train" in phases:
            train_counts = phase_train(TRAIN_BATCH)
        if "train_timing" in phases:
            phase_train_timing(TRAIN_BATCH)
        if "profile" in phases:
            phase_profile_train(TRAIN_BATCH)
    except Exception as e:                      # report and fail the run
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"[total] {time.perf_counter() - t_start:.1f} s")
    kernels = []
    if totals is not None:
        for name, src, repl, extra in (
                ("dwconv", "slak_tpu_torch/ops/csrc/dwconv.cu",
                 "slak_tpu/ops/pallas_banded.py:168",
                 {"also_replaces": "slak_tpu/ops/pallas_banded.py:753 "
                  "(K6, the 7x7 maps' forward and dgrad)"}),
                ("fused_mlp", "slak_tpu_torch/ops/csrc/mlp.cu",
                 "slak_tpu/ops/pallas_mlp.py:527",
                 {"also_replaces": "slak_tpu/ops/pallas_mlp.py:149"})):
            t = totals[name]
            kernels.append(dict(
                name=name, route="cuda", source=src, replaces=repl,
                launches=None if counts is None else
                counts[0 if name == "dwconv" else 1],
                max_abs_err=t["err"], ms=t["ms"], plain_ms=t["plain_ms"],
                bound_ms=t["bound_ms"],
                bound_by=("bytes" if t["bytes_ms"] >= t["ops_ms"]
                          else "operations"),
                library_ms=t.get("library_ms"), **extra,
                **({"unfused_torch_ms": t["unfused_torch_ms"]}
                   if "unfused_torch_ms" in t else {}),
                train_launches=None if train_counts is None
                else train_counts[name],
                times_per="one bf16 forward at batch %d" % MAIN_BATCH,
                launches_in="the eval path: %d bf16 forwards at batch %d"
                % (N_BATCHES, MAIN_BATCH)))
        if train_totals is not None:
            # K1 as the train step's dgrad, per bf16 step at TRAIN_BATCH
            t = train_totals["dwconv_dgrad"]
            kernels[0].update(
                {"train_" + k: t[k] for k in ("ms", "plain_ms", "library_ms",
                                              "bound_ms")},
                train_max_abs_err=t["err"],
                train_times_per="the dgrad launches of one bf16 train step "
                "at batch %d" % TRAIN_BATCH)
    if train_totals is not None:
        for name, src, repl, extra in (
                ("dwconv_stats", "slak_tpu_torch/ops/csrc/dwconv.cu",
                 "slak_tpu/ops/pallas_banded.py:251",
                 {"library": "F.conv2d(groups=C) + sum + sum of squares"}),
                ("dwconv_wgrad", "slak_tpu_torch/ops/csrc/dwconv_wgrad.cu",
                 "slak_tpu/ops/pallas_banded.py:888",
                 {"also_replaces": "slak_tpu/ops/pallas_banded.py:806",
                  "library": "torch.nn.grad.conv2d_weight(groups=C)"}),
                ("mlp_bwd", "slak_tpu_torch/ops/csrc/mlp_bwd.cu",
                 "slak_tpu/ops/pallas_mlp.py:263", {})):
            t = train_totals[name]
            lib = t["library_ms"]
            if name == "mlp_bwd":
                extra = {"unfused_torch_ms": lib,
                         "library": "none; unfused_torch_ms is the autograd "
                         "backward of the unfused composition"}
                lib = None
            kernels.append(dict(
                name=name, route="cuda", source=src, replaces=repl,
                launches=None if train_counts is None
                else train_counts[name],
                max_abs_err=t["err"], ms=t["ms"], plain_ms=t["plain_ms"],
                bound_ms=t["bound_ms"],
                bound_by=("bytes" if t["bytes_ms"] >= t["ops_ms"]
                          else "operations"),
                library_ms=lib, **extra,
                times_per="one bf16 train step at batch %d" % TRAIN_BATCH,
                launches_in="the train path: %d bf16 steps at batch %d"
                % (TRAIN_STEPS, TRAIN_BATCH)))
    if kernels:
        print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
