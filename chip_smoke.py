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
  profile  (not in the default run) one such forward under torch.profiler:
           device time by kernel, idle share, a trace in chiprun_out/.

Prints the card's name and power limit, then a {"kernels": [...]} line, and
as its last line {"ok": true, "device": {...}}. TF32 is off for cuDNN and
for matmul throughout. Long output goes to chiprun_out/chip_smoke/.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

MAIN_BATCH = 64
TIMING_BATCH = 256
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

    def bounds(byts, flops):
        return (byts / PEAK_BYTES_PER_S * 1e3,
                flops / peak_flops(dtype) * 1e3)
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
                    2 * dwconv_macs(batch, C, H, H, kh, kw))
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
                        4 * T * C * F4)
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

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    # device-side rows only (the kernels); the aten ops above them would
    # count the same time again
    rows = [e for e in prof.key_averages() if dev_us(e) > 0
            and str(getattr(e, "device_type", "")).endswith("CUDA")]
    rows.sort(key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in rows) / 1e3
    print(f"[profile] bf16 forward bs{batch}: wall {wall_ms:.3f} ms (under "
          f"the profiler), device busy {busy_ms:.3f} ms, idle share "
          f"{max(0.0, 1 - busy_ms / wall_ms):.4f}")
    for e in rows[:12]:
        print(f"[profile]   {dev_us(e) / 1e3:9.3f} ms  x{e.count:<4d} "
              f"{e.key[:90]}")
    os.makedirs(OUT_DIR, exist_ok=True)
    prof.export_chrome_trace(os.path.join(OUT_DIR, "forward_trace.json"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="build,kernels,forward,timing")
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
    except Exception as e:                      # report and fail the run
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"[total] {time.perf_counter() - t_start:.1f} s")
    if totals is not None:
        kernels = []
        for name, src, repl, extra in (
                ("dwconv", "slak_tpu_torch/ops/csrc/dwconv.cu",
                 "slak_tpu/ops/pallas_banded.py:168", {}),
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
                times_per="one bf16 forward at batch %d" % MAIN_BATCH,
                launches_in="the main path: %d bf16 forwards at batch %d"
                % (N_BATCHES, MAIN_BATCH)))
        print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
