"""CUDA-event timing shared by the port's probes (``tools/probe_*.py``).

:func:`time_ms` is ``chip_smoke.py``'s ``time_ms`` with fresh inputs: CUDA
events around ``reps`` back-to-back calls (host launch overhead hides
behind queued work), the median of ``rounds``, and ``refresh()`` called
outside the timed window before each round to draw new input values.
:func:`build_variants` builds a kernel source with text edits (the
ablation probes' variants).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import statistics
import subprocess
from typing import Callable, Dict, List, Optional, Tuple

import torch

# H100 SXM: HBM3 bytes/s, dense bf16 and fp32 (no TF32) FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


def require_cuda(name: str) -> torch.device:
    """The card, with TF32 off for cuDNN and matmul; raises without one."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"{name} runs on a CUDA card and none is present")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def device_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return (r.stdout.strip().splitlines()[0] if r.returncode == 0
            else torch.cuda.get_device_name(0))


def time_ms(fn: Callable[[], object],
            refresh: Optional[Callable[[], object]] = None, reps: int = 10,
            warmup: int = 2, rounds: int = 5) -> float:
    """Device ms a call of ``fn``: the median over ``rounds`` of CUDA
    events around ``reps`` calls, ``refresh()`` before each round."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(rounds):
        if refresh is not None:
            refresh()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float, dtype: torch.dtype):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over the
    HBM rate and the operations over the dtype's peak."""
    b = nbytes / PEAK_BYTES_PER_S * 1e3
    o = flops / PEAK_FLOPS[dtype] * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


def conv_macs(n: int, c: int, h: int, w: int, kh: int, kw: int) -> int:
    """MACs a same-padded depthwise conv needs, taps that only see padding
    skipped."""
    def span(length, k):
        p = k // 2
        return sum(min(k, length + p - i) - max(0, p - i)
                   for i in range(length))
    return n * c * span(h, kh) * span(w, kw)


def build_variants(name: str, variants: Dict[str, List[Tuple[str, str]]],
                   logs: Optional[Dict[str, str]] = None
                   ) -> Dict[str, ctypes.CDLL]:
    """``ops/csrc/<name>.cu`` with each variant's (text, replacement) edits
    (each text must be in the source or in one of the headers under
    ``csrc/``, which are searched in that order), each built with nvcc into
    its own library under ``slak_tpu_torch/_build/probe/``, all at once:
    {variant: its loaded library}. A variant's edited source and headers
    go into a directory of its own, where its includes find them first.
    With ``logs`` (a dict), each build also reports ptxas's registers and
    spills, kept there under the variant's name."""
    from slak_tpu_torch.ops import _build

    def read(f):
        with open(os.path.join(_build.CSRC, f)) as fh:
            return fh.read()
    cu = f"{name}.cu"
    sources = [cu] + sorted(f for f in os.listdir(_build.CSRC)
                            if f.endswith(".cuh"))
    out_dir = os.path.join(_build.BUILD_DIR, "probe")
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for variant, edits in variants.items():
        files = {cu: read(cu)}
        for old, new in edits:
            where = next((f for f in sources
                          if old in files.get(f, "") or
                          (f not in files and old in read(f))), None)
            if where is None:
                raise RuntimeError(f"{variant}: pattern not found: {old!r}")
            files[where] = files.get(where, read(where)).replace(old, new)
        vdir = os.path.join(out_dir, f"{name}_{variant}")
        shutil.rmtree(vdir, ignore_errors=True)
        os.makedirs(vdir)
        for f, text in files.items():
            with open(os.path.join(vdir, f), "w") as fh:
                fh.write(text)
        so = os.path.join(out_dir, f"lib{name}_{variant}.so")
        procs.append((variant, so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS,
             *(["-Xptxas", "-v"] if logs is not None else []),
             f"-I{_build.CSRC}", "-o", so, os.path.join(vdir, cu)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for variant, so, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"{variant}: nvcc failed\n{log}")
        if logs is not None:
            logs[variant] = log
        libs[variant] = ctypes.CDLL(so)
    return libs
