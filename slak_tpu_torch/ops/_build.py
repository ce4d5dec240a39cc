"""Build the CUDA kernels under ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``slak_tpu_torch/_build/lib<name>.so`` (git-ignored) on first use:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/lib<name>.so csrc/<name>.cu

A library is rebuilt when its source, or a header under ``csrc/``, is
newer. A failed build raises; there is no fallback to the plain PyTorch
versions.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, List, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "ops", "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
KERNELS = ("dwconv", "mlp", "dwconv_wgrad", "mlp_bwd", "dwpair",
           "dwconv_stacked", "dwconv_f32", "dwconv2d")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card (set NVCC to its path)")


def source_path(name: str) -> str:
    return os.path.join(CSRC, f"{name}.cu")


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    so = library_path(name)
    if not os.path.exists(so):
        return True
    headers = [os.path.join(CSRC, f) for f in os.listdir(CSRC)
               if f.endswith(".cuh")]
    return os.path.getmtime(so) < max(os.path.getmtime(f) for f in
                                      [source_path(name), *headers])


def build(names: Iterable[str] = KERNELS, ptxas_verbose: bool = False
          ) -> Dict[str, Tuple[float, str]]:
    """Compile every stale library in ``names``, one nvcc per source, all
    started together. Returns {name: (seconds, compiler output)}."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    extra = ["-Xptxas", "-v"] if ptxas_verbose else []
    procs: List[Tuple[str, str, subprocess.Popen, float]] = []
    for name in names:
        if not _stale(name):
            continue
        tmp = library_path(name) + f".{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-o", tmp, source_path(name)]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), time.perf_counter()))
    out: Dict[str, Tuple[float, str]] = {}
    failed = []
    for name, tmp, proc, t0 in procs:
        log, _ = proc.communicate()
        out[name] = (time.perf_counter() - t0, log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            if _stale(name):
                build((name,))
            lib = ctypes.CDLL(library_path(name))
            _LIBS[name] = lib
        return lib
