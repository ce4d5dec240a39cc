"""ctypes binding of the native host library ``native/slak_host.cpp``:
port of ``slak_tpu/data/native.py``.

The source stays where it is and is only read; the port builds its own
copy once per checkout into the git-ignored ``slak_tpu_torch/_build/``
with the JAX package's flags (``g++ -O3 -march=native -shared -fPIC``,
so both libraries round alike). Without a compiler, or with
``SLAK_NO_NATIVE`` set, :func:`get_lib` returns None and the transforms
take the PIL path, as ``slak_tpu``'s do.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SRC = os.path.join(_ROOT, "native", "slak_host.cpp")
SO = os.path.join(_ROOT, "slak_tpu_torch", "_build", "libslak_host.so")


def _build() -> Optional[str]:
    """The library's path, built when missing or older than its source
    (into a temporary name, then renamed, so that concurrent builders
    never load a half-written file); None when g++ fails."""
    if not os.path.exists(SRC):
        return None
    if os.path.exists(SO) and os.path.getmtime(SO) >= os.path.getmtime(SRC):
        return SO
    os.makedirs(os.path.dirname(SO), exist_ok=True)
    tmp = f"{SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-o", tmp,
           SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return None
    os.replace(tmp, SO)
    return SO


def get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        if os.environ.get("SLAK_NO_NATIVE"):
            return None
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.slak_rrc_normalize.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            f32p, ctypes.c_int, ctypes.c_int, f32p, f32p]
        lib.slak_rrc_normalize.restype = None
        lib.slak_center_crop_normalize.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int, f32p,
            ctypes.c_int, ctypes.c_int, f32p, f32p]
        lib.slak_center_crop_normalize.restype = None
        lib.slak_host_version.restype = ctypes.c_int
        _LIB = lib
        return _LIB


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _up(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _check_image(img: np.ndarray) -> np.ndarray:
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"want a uint8 (H, W, 3) image, got {img.dtype} "
                         f"{img.shape}")
    return img


def rrc_normalize(img: np.ndarray, crop, size: int, hflip: bool,
                  mean: np.ndarray, std: np.ndarray) -> Optional[np.ndarray]:
    """Crop ``crop`` = (left, top, w, h) of a uint8 (H, W, 3) image,
    bicubic-resize it to size^2, flip it when ``hflip``, normalize: float32
    (size, size, 3); None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    img = _check_image(img)
    left, top, cw, ch = (int(c) for c in crop)
    if not (0 <= left and 0 <= top and 0 < cw and 0 < ch
            and left + cw <= img.shape[1] and top + ch <= img.shape[0]):
        raise ValueError(f"crop {crop} outside a {img.shape[:2]} image")
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    out = np.empty((size, size, 3), np.float32)
    lib.slak_rrc_normalize(_up(img), img.shape[0], img.shape[1], left, top,
                           cw, ch, _fp(out), size, int(hflip), _fp(mean),
                           _fp(std))
    return out


def center_crop_normalize(img: np.ndarray, size: int, scale_size: int,
                          mean: np.ndarray, std: np.ndarray
                          ) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    img = _check_image(img)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    out = np.empty((size, size, 3), np.float32)
    lib.slak_center_crop_normalize(_up(img), img.shape[0], img.shape[1],
                                   _fp(out), size, scale_size, _fp(mean),
                                   _fp(std))
    return out
