"""ctypes binding of the host-side data kernels (``hemdata.cpp``).

The library is built from the checkout's source with the system C++
compiler at first use, into ``build/native/`` of the checkout, once per
source content (its hash names the file); a build that fails raises.
Concurrent first uses (test workers, loader processes) each build under a
name of their own and move the result into place atomically.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().with_name("hemdata.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"


def _compiler() -> str:
    for cc in ("c++", "g++", "clang++"):
        found = shutil.which(cc)
        if found:
            return found
    raise RuntimeError("no C++ compiler found: the native data kernels cannot be built")


def build() -> Path:
    """Compile ``hemdata.cpp`` (once per source content); the library's path."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"libhemdata_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_compiler(), "-O3", "-shared", "-fPIC", str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"building {SOURCE.name} failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


# image dtype -> (the gray kernel's entry point, its element type)
_GRAY = {np.dtype(np.uint8): ("normalize_gray_u8", ctypes.c_uint8),
         np.dtype(np.float32): ("normalize_gray_f32", ctypes.c_float),
         np.dtype(np.float64): ("normalize_gray_f64", ctypes.c_double)}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    lib = ctypes.CDLL(str(build()))
    dp, fp = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_float)
    lib.homography_flow_f32.argtypes = [dp, ctypes.c_int, ctypes.c_int, ctypes.c_double, fp]
    lib.homography_flow_f32.restype = None
    for name, ctype in _GRAY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(ctype), ctypes.c_int, ctypes.c_int, dp, dp, fp]
        fn.restype = None
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def homography_to_flow(H, h: int, w: int, eps: float = 1e-6) -> np.ndarray:
    """flow(x) = H(x) - x in float64, float32 out: (h, w, 2)."""
    Hc = np.ascontiguousarray(np.asarray(H, np.float64).reshape(9))
    out = np.empty((h, w, 2), np.float32)
    library().homography_flow_f32(_ptr(Hc, ctypes.c_double), int(h), int(w), float(eps),
                                  _ptr(out, ctypes.c_float))
    return out


def normalize_gray(img, mean, std) -> np.ndarray:
    """(h, w, 3) image -> (h, w, 1) float32 mean over channels of
    (img - mean) / std in float64.  uint8, float32 and float64 images are
    read as they are; any other dtype is converted to float64 first."""
    img = np.asarray(img)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected an (h, w, 3) image, got {img.shape}")
    if img.dtype not in _GRAY:
        img = img.astype(np.float64)
    fn, ctype = _GRAY[img.dtype]
    img = np.ascontiguousarray(img)
    m = np.ascontiguousarray(np.asarray(mean, np.float64).reshape(3))
    s = np.ascontiguousarray(np.asarray(std, np.float64).reshape(3))
    h, w = img.shape[:2]
    out = np.empty((h, w, 1), np.float32)
    getattr(library(), fn)(_ptr(img, ctype), h, w, _ptr(m, ctypes.c_double),
                           _ptr(s, ctypes.c_double), _ptr(out, ctypes.c_float))
    return out
