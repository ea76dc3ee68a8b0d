"""ctypes bindings for the native C++ data-path kernels.

The port of ``textflux_tpu/data/native.py`` over the port's own copy of the
source, ``textflux_torch/native/textflux_native.cpp``. It is compiled with
``g++ -O3 -shared -fPIC`` on first use into ``build/`` at the repository
root, under a name that carries a hash of the source, so an edited source
never loads a stale library. The JAX module falls back to cv2 when there is
no g++; the port has no such path: without g++ the first call raises (the
GPU machine has g++, which nvcc needs, and is not known to have cv2).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent.parent / "native" / "textflux_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libtextflux_native_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if this source hash has none yet. It is written
    to a temporary name first, so a concurrent or interrupted build never
    leaves a half-written library."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        tmp = Path(tmpdir) / out.name
        proc = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SRC.name} ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        tmp.replace(out)
    return out


@functools.lru_cache(maxsize=None)
def get_lib() -> ctypes.CDLL:
    """Build (if needed) and load the library, with the argument types of
    every entry point declared."""
    lib = ctypes.CDLL(str(build()))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.fill_poly.argtypes = [u8p, ctypes.c_int, ctypes.c_int, f32p,
                              ctypes.c_int, ctypes.c_uint8]
    lib.dilate3x3.argtypes = [u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.erode3x3.argtypes = [u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.normalize_pm1.argtypes = [u8p, f32p, ctypes.c_int64]
    lib.normalize_01.argtypes = [u8p, f32p, ctypes.c_int64]
    for name in ("fill_poly", "dilate3x3", "erode3x3", "normalize_pm1", "normalize_01"):
        getattr(lib, name).restype = None
    return lib


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _check_mask(mask: np.ndarray) -> None:
    if mask.dtype != np.uint8 or mask.ndim != 2 or not mask.flags.c_contiguous:
        raise ValueError(f"expected a C-contiguous (H, W) uint8 mask, got {mask.dtype} "
                         f"{mask.shape}")


def fill_poly(mask: np.ndarray, polygon: np.ndarray, value: int = 255) -> np.ndarray:
    """In-place polygon fill on a (H, W) uint8 mask; polygon (N, 2) of (x, y)."""
    _check_mask(mask)
    pts = np.ascontiguousarray(polygon, np.float32)
    get_lib().fill_poly(_u8(mask), mask.shape[0], mask.shape[1], _f32(pts), len(pts), value)
    return mask


def _morph(mask: np.ndarray, iterations: int, fn: str) -> np.ndarray:
    # a copy: the C kernel writes in place, and the caller's mask must stay
    # as it was (ascontiguousarray alone aliases a contiguous input)
    out = np.ascontiguousarray(mask).copy()
    _check_mask(out)
    getattr(get_lib(), fn)(_u8(out), out.shape[0], out.shape[1], iterations)
    return out


def dilate(mask: np.ndarray, iterations: int = 1) -> np.ndarray:
    """3x3 max filter, `iterations` passes (cv2.dilate's border rule)."""
    return _morph(mask, iterations, "dilate3x3")


def erode(mask: np.ndarray, iterations: int = 1) -> np.ndarray:
    """3x3 min filter, `iterations` passes (cv2.erode's border rule)."""
    return _morph(mask, iterations, "erode3x3")


def normalize_pm1(img: np.ndarray) -> np.ndarray:
    """uint8 -> float32 in [-1, 1]."""
    src = np.ascontiguousarray(img, np.uint8)
    out = np.empty(src.shape, np.float32)
    get_lib().normalize_pm1(_u8(src), _f32(out), src.size)
    return out


def normalize_01(img: np.ndarray) -> np.ndarray:
    """uint8 -> float32 in [0, 1]."""
    src = np.ascontiguousarray(img, np.uint8)
    out = np.empty(src.shape, np.float32)
    get_lib().normalize_01(_u8(src), _f32(out), src.size)
    return out
