"""Build and load the port's hand-written CUDA kernels.

The sources in ``textflux_torch/csrc/`` compile with ``nvcc`` for sm_90a
(Hopper) into one shared library with a plain C interface, under ``build/`` at
the repository root, on first use. The library name carries a hash of the
sources, so an edited source never loads a stale build. It is loaded with
ctypes; nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(set CUDA_HOME or put nvcc on PATH)")


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libtextflux_kernels_{digest.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> tuple[Path, float]:
    """Compile the kernels if this source hash has no library yet. Returns
    (library path, seconds spent compiling; 0.0 when it was already built).
    Writes to a temporary name and renames, so a concurrent or interrupted
    build never leaves a half-written library behind."""
    out = library_path()
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, *map(str, _sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    if verbose:
        print(proc.stdout + proc.stderr, flush=True)
    os.replace(tmp, out)
    return out, seconds


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every entry
    point's argument and result types declared."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    fn = lib.textflux_fused_norm_rope_attention
    fn.argtypes = [ptr] * 10 + [i32] * 5 + [i64] * 6 + [f32, f32, ptr]
    fn.restype = i32
    return lib
