"""Build and load the port's hand-written CUDA kernels.

The sources in ``textflux_torch/csrc/`` compile with ``nvcc`` for sm_90a
(Hopper), one ``nvcc`` process per ``.cu`` file, all started together, and
link into one shared library with a plain C interface, under ``build/`` at
the repository root, on first use. The library name carries a hash of the
sources and headers, so an edited source never loads a stale build. It is
loaded with ctypes; nothing here runs at import time.
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

from textflux_torch.utils.tracking import span

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _hashed_files():
    return sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")])


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
    for src in _hashed_files():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libtextflux_kernels_{digest.hexdigest()[:16]}.so"


def build() -> tuple[Path, float, str]:
    """Compile the kernels if this source hash has no library yet. Returns
    (library path, seconds spent compiling and linking (0.0 when it was
    already built), the compilers' output). ptxas reports each kernel's
    registers, shared memory and spills into that output (-Xptxas -v), which
    is kept beside the library (same name, ``.log``) and read back when the
    library was already built ("" if that file is gone). Each source
    compiles in its own nvcc process, all at once; the objects, the log and
    the library go to temporary names first, so a concurrent or interrupted
    build never leaves a half-written library. Runs as the span
    ``cuda.build`` (attributes ``compiled``, ``seconds``)."""
    with span("cuda.build") as s:
        out, seconds, text = _build()
        s.set(compiled=seconds > 0.0, seconds=seconds)
    return out, seconds, text


def _build() -> tuple[Path, float, str]:
    out = library_path()
    log_path = out.with_suffix(".log")
    if out.exists():
        return out, 0.0, log_path.read_text() if log_path.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs, procs = [], []
        for src in _sources():
            obj = os.path.join(tmpdir, src.stem + ".o")
            objs.append(obj)
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", obj, str(src)]
            procs.append((src.name, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                     stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for name, proc in procs:
            text, _ = proc.communicate()
            logs.append(f"--- {name}\n{text}")
            if proc.returncode != 0:
                failed.append(name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        lib = os.path.join(tmpdir, out.name)
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}\n{link.stderr}")
        text = "\n".join(logs)
        tmp_log = os.path.join(tmpdir, log_path.name)
        Path(tmp_log).write_text(text)
        os.replace(tmp_log, log_path)
        os.replace(lib, out)
    return out, time.perf_counter() - t0, text


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every entry
    point's argument and result types declared."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    signatures = {
        "textflux_fused_norm_rope_attention": ([ptr] * 10 + [i32] * 5 + [i64] * 6
                                               + [f32, f32, ptr, ptr]),
        "textflux_norm_rope_prep": [ptr] * 8 + [i32] * 4 + [i64] * 4 + [f32, f32, ptr],
        "textflux_flash_fwd": [ptr] * 5 + [i32] * 5 + [i64] * 6 + [f32, ptr],
        "textflux_flash_lse": [ptr] * 3 + [i32] * 5 + [i64] * 4 + [f32, ptr],
        "textflux_flash_dq": [ptr] * 7 + [i32] * 5 + [i64] * 8 + [f32, f32, ptr],
        "textflux_flash_dkv": [ptr] * 8 + [i32] * 5 + [i64] * 8 + [f32, f32, ptr],
        "textflux_w8a16_gemm": [ptr] * 5 + [i32] * 5 + [ptr],
        "textflux_adaln_modulate": [ptr] * 4 + [i32] * 3 + [i64] * 4 + [f32, ptr],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = i32
    return lib
