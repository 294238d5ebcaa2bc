"""Build the port's CUDA kernels with nvcc and load them with ctypes.

At first use, every `leaffliction_tpu_torch/csrc/*.cu` is compiled into one
shared library with a plain C interface, for Hopper (`sm_90a`):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -shared -Xcompiler -fPIC -o build/kernels/<hash>/libleaf_kernels.so

`<hash>` covers the sources and the flags, so an edited source rebuilds and an
unchanged one loads the library built before. `build/` sits at the root of the
checkout and is listed in `.gitignore`.

`-fmad=false` keeps every multiply and add separately rounded, as PyTorch's
eager elementwise ops are, so the stencil kernels agree bit for bit with their
plain twins.

Each C entry point takes device pointers, sizes and the CUDA stream, launches,
and returns `cudaGetLastError()`; `check` turns a non-zero value into an error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# name -> argtypes of every C entry point (all return int, a cudaError_t)
SIGNATURES = {
    # lab, mask, seg_f0, seg_b0, seg_f1, seg_b1, grown, rows, out,
    # n, h, w, label_bits, stream
    "leaf_cc_round": [_P] * 9 + [_I] * 4 + [_P],
    # gray, blur, mag, sector, out, n, h, w, l2, g0..g4, stream
    "leaf_edge_nms": [_P] * 5 + [_I] * 4 + [_F] * 5 + [_P],
    # in, ctrl, factors, scratch_a, scratch_b, mean, out,
    # in_u8, contrast, out_bf16, n, h, w, c, stream
    "leaf_train_aug": [_P] * 7 + [_I] * 7 + [_P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_log = ""        # nvcc's output (ptxas register/shared-memory report)
build_seconds = 0.0   # wall time of the last compile; 0.0 when cached


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the port's "
            "CUDA kernels are built from source at first use")
    return str(path)


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / source_hash() / "libleaf_kernels.so"


def _compile(out: Path) -> None:
    global build_log, build_seconds
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (rc={proc.returncode}):\n{' '.join(cmd)}\n"
            f"{build_log}")
    os.replace(tmp, out)


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; thread-safe, cached."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            _compile(path)
        lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError_t {rc})")
