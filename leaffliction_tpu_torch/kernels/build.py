"""Build the port's CUDA kernels with nvcc and load them with ctypes.

At first use, every `leaffliction_tpu_torch/csrc/*.cu` is compiled for
Hopper (`sm_90a`), one nvcc process per source, all started together:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -Xcompiler -fPIC -c -o build/kernels/<hash>/<name>.o csrc/<name>.cu

and the objects are linked into one shared library with a plain C interface,
`build/kernels/<hash>/libleaf_kernels.so`. `<hash>` covers the sources, the
shared headers (`csrc/*.cuh`) and the flags, so an edited source or header
rebuilds and an unchanged tree loads the library built before. `build/` sits
at the root of the checkout and is listed in `.gitignore`.

`-fmad=false` keeps every multiply and add separately rounded, as PyTorch's
eager elementwise ops are, so the stencil kernels agree bit for bit with their
plain twins.

Each launching C entry point takes device pointers, sizes, the device index
of its tensors and the CUDA stream (`current_stream`), launches on that
device (`csrc/device_guard.cuh`), and returns `cudaGetLastError()`; `check`
turns a non-zero value into an error.

Each kernel wrapper counts its launches in a dict of its own and registers
it here (`register_launches`), so a layer above reads and adjusts every
kernel's count (`launch_counts`, `add_launches`: a CUDA graph's capture
takes its recorded launches back, each replay adds them) without knowing
which kernels exist.
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
from typing import Dict, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# name -> argtypes of every C entry point (all return int, a cudaError_t)
SIGNATURES = {
    # rows, c, vec, device -> blocks (partials) of the BatchNorm sums
    "leaf_bn_blocks": [_I] * 4,
    # x, partials, rows, c, vec, bf16, blocks, device, stream
    "leaf_bn_stats": [_P] * 2 + [_I] * 6 + [_P],
    # partials, out0, out1, run_mean, run_var, blocks, c, count, momentum,
    # keep, moments, device, stream
    "leaf_bn_finalize": [_P] * 5 + [_I] * 2 + [_F] * 3 + [_I] * 2 + [_P],
    # x, y, mean, var, scale, bias, eps, rows, c, vec, bf16, relu, device,
    # stream
    "leaf_bn_apply": [_P] * 6 + [_F] + [_I] * 6 + [_P],
    # x, dy, partials, mean, var, scale, bias, eps, rows, c, vec, bf16, relu,
    # blocks, device, stream
    "leaf_bn_grad_reduce": [_P] * 7 + [_F] + [_I] * 7 + [_P],
    # x, dy, dx, mean, var, scale, bias, sums, eps, count, rows, c, vec, bf16,
    # relu, device, stream
    "leaf_bn_dx": [_P] * 8 + [_F] * 2 + [_I] * 6 + [_P],
    # n, h, w, c, vec, device -> blocks an image (partials) of the exit's
    # backward
    "leaf_exit_blocks": [_I] * 6,
    # y, sc, se, keep, out, code, inv, n, h, w, c, oh, ow, k, s, pad_h,
    # pad_w, relu, vec, bf16, device, stream
    "leaf_exit_forward": [_P] * 6 + [_F] + [_I] * 14 + [_P],
    # gout, code, y, sc, se, keep, dy, dsc, partials, inv, n, h, w, c, oh,
    # ow, k, s, pad_h, pad_w, relu, vec, bf16, blocks, device, stream
    "leaf_exit_backward": [_P] * 9 + [_F] + [_I] * 15 + [_P],
    # partials, out, n, blocks, c, bf16, device, stream
    "leaf_exit_finalize": [_P] * 2 + [_I] * 5 + [_P],
    # h, w -> shared-memory bytes of the fast kernel, 0 = global kernel
    "leaf_cc_propagate_smem_bytes": [_I] * 2,
    # lab, mask, out, scratch, rounds, n, h, w, limit, device, stream
    "leaf_cc_propagate": [_P] * 5 + [_I] * 5 + [_P],
    # taps (f32 [5] on the host) -> 0
    "leaf_edge_taps": [_P],
    # h, w -> output tiles (blocks) per image
    "leaf_edge_nms_tiles": [_I] * 2,
    # gray, out, n, h, w, l2, device, stream
    "leaf_edge_nms": [_P] * 2 + [_I] * 5 + [_P],
    # angles, ctrl, n, device, stream
    "leaf_rotation_controls": [_P, _P, _I, _I, _P],
    # h, w, c -> shared-memory bytes of K1's single launch, 0 = multi-pass
    "leaf_train_aug_smem_bytes": [_I] * 3,
    # n, h, w, c, out_bf16 -> blocks per image of that launch, 0 = multi-pass
    "leaf_train_aug_blocks_per_image": [_I] * 5,
    # in, angles, factors, scratch, out, in_u8, out_bf16, n, h, w, c, device,
    # stream
    "leaf_train_aug": [_P] * 5 + [_I] * 7 + [_P],
    # h, w, oh, ow -> shared-memory bytes of K2's single launch, 0 = multi-pass
    "leaf_rotate_expand_smem_bytes": [_I] * 4,
    # n, h, w, oh, ow -> blocks per image of that launch, 0 = multi-pass
    "leaf_rotate_expand_blocks_per_image": [_I] * 5,
    # in, angles, scratch, out, n, h, w, oh, ow, device, stream
    "leaf_rotate_expand": [_P] * 4 + [_I] * 6 + [_P],
    # shears, ctrl, n, device, stream
    "leaf_shear_controls": [_P, _P, _I, _I, _P],
    # h, w -> shared-memory bytes of K3's one-line band, 0 = simple kernel
    "leaf_shear_cubic_smem_bytes": [_I] * 2,
    # n, h, w -> blocks per image (bands of lines), 0 = simple kernel
    "leaf_shear_cubic_blocks_per_image": [_I] * 3,
    # in, shears, horizontal, out, n, h, w, device, stream
    "leaf_shear_cubic": [_P] * 4 + [_I] * 4 + [_P],
    # h, w -> shared-memory bytes of a K6 cluster block, 0 = simple kernel
    "leaf_distortion_smem_bytes": [_I] * 2,
    # n, h, w -> blocks per image (the cluster size), 0 = simple kernel
    "leaf_distortion_blocks_per_image": [_I] * 3,
    # in, seeds, cutoffs, out, n, h, w, device, stream
    "leaf_distortion": [_P] * 4 + [_I] * 4 + [_P],
}

# counter name -> (the dict that holds it, its key there)
_launch_counters: Dict[str, Tuple[Dict[str, int], str]] = {}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_blocks: Dict[tuple, int] = {}  # (query, *args) -> blocks; `blocks`
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
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / source_hash() / "libleaf_kernels.so"


def _run(procs: list) -> str:
    """Wait for every (cmd, Popen); raise on the first failure."""
    logs = []
    failed = None
    try:
        for cmd, proc in procs:
            stdout, stderr = proc.communicate(timeout=900)
            logs.append(stdout + stderr)
            if proc.returncode != 0 and failed is None:
                failed = (cmd, proc.returncode, stdout + stderr)
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed is not None:
        cmd, rc, log = failed
        raise RuntimeError(f"nvcc failed (rc={rc}):\n{' '.join(cmd)}\n{log}")
    return "".join(logs)


def _start(cmd: list) -> tuple:
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)


def _compile(out: Path) -> None:
    global build_log, build_seconds
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs = [out.parent / f"{src.stem}.{tag}.o" for src in _sources()]
    log = _run([_start([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)])
                for src, obj in zip(_sources(), objs)])
    tmp = out.with_suffix(f".{tag}")
    log += _run([_start([nvcc, "-shared", "-o", str(tmp),
                         *map(str, objs)])])
    build_seconds = time.perf_counter() - t0
    build_log = log
    for obj in objs:
        obj.unlink()
    os.replace(tmp, out)


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; thread-safe, cached."""
    global _lib
    if _lib is not None:
        return _lib
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


def current_stream(device: int) -> int:
    """The handle of PyTorch's current CUDA stream on device index `device`,
    which the C entry points launch on: PyTorch's own raw-handle query (the
    one its compiled kernels use), without building a Stream object as
    `torch.cuda.current_stream(device).cuda_stream` does (`chip_smoke.py`
    phase 12 times it among the wrapper's pieces)."""
    return torch._C._cuda_getCurrentRawStream(device)


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError_t {rc})")


def blocks(query: str, *args: int) -> int:
    """`query(*args)` of the library, a kernel's count of partial-sum
    blocks for a shape, asked once for each `args` and remembered; a
    negative answer is a CUDA error, raised."""
    key = (query, *args)
    n = _blocks.get(key)
    if n is None:
        n = getattr(load(), query)(*args)
        if n <= 0:
            check(-n, query)
        _blocks[key] = n
    return n


def register_launches(name: str, counts: Dict[str, int],
                      key: str = "launches") -> None:
    """Make `counts[key]`, a kernel wrapper's launch count, one of
    `launch_counts()` under `name`."""
    _launch_counters[name] = (counts, key)


def launch_counts() -> Dict[str, int]:
    """Every registered kernel's launches so far, by counter name."""
    return {name: d[k] for name, (d, k) in _launch_counters.items()}


def add_launches(launches: Dict[str, int]) -> None:
    """Add `launches` (counter name -> count) to the registered counters."""
    for name, n in launches.items():
        d, k = _launch_counters[name]
        d[k] += n
