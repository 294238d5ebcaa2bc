"""ctypes bindings for the native libjpeg decode/encode helper, and the one
decode sequence the port's batch consumers share.

Copy of `leaffliction_tpu/data/native/__init__.py`, cut to what the port
calls (the materialising balancer decodes its sources at full size with
`decode_full` and encodes with `encode` when `native_enabled()`). At first
use `build.sh` compiles `decoder.cpp` into
`build/native/libleafjpeg.so` at the root of the checkout (listed in
`.gitignore`) when a compiler and libjpeg's headers are present; without
them the helper is unavailable and PIL decodes, as in the JAX package.
"""

from __future__ import annotations

import concurrent.futures as cf
import ctypes
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from leaffliction_tpu_torch.core.logging import get_logger

LOGGER = get_logger(__name__)

_DIR = Path(__file__).parent
LIB_PATH = Path(__file__).resolve().parents[3] / "build" / "native" \
    / "libleafjpeg.so"
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    try:
        src = _DIR / "decoder.cpp"
        stale = (not LIB_PATH.exists()
                 or src.stat().st_mtime > LIB_PATH.stat().st_mtime)
        if stale:  # (re)build before dlopen — dlopen caches per process
            subprocess.run(["sh", str(_DIR / "build.sh"), str(LIB_PATH)],
                           check=True, capture_output=True, timeout=120)
        lib = ctypes.CDLL(str(LIB_PATH))
        lib.leaf_jpeg_dims.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.leaf_jpeg_dims.restype = ctypes.c_int
        lib.leaf_decode_jpeg_resize.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_void_p]
        lib.leaf_decode_jpeg_resize.restype = ctypes.c_int
        lib.leaf_decode_jpeg.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
            ctypes.c_size_t, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.leaf_decode_jpeg.restype = ctypes.c_int
        lib.leaf_encode_jpeg.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_size_t)]
        lib.leaf_encode_jpeg.restype = ctypes.c_int
        lib.leaf_decode_batch_resize.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        lib.leaf_decode_batch_resize.restype = ctypes.c_int
        _lib = lib
    except Exception as exc:
        LOGGER.warning("Native JPEG helper unavailable (%s); using PIL", exc)
        _load_failed = True
    return _lib


def native_available() -> bool:
    return _load() is not None


def native_enabled() -> bool:
    """The LEAF_NATIVE_DECODE gate (default on) and the helper built."""
    return os.environ.get("LEAF_NATIVE_DECODE", "1") != "0" \
        and native_available()


def decode_resize(path: str, target: int) -> np.ndarray:
    """Decode JPEG file → target×target×3 uint8 RGB (DCT-scaled + bilinear)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native decoder unavailable")
    data = Path(path).read_bytes()
    out = np.empty((target, target, 3), np.uint8)
    rc = lib.leaf_decode_jpeg_resize(
        data, len(data), target, out.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise ValueError(f"JPEG decode failed for {path} (rc={rc})")
    return out


def decode_full(path: str) -> np.ndarray:
    """Decode JPEG file at native size → H×W×3 uint8 RGB."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native decoder unavailable")
    data = Path(path).read_bytes()
    w = ctypes.c_int()
    h = ctypes.c_int()
    if lib.leaf_jpeg_dims(data, len(data), ctypes.byref(w),
                          ctypes.byref(h)) != 0:
        raise ValueError(f"Not a JPEG: {path}")
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.leaf_decode_jpeg(
        data, len(data), out.ctypes.data_as(ctypes.c_void_p), out.nbytes,
        ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise ValueError(f"JPEG decode failed for {path} (rc={rc})")
    return out


def encode(path: str, rgb: np.ndarray, quality: int = 95) -> None:
    """Encode uint8 RGB → JPEG file (reference save quality 95)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native encoder unavailable")
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    cap = rgb.nbytes + 65536
    out = np.empty((cap,), np.uint8)
    out_len = ctypes.c_size_t()
    rc = lib.leaf_encode_jpeg(
        rgb.ctypes.data_as(ctypes.c_void_p), w, h, quality,
        out.ctypes.data_as(ctypes.c_void_p), cap, ctypes.byref(out_len))
    if rc != 0:
        raise ValueError(f"JPEG encode failed (rc={rc})")
    Path(path).write_bytes(out[:out_len.value].tobytes())


def decode_batch_resize(paths, img_size: int, n_threads: int = 0) -> tuple:
    """Decode many JPEG files → (uint8 [n, S, S, 3], ok bool [n]) in ONE
    ctypes call on the library's own thread pool. Failed entries have
    ok=False and zeroed pixels; callers fall back per image."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native decoder unavailable")
    n = len(paths)
    out = np.zeros((n, img_size, img_size, 3), np.uint8)
    status = np.full((n,), -1, np.int32)
    if n == 0:
        return out, status == 0
    arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    lib.leaf_decode_batch_resize(
        arr, n, img_size, out.ctypes.data_as(ctypes.c_void_p),
        status.ctypes.data_as(ctypes.c_void_p), n_threads)
    return out, status == 0


def decode_batch_with_fallback(paths, img_size: int, workers: int = 8,
                               log_failures: bool = True) -> tuple:
    """→ (uint8 [n, S, S, 3], ok bool [n]): the decode sequence of the
    training loader, the predictor and the fused balancer. LEAF_NATIVE_DECODE
    gate (default on) → batched C++ decode → threaded per-image PIL decode
    of the failures (non-JPEG inputs, or no native library). Entries that
    fail both come back ok=False with zeroed pixels; callers decide whether
    to skip or error."""
    from leaffliction_tpu_torch.data.loader import decode_resize_pil

    n = len(paths)
    arrs = None
    if os.environ.get("LEAF_NATIVE_DECODE", "1") != "0":
        try:
            if native_available():
                arrs, ok = decode_batch_resize(paths, img_size)
        except Exception:  # pragma: no cover - toolchain missing
            arrs = None
    if arrs is None:
        arrs = np.zeros((n, img_size, img_size, 3), np.uint8)
        ok = np.zeros((n,), bool)

    def _load_one(i: int) -> None:
        try:
            arrs[i] = decode_resize_pil(str(paths[i]), img_size)
            ok[i] = True
        except Exception as exc:
            if log_failures:
                LOGGER.warning("Skipping unreadable image %s (%s)", paths[i],
                               exc)

    todo = np.nonzero(~ok)[0].tolist()
    if workers > 1 and len(todo) > 1:
        with cf.ThreadPoolExecutor(max_workers=workers) as pool:
            list(pool.map(_load_one, todo))
    else:
        for i in todo:
            _load_one(i)
    return arrs, ok


def decode_resize_native(path: str, img_size: int) -> np.ndarray:
    """Loader-compatible decode function (the signature of
    `decode_resize_pil`); a file libjpeg refuses (a .png) goes to PIL."""
    from leaffliction_tpu_torch.data.loader import decode_resize_pil

    try:
        return decode_resize(path, img_size)
    except Exception:
        return decode_resize_pil(path, img_size)
