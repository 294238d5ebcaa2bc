"""`tests/jax_native.ready`, the one way the port's tests reach the JAX
package's JPEG helper.

Six processes start at once on an empty build directory; each calls
`ready` there and decodes the same JPEG through the JAX package's
`decode_batch_with_fallback`. Each must exit cleanly with the helper
loaded from the directory's `jax/libleafjpeg.so` (never the JAX package's
in-place `libleafjpeg.so`) and the same bytes as the others: no process
may load a file another one is still writing. The processes are
separate, so a truncated library would kill one of them, not this worker.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

PROCESSES = 6

CHILD = r"""
import hashlib, json, sys, time
from pathlib import Path

import jax_native
from leaffliction_tpu.data import native as jnative

build, jpeg, me = Path(sys.argv[1]), sys.argv[2], sys.argv[3]
(build.parent / f"waiting.{me}").touch()
while not (build.parent / "go").exists():
    time.sleep(0.005)
native = jax_native.ready(build)
arr, ok = jnative.decode_batch_with_fallback([jpeg], 48, log_failures=False)
print(json.dumps({
    "native": native, "loaded": jnative._lib is not None,
    "path": str(jnative._LIB_PATH),
    "in_place": str(jnative._DIR / "libleafjpeg.so"),
    "ok": ok.tolist(), "sha": hashlib.sha256(arr.tobytes()).hexdigest()}))
"""


def test_concurrent_first_loads_open_a_whole_library(tmp_path):
    from PIL import Image

    import jax_native

    jpeg = tmp_path / "leaf.jpg"
    Image.fromarray(np.random.default_rng(0).integers(
        0, 255, (64, 80, 3)).astype(np.uint8)).save(jpeg, quality=90)
    build = tmp_path / "build" / "native"
    build.mkdir(parents=True)
    tests = Path(__file__).resolve().parent
    env = {**os.environ, "LEAF_NATIVE_DECODE": "1",
           "PYTHONPATH": os.pathsep.join([str(tests.parent), str(tests)])}
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD, str(build), str(jpeg), str(i)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(PROCESSES)]
    deadline = time.monotonic() + 120
    while len(list(tmp_path.glob("build/waiting.*"))) < PROCESSES:
        assert time.monotonic() < deadline and all(
            p.poll() is None for p in procs), "a process did not start"
        time.sleep(0.01)
    (tmp_path / "build" / "go").touch()
    results = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, (p.returncode, err[-2000:])
        results.append(json.loads(out.strip().splitlines()[-1]))
    want = str(jax_native.library(build))
    for r in results:
        assert r["native"] and r["loaded"] and r["ok"] == [True], r
        assert r["path"] == want != r["in_place"], r
    assert len({r["sha"] for r in results}) == 1
    assert sorted(p.name for p in (build / "jax").iterdir()) == [
        "libleafjpeg.so"]
