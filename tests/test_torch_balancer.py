"""The JPEG-materialising balancer (`data/balancer.DatasetBalancer`) and its
host-pool backend (`data/host_augment.py`) against the JAX package on the
CPU.

On a two-plant tree (56² and 48×56 sources, two deficient classes) the
port's task list (sources, output names, transforms, task seeds) equals
JAX's; the tree's names and per-class counts and `manifest_augmented.json`
(but for `augmented_at`) equal JAX's. With JAX's draws handed in
(`tests/jax_draws.py`), each generated array, taken before its encode, is
within its op's bar of JAX's `BATCH_KERNELS` output for the same (transform,
shape) group, cropped as JAX crops it: flip exact; skew, shear, crop and
distortion ≤ 1 LSB; rotate ≤ 2 after the canvas crop, with the same cropped
shape (`tests/test_torch_fused_balance.py`'s BARS); no more than 0.2% of a
row's values differ by more than 1. With the port's own draws the arrays
do not depend on the chunk size (1 or 64). Under LEAF_STRICT_DISTORTION=1
the host backend's arrays equal the device backend's byte for byte (both
on the CPU here). The host pool's parameters are the device path's draws;
a broken process pool reruns the tasks on threads; a real spawn pool
writes the device backend's file names with the same rotate sizes. A
mixed-extreme-size tree balances through the augment CLI; the default
device raises without CUDA.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax_draws import jax_params, jax_task_keys  # noqa: E402
from leaffliction_tpu.data import balancer as jb  # noqa: E402
from leaffliction_tpu.ops import augment as ja  # noqa: E402
from leaffliction_tpu_torch.data import balancer as tb  # noqa: E402
from leaffliction_tpu_torch.data import host_augment as th  # noqa: E402
from leaffliction_tpu_torch.data.native import decode_full  # noqa: E402
from leaffliction_tpu_torch.ops import augment as ta  # noqa: E402
import jax_native  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    """The JAX side decodes through its JPEG helper loaded whole, or
    both sides through PIL (`tests/jax_native.py`)."""
    jax_native.ready()


torch.set_num_threads(1)

SEED = 42
BARS = {"flip": 0, "skew": 1, "shear": 1, "crop": 1, "distortion": 1,
        "rotate": 2}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    from PIL import Image

    from conftest import _leafish_image

    root = tmp_path_factory.mktemp("tree")
    rng = np.random.default_rng(9)
    spec = {"Apple": ({"a_heal": 14, "a_rust": 5}, 56),
            "Grape": ({"g_spot": 10, "g_blight": 3}, 48)}
    for plant, (classes, h) in spec.items():
        for cls, n in classes.items():
            d = root / plant / cls
            d.mkdir(parents=True)
            for i in range(n):
                Image.fromarray(_leafish_image(rng, 56)[:h]).save(
                    d / f"img{i}.jpg", quality=92)
    return root


def _jax_draw(transform, tasks, hw, device):
    return jax_params(transform, jax_task_keys(SEED, [t.task_seed
                                                      for t in tasks]), hw)


def _task_key(t):
    return (str(t.source_img), str(t.output_path), t.transform, t.task_seed)


def _tasks(balancer):
    balancer.analyze_distribution()
    balancer.calculate_plan()
    balancer._prepare_target_directory()
    return balancer._build_tasks()


def _key(path):
    """class/name of an output: unique in these trees."""
    return "/".join(path.parts[-2:])


def _listing(target):
    return sorted(p.relative_to(target).as_posix()
                  for p in target.rglob("*.jpg"))


def _port(tree, out, name, **kw):
    """A port run on the CPU → (balancer, {output name: array})."""
    arrays = {}
    bal = tb.DatasetBalancer(
        tree, out / "augmented", seed=SEED, manifest_out_dir=out / name,
        device="cpu", on_array=lambda t, a: arrays.__setitem__(
            _key(t.output_path), np.array(a)), **kw)
    bal.run()
    return bal, arrays


@pytest.fixture(scope="module")
def both(tree, tmp_path_factory):
    """JAX's run, then the port's with JAX's draws, into one target."""
    out = tmp_path_factory.mktemp("both")
    target = out / "augmented"
    ref = jb.DatasetBalancer(tree, target, seed=SEED,
                             manifest_out_dir=out / "jax")
    ref_tasks = _tasks(ref)
    ref.run()
    ref_listing = _listing(target)
    got, arrays = _port(tree, out, "port", draw=_jax_draw)
    got_tasks = _tasks(tb.DatasetBalancer(tree, out / "scratch", seed=SEED,
                                          device="cpu"))
    return ref_tasks, ref_listing, got, arrays, got_tasks, out


def test_task_list_identical(both):
    ref_tasks, *_, got_tasks, out = both
    assert len(ref_tasks) == (14 - 5) + (10 - 3)
    scratch = str(out / "scratch")
    assert [_task_key(t) for t in got_tasks] == [
        tuple(v.replace(str(out / "augmented"), scratch)
              if isinstance(v, str) else v for v in _task_key(t))
        for t in ref_tasks]


def test_tree_names_counts_and_manifest_equal_jax(both):
    _, ref_listing, got, arrays, _, out = both
    assert _listing(out / "augmented") == ref_listing
    assert len(arrays) == got.stages["generated"] == 16
    assert got.stages["failed"] == 0
    from leaffliction_tpu_torch.data.scan import (
        count_by_plant_class,
        scan_dataset,
    )

    assert count_by_plant_class(scan_dataset(out / "augmented")) == {
        "Apple": {"a_heal": 14, "a_rust": 14},
        "Grape": {"g_blight": 10, "g_spot": 10}}

    def manifest(name):
        data = json.loads((out / name / "manifest_augmented.json")
                          .read_text())
        data["meta"].pop("augmented_at")
        return data

    assert manifest("port") == manifest("jax")


def _jax_reference(tasks):
    """JAX's arrays for `tasks`: per (transform, shape) group, in task
    order, the JAX op on the fold_in keys, rotate canvases cropped."""
    groups = {}
    for t in tasks:
        arr = decode_full(str(t.source_img))
        groups.setdefault((t.transform, arr.shape), []).append((t, arr))
    out = {}
    for (transform, shape), group in groups.items():
        keys = jax_task_keys(SEED, [t.task_seed for t, _ in group])
        imgs = np.stack([a for _, a in group])
        res = ja.BATCH_KERNELS[transform](keys, imgs)
        if transform == "rotate":
            canvas, angles = (np.asarray(r) for r in res)
            for j, (t, _) in enumerate(group):
                out[_key(t.output_path)] = tb.crop_canvas(
                    canvas[j], float(angles[j]), shape[0], shape[1])
        else:
            for j, (t, _) in enumerate(group):
                out[_key(t.output_path)] = np.asarray(res[j])
    return out


def test_pixels_within_each_ops_bar_with_jax_draws(both):
    ref_tasks, _, _, arrays, _, _ = both
    ref = _jax_reference(ref_tasks)
    assert set(ref) == set(arrays)
    seen = set()
    for t in ref_tasks:
        a = ref[_key(t.output_path)].astype(np.int64)
        b = arrays[_key(t.output_path)].astype(np.int64)
        assert b.shape == a.shape, (t.output_path, b.shape, a.shape)
        d = np.abs(a - b)
        assert d.max() <= BARS[t.transform], (t.output_path, d.max())
        assert (d > 1).mean() <= 0.002, t.output_path
        seen.add((t.transform, a.shape[0] == a.shape[1]))
    assert {op for op, _ in seen} == set(BARS)


def test_own_draws_independent_of_the_chunk_size(tree, tmp_path,
                                                 monkeypatch):
    _, default = _port(tree, tmp_path, "a")
    monkeypatch.setattr(tb, "DEVICE_BATCH", 1)
    _, one = _port(tree, tmp_path, "b")
    assert set(one) == set(default) and len(one) == 16
    for k, v in default.items():
        np.testing.assert_array_equal(one[k], v)


def test_strict_host_arrays_equal_the_device_backends(tree, tmp_path,
                                                      monkeypatch):
    monkeypatch.setenv("LEAF_STRICT_DISTORTION", "1")
    bal, arrays = _port(tree, tmp_path, "strict")
    tasks = _tasks(tb.DatasetBalancer(tree, tmp_path / "again", seed=SEED,
                                      device="cpu"))
    dist = [t for t in tasks if t.transform == "distortion"]
    assert dist
    params = th.draw_params_batch(SEED, [t.transform for t in dist],
                                  [t.task_seed for t in dist])
    for t, p in zip(dist, params):
        host = th.host_task_array(str(t.source_img), p, t.task_seed, SEED)
        dev = arrays[_key(t.output_path)]
        assert host.dtype == dev.dtype == np.uint8
        np.testing.assert_array_equal(host, dev)


@pytest.mark.parametrize("hw", [(56, 56), (48, 56)])
def test_host_params_are_the_device_draws(hw):
    seeds = [7, 123, 999_983, 42]
    cpu = torch.device("cpu")
    for transform in tb.TRANSFORMATIONS:
        params = th.draw_params_batch(SEED, [transform] * 4, seeds)
        rngs = [tb.task_rng(SEED, s) for s in seeds]
        want = ta.DRAWS[transform](rngs, hw, cpu)
        for i, p in enumerate(params):
            assert p.transform == transform
            if transform == "flip":
                assert p.flip_horizontal == bool(want["horizontal"][i])
            elif transform == "rotate":
                assert p.angle_deg == float(want["angles"][i])
            elif transform == "skew":
                assert p.skew_s == float(want["s"][i])
            elif transform == "shear":
                assert p.shear_s == float(want["s"][i])
                assert p.shear_horizontal == bool(want["horizontal"][i])
            elif transform == "crop":
                assert p.crop_ratio == float(want["ratio"][i])
                left, top = ta.crop_corner(
                    torch.tensor([p.crop_ratio]),
                    torch.tensor([p.crop_u_left]),
                    torch.tensor([p.crop_u_top]), hw)
                assert (float(left[0]), float(top[0])) == (
                    float(want["left"][i]), float(want["top"][i]))
            else:
                assert p.cutoff == float(want["cutoffs"][i])


def _aug_tasks(tmp_path, transforms):
    from PIL import Image

    rng = np.random.default_rng(3)
    src = tmp_path / "img.jpg"
    Image.fromarray(rng.integers(0, 255, (40, 48, 3)).astype(np.uint8)
                    ).save(src, quality=95)
    return [tb.AugTask(source_img=src, output_path=tmp_path / f"o{i}.jpg",
                       transform=t, task_seed=100 + i)
            for i, t in enumerate(transforms)]


def test_execute_tasks_host_survives_broken_pool(tmp_path, monkeypatch):
    """A pool whose workers die at start-up (an unimportable __main__)
    reruns the tasks on threads."""
    import concurrent.futures as cf

    class _BrokenPool:
        def __init__(self, *a, **k):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def map(self, *a, **k):
            raise cf.process.BrokenProcessPool("worker died at startup")

    tasks = _aug_tasks(tmp_path, ["flip", "rotate", "distortion"])
    monkeypatch.setattr(cf, "ProcessPoolExecutor", _BrokenPool)
    assert th.execute_tasks_host(tasks, root_seed=SEED, workers=2) == (3, 0)
    assert all(t.output_path.exists() for t in tasks)


def test_host_backend_writes_the_device_backends_names(tree, tmp_path,
                                                       monkeypatch):
    """A real spawn pool of two workers, through the balancer: the same
    files as the device backend, each rotate of the same size."""
    from PIL import Image

    from leaffliction_tpu_torch.core import sysinfo

    _, arrays = _port(tree, tmp_path, "dev")
    device_listing = _listing(tmp_path / "augmented")
    monkeypatch.setattr(sysinfo, "get_optimal_worker_count", lambda: 2)
    monkeypatch.setenv("LEAF_BALANCE_BACKEND", "host")
    bal = tb.DatasetBalancer(tree, tmp_path / "augmented", seed=SEED,
                             manifest_out_dir=tmp_path / "host",
                             device="cpu")
    stages = bal.run()
    assert (stages["generated"], stages["failed"]) == (16, 0)
    assert _listing(tmp_path / "augmented") == device_listing
    rotated = 0
    for path in (tmp_path / "augmented").rglob("*_aug_rotate_*.jpg"):
        with Image.open(path) as im:
            assert (im.height, im.width) == arrays[_key(path)].shape[:2]
        rotated += 1
    assert rotated > 0


@pytest.mark.parametrize("value,want", [("host", "host"),
                                        ("device", "device"),
                                        ("auto", "device"),
                                        ("relay", "device")])
def test_resolve_backend(monkeypatch, value, want):
    monkeypatch.setenv("LEAF_BALANCE_BACKEND", value)
    assert th.resolve_backend() == want


def test_balancer_mixed_extreme_sizes(tmp_path, monkeypatch):
    """A class mixing square, 16x200 and 200x16 sources balances through
    the augment CLI: each (transform, shape) group and its rotate canvas."""
    from PIL import Image

    from leaffliction_tpu_torch.cli import augment as aug_cli
    from leaffliction_tpu_torch.data.scan import (
        count_by_plant_class,
        scan_dataset,
    )

    rng = np.random.default_rng(3)
    sizes = [(40, 40), (16, 200), (200, 16), (40, 40), (64, 48)]
    for cls, n in {"a": 5, "b": 2}.items():
        d = tmp_path / "tree" / "Plant" / cls
        d.mkdir(parents=True)
        for i in range(n):
            h, w = sizes[i % len(sizes)]
            Image.fromarray(
                rng.integers(0, 255, (h, w, 3)).astype(np.uint8)
            ).save(d / f"i{i}.jpg")

    monkeypatch.chdir(tmp_path)
    target = tmp_path / "balanced"
    aug_cli.main([str(tmp_path / "tree"), "--output", str(target),
                  "--device", "cpu"])
    counts = count_by_plant_class(scan_dataset(target))
    assert counts["Plant"] == {"a": 5, "b": 5}
    assert (tmp_path / "artifacts/distribution/balanced_distribution.csv"
            ).exists()


def test_default_device_needs_cuda(tree, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tb.DatasetBalancer(tree, tmp_path / "augmented")
