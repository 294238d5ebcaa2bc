"""The port's copies of the JAX package's host modules, held against the
originals on the same inputs, compared exactly: the scan and its counts, the
split (both allocators), the balancing plan and task list, the split
summary, the metrics, the confusion JSON, the batch-results writers, the
host pool's worker count, the decode sequence with the native decoder gated
on and off, the full-size decode, the transform config's YAML load, the
contour helpers, the drawing primitives, the artifact signature, and the
loader's data-parallel sharding (`items_for_process`,
`global_steps_per_epoch`, `BatchIterator(pad_to_steps=,
drop_remainder=)`) over decoded stores."""

import json
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from leaffliction_tpu.cli import predict as jcli  # noqa: E402
from leaffliction_tpu.cli.split import write_summary as j_write_summary  # noqa: E402
from leaffliction_tpu.core import sysinfo as jsys  # noqa: E402
from leaffliction_tpu.data import balancer as jbal  # noqa: E402
from leaffliction_tpu.data import fused_balance as jfb  # noqa: E402
from leaffliction_tpu.data import loader as jloader  # noqa: E402
from leaffliction_tpu.data import native as jnative  # noqa: E402
from leaffliction_tpu.data import scan as jscan  # noqa: E402
from leaffliction_tpu.data import split as jsplit  # noqa: E402
from leaffliction_tpu.utils import confusion as jconf  # noqa: E402
from leaffliction_tpu.utils import metrics as jmetrics  # noqa: E402
from leaffliction_tpu.segment import config as jsegcfg  # noqa: E402
from leaffliction_tpu.segment import contours as jcontours  # noqa: E402
from leaffliction_tpu.utils import draw as jdraw  # noqa: E402
from leaffliction_tpu.utils import signature as jsig  # noqa: E402
from leaffliction_tpu_torch.cli import predict as tcli  # noqa: E402
from leaffliction_tpu_torch.cli.split import write_summary  # noqa: E402
from leaffliction_tpu_torch.core import sysinfo as tsys  # noqa: E402
from leaffliction_tpu_torch.data import balancer as tbal  # noqa: E402
from leaffliction_tpu_torch.data import fused_balance as tfb  # noqa: E402
from leaffliction_tpu_torch.data import loader as tloader  # noqa: E402
from leaffliction_tpu_torch.data import native as tnative  # noqa: E402
from leaffliction_tpu_torch.data import scan as tscan  # noqa: E402
from leaffliction_tpu_torch.data import split as tsplit  # noqa: E402
from leaffliction_tpu_torch.utils import confusion as tconf  # noqa: E402
from leaffliction_tpu_torch.utils import metrics as tmetrics  # noqa: E402
from leaffliction_tpu_torch.segment import config as tsegcfg  # noqa: E402
from leaffliction_tpu_torch.segment import contours as tcontours  # noqa: E402
from leaffliction_tpu_torch.utils import draw as tdraw  # noqa: E402
from leaffliction_tpu_torch.utils import signature as tsig  # noqa: E402
import jax_native  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    """The JAX side decodes through its JPEG helper loaded whole, or
    both sides through PIL (`tests/jax_native.py`)."""
    jax_native.ready()


def _json(items):
    return [it.to_json() for it in items]


def test_scan_and_counts_match(tiny_dataset):
    j, t = jscan.scan_dataset(tiny_dataset), tscan.scan_dataset(tiny_dataset)
    assert len(t) == 37 and _json(t) == _json(j)
    assert tscan.count_by_label(t) == jscan.count_by_label(j)
    assert tscan.count_by_plant_class(t) == jscan.count_by_plant_class(j)


@pytest.mark.parametrize("ratio,seed", [(0.2, 32), (0.35, 7), (0.5, 1)])
def test_split_matches(tiny_dataset, ratio, seed):
    j, t = jscan.scan_dataset(tiny_dataset), tscan.scan_dataset(tiny_dataset)
    jg, tg = jsplit.group_by_label(j), tsplit.group_by_label(t)
    assert {k: _json(v) for k, v in tg.items()} == \
        {k: _json(v) for k, v in jg.items()}
    counts = {k: len(v) for k, v in tg.items()}
    counts["Lone__single"] = 1  # a singleton keeps its one image in train
    alloc = tsplit.allocate_validation_by_ratio(counts, ratio)
    assert alloc == jsplit.allocate_validation_by_ratio(counts, ratio)
    del alloc["Lone__single"]
    tmap = tsplit.build_split_map(tg, alloc, seed)
    assert tmap == jsplit.build_split_map(jg, alloc, seed)
    assert _json(tsplit.apply_split(t, tmap)) == \
        _json(jsplit.apply_split(j, tmap))


def test_split_summary_bytes_match(tiny_dataset, tmp_path):
    items = tscan.scan_dataset(tiny_dataset)
    grouped = tsplit.group_by_label(items)
    alloc = tsplit.allocate_validation_by_ratio(
        {k: len(v) for k, v in grouped.items()}, 0.25)
    items = tsplit.apply_split(items, tsplit.build_split_map(grouped, alloc,
                                                             3))
    write_summary(tmp_path / "t.csv", items)
    j_write_summary(tmp_path / "j.csv", items)
    assert (tmp_path / "t.csv").read_bytes() == \
        (tmp_path / "j.csv").read_bytes()


@pytest.mark.parametrize("min_total", [0, 1, 5, 14, 100])
def test_min_val_allocation_matches(min_total):
    counts = {"Apple__healthy": 12, "Apple__rust": 7, "Grape__spot": 4,
              "Lone__single": 1, "Pear__two": 2}
    assert tsplit.allocate_validation_counts(counts, min_total) == \
        jsplit.allocate_validation_counts(counts, min_total)
    with pytest.raises(ValueError):
        tsplit.allocate_validation_counts(counts, -1)


@pytest.mark.parametrize("cpus", [None, 1, 2, 3, 4, 5, 8, 96])
def test_worker_count_matches(monkeypatch, cpus):
    monkeypatch.setattr("os.cpu_count", lambda: cpus)
    assert tsys.get_optimal_worker_count() == jsys.get_optimal_worker_count()


PLAN_COUNTS = [
    {"Apple": {"healthy": 12, "rust": 7, "scab": 5},
     "Grape": {"healthy": 9, "spot": 4}},
    {"Apple": {"a": 220, "b": 200, "c": 200, "d": 195},
     "Grape": {"e": 190, "f": 185, "g": 180, "h": 160}},
    {"Solo": {"only": 3}},
]


@pytest.mark.parametrize("counts", PLAN_COUNTS)
def test_plan_matches(counts):
    assert tbal.TRANSFORMATIONS == jbal.TRANSFORMATIONS
    assert tbal.calculate_plan(counts) == jbal.calculate_plan(counts)


@pytest.mark.parametrize("seed", [0, 42])
def test_fused_tasks_match(tiny_dataset, tmp_path, seed):
    items = tscan.scan_dataset(tiny_dataset)
    plan = tbal.calculate_plan(tscan.count_by_plant_class(items))
    target = tmp_path / "augmented_directory"
    t = tfb.build_fused_tasks(items, plan, target, seed)
    j = jfb.build_fused_tasks(jscan.scan_dataset(tiny_dataset), plan, target,
                              seed)
    assert len(t) == sum(sum(v.values()) for v in plan.values()) > 0
    assert [(x.source_row, x.item.to_json(), x.transform, x.task_seed)
            for x in t] == \
        [(x.source_row, x.item.to_json(), x.transform, x.task_seed)
         for x in j]


@pytest.mark.parametrize("classes,seed", [(2, 0), (5, 1)])
def test_classification_metrics_match(classes, seed):
    rng = np.random.default_rng(seed)
    y_true = rng.integers(0, classes, 60).tolist()
    y_pred = rng.integers(0, classes, 60).tolist()
    labels = [f"c{i}" for i in range(classes)]
    assert tmetrics.compute_classification_metrics(y_true, y_pred, labels) \
        == jmetrics.compute_classification_metrics(y_true, y_pred, labels)


def test_confusion_json_bytes_match(tmp_path):
    rng = np.random.default_rng(3)
    y_true, y_pred = rng.integers(0, 4, 50), rng.integers(0, 4, 50)
    labels = ["Apple__a", "Apple__b", "Grape__c", "Grape__d"]
    t_json, _ = tconf.export_confusion(y_true, y_pred, labels, tmp_path / "t")
    j_json, _ = jconf.export_confusion(y_true, y_pred, labels, tmp_path / "j")
    assert t_json.name == j_json.name == "confusion_matrix.json"
    assert t_json.read_bytes() == j_json.read_bytes()


def _results(n):
    rng = np.random.default_rng(n)
    out = []
    for i in range(n):
        p = rng.dirichlet(np.ones(3))
        names = ["Apple__rust", "Apple__scab", "Grape__spot"]
        out.append({"image_path": Path(f"leaf{i}.JPG"),
                    "top_prediction": names[int(p.argmax())],
                    "confidence": float(p.max()),
                    "all_probabilities": dict(zip(names, map(float, p)))})
    return out


@pytest.mark.parametrize("n", [0, 1, 7])
def test_batch_results_writers_match(tmp_path, n):
    results = _results(n)
    assert tcli.create_batch_summary(results, 1.234) == \
        jcli.create_batch_summary(results, 1.234)
    t = tcli.save_batch_results_json(results, 1.234, tmp_path / "t.json")
    j = jcli.save_batch_results_json(results, 1.234, tmp_path / "j.json")
    assert t.read_bytes() == j.read_bytes()
    assert json.loads(t.read_text())["summary"]["total_images"] == n


def _decode_inputs(tiny_dataset, tmp_path):
    from PIL import Image

    paths = sorted(tiny_dataset.rglob("*.JPG"))[:6]
    png = tmp_path / "leaf.png"
    Image.open(paths[0]).save(png)
    bad = tmp_path / "broken.JPG"
    bad.write_bytes(b"not a jpeg")
    return paths + [png, bad]


@pytest.mark.parametrize("native", ["1", "0"])
def test_decode_sequence_bytes_match(tiny_dataset, tmp_path, monkeypatch,
                                     native):
    """The same pixels and the same failures as the JAX package, with the
    C++ decoder gated on (JPEGs through it, the .png through PIL) and off
    (everything through PIL); the broken file fails in both."""
    monkeypatch.setenv("LEAF_NATIVE_DECODE", native)
    paths = _decode_inputs(tiny_dataset, tmp_path)
    t_arr, t_ok = tnative.decode_batch_with_fallback(paths, 48,
                                                     log_failures=False)
    j_arr, j_ok = jnative.decode_batch_with_fallback(paths, 48,
                                                     log_failures=False)
    assert t_ok.tolist() == j_ok.tolist() == [True] * 7 + [False]
    np.testing.assert_array_equal(t_arr, j_arr)
    if native == "1":
        assert tnative.native_available() == jnative.native_available()


def test_decode_full_bytes_match(tiny_dataset, tmp_path):
    """The full-size decode of both native helpers, at a square and an odd
    size; a non-JPEG is refused by both."""
    from PIL import Image

    if not (tnative.native_available() and jnative.native_available()):
        pytest.skip("the native JPEG helper does not build here")
    odd = tmp_path / "odd.jpg"
    Image.fromarray(np.random.default_rng(1).integers(
        0, 255, (17, 203, 3)).astype(np.uint8)).save(odd, quality=90)
    for path in sorted(tiny_dataset.rglob("*.JPG"))[:3] + [odd]:
        got = tnative.decode_full(str(path))
        np.testing.assert_array_equal(got, jnative.decode_full(str(path)))
    assert got.shape == (17, 203, 3)
    png = tmp_path / "leaf.png"
    Image.fromarray(got).save(png)
    for native in (tnative, jnative):
        with pytest.raises(ValueError):
            native.decode_full(str(png))


def test_transform_config_load_matches(tmp_path):
    """The packaged YAMLs are byte-equal and load to the same fields; an
    edited file too; a missing field exits with 1 on both sides."""
    ours, ref = tsegcfg.default_config_path(), jsegcfg.default_config_path()
    assert ours.read_bytes() == ref.read_bytes()
    assert tsegcfg.load_config(ours).__dict__ == \
        jsegcfg.load_config(ref).__dict__
    edited = tmp_path / "edited.yaml"
    edited.write_text(ref.read_text().replace("mask_strategy: inclusive",
                                              "mask_strategy: kmeans")
                      .replace("shadow_suppression: false",
                               "shadow_suppression: true"))
    got = tsegcfg.load_config(edited).__dict__
    assert got == jsegcfg.load_config(edited).__dict__
    assert got["mask_strategy"] == "kmeans" and got["shadow_suppression"]
    broken = tmp_path / "broken.yaml"
    broken.write_text("gaussian_sigma: 1.5\n")
    for mod in (tsegcfg, jsegcfg):
        with pytest.raises(SystemExit) as exc:
            mod.load_config(broken)
        assert exc.value.code == 1


@pytest.mark.parametrize("seed", range(3))
def test_contour_helpers_match(seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:48, 0:56]
    mask = ((yy - 24) ** 2 / 300 + (xx - 28) ** 2 / 400) < 1
    mask |= rng.random((48, 56)) < 0.05
    ours = tcontours.largest_contour_points(mask)
    ref = jcontours.largest_contour_points(mask)
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(tcontours.trace_boundary(mask),
                                  jcontours.trace_boundary(mask))
    assert tcontours.contour_area(ours) == jcontours.contour_area(ref)
    assert tcontours.bounding_rect_np(ours) == jcontours.bounding_rect_np(ref)
    np.testing.assert_array_equal(tcontours.resample_contour(ours, 26),
                                  jcontours.resample_contour(ref, 26))
    assert tcontours.largest_contour_points(np.zeros((4, 4), bool)) is None


def test_draw_primitives_match():
    img = np.random.default_rng(4).integers(0, 256, (40, 50, 3), np.uint8)
    pts = np.array([[3, 4], [30, 8], [44, 30], [10, 35], [20, 20]])
    calls = [("polyline", (pts, (255, 0, 0)), {"width": 2}),
             ("circle", ((20, 15), 3, (0, 255, 0)), {}),
             ("circle", ((20, 15), 5, (0, 0, 255)), {"filled": False}),
             ("circles", (pts, 2, (9, 9, 9)), {}),
             ("line", ((1, 1), (40, 30), (255, 255, 0)), {"width": 2}),
             ("cross_marker", ((25, 20), 14, (255, 0, 255)), {}),
             ("text", ("Analyze: no object", (10, 24)), {}),
             ("rectangle", ((5, 6, 20, 15), (1, 2, 3)), {})]
    for name, args, kwargs in calls:
        np.testing.assert_array_equal(
            getattr(tdraw, name)(img, *args, **kwargs),
            getattr(jdraw, name)(img, *args, **kwargs), err_msg=name)
    np.testing.assert_array_equal(tdraw.convex_hull_points(pts),
                                  jdraw.convex_hull_points(pts))


def test_signature_matches(tmp_path, monkeypatch):
    """Both packages' `SignatureGenerator` write the same `signature.txt`
    (the SHA1 of the same zip) for the same `artifacts/` tree, and the
    port's runs as `python -m leaffliction_tpu_torch.utils.signature`."""
    import subprocess
    import sys

    monkeypatch.chdir(tmp_path)
    art = tmp_path / "artifacts"
    (art / "models").mkdir(parents=True)
    (art / "models" / "meta.json").write_text('{"a": 1}')
    (art / "datasets" / "deep").mkdir(parents=True)
    (art / "datasets" / "deep" / "x.bin").write_bytes(bytes(range(256)) * 9)
    digest = tsig.SignatureGenerator().generate()
    ours = (tmp_path / "signature.txt").read_bytes()
    assert jsig.SignatureGenerator().generate() == digest
    assert (tmp_path / "signature.txt").read_bytes() == ours
    assert ours == (digest + "\n").encode() and len(digest) == 40
    root = Path(__file__).resolve().parent.parent
    subprocess.run([sys.executable, "-m",
                    "leaffliction_tpu_torch.utils.signature"], cwd=tmp_path,
                   env={"PYTHONPATH": str(root), "PATH": "/usr/bin:/bin"},
                   check=True, capture_output=True, timeout=120)
    assert (tmp_path / "signature.txt").read_bytes() == ours
    with pytest.raises(FileNotFoundError):
        tsig.SignatureGenerator(artifacts_dir=tmp_path / "none").generate()


@pytest.mark.parametrize("n_proc", [2, 3])
@pytest.mark.parametrize("drop_remainder", [False, True])
def test_sharded_loader_matches(tiny_dataset, n_proc, drop_remainder):
    """Each rank's stride shard of the scanned tree, decoded into each
    package's ImageStore, streams the same padded batches (pixels, labels,
    masks, indices) for two shuffled epochs."""
    items = jscan.scan_dataset(tiny_dataset)
    label2idx = {lab: i for i, lab in
                 enumerate(sorted({it.label for it in items}))}
    steps = tloader.global_steps_per_epoch(len(items), 4, n_proc)
    assert steps == jloader.global_steps_per_epoch(len(items), 4, n_proc)
    for rank in range(n_proc):
        mine = tloader.items_for_process(items, rank, n_proc)
        assert mine == jloader.items_for_process(items, rank, n_proc)
        got, want = (
            mod.BatchIterator(mod.ImageStore(mine, label2idx, 16), 4,
                              shuffle=True, seed=5,
                              drop_remainder=drop_remainder,
                              pad_to_steps=steps)
            for mod in (tloader, jloader))
        assert got.steps_per_epoch() == want.steps_per_epoch() == steps
        for epoch in (0, 1):
            a, b = list(got.epoch(epoch)), list(want.epoch(epoch))
            assert len(a) == len(b) == steps
            for x, y in zip(a, b):
                for u, v in zip(x, y):
                    np.testing.assert_array_equal(u, v)
