"""The port's mesh, sharding helpers and serving mesh, against the JAX package.

In one process, no process group:

- `parallel.mesh.MeshSpec.resolve` against the JAX `MeshSpec` over a grid of
  shapes and device counts, the "does not cover" errors included, word for
  word;
- the loader's data-parallel copies, `items_for_process`,
  `global_steps_per_epoch` and `BatchIterator(pad_to_steps=,
  drop_remainder=)`, against the JAX functions exactly, for every rank of
  N ∈ {5, 37, 208} items over P ∈ {1…4} processes at B ∈ {4, 32};
- `local_rows` and `check_replicated` of one rank;
- the backend rule (`parallel.distributed.backend_for`) and the rank's
  device from torchrun's environment;
- the serving mesh: `Predictor(devices=["cpu"] * N)` for N = 2, 4, 8
  against the one-device predictor, at `tests/test_serving_mesh.py`'s rtol
  1e-5 / atol 1e-6 (a slice of a chunk runs the same per-image math), and
  against the JAX `Predictor` on an 8-device mesh of conftest's virtual CPU
  devices, with the same weights: top-1 equal, probabilities at the same
  rtol 1e-5 / atol 1e-6 (read: 6e-8, as between the two single-device
  predictors; the mesh moves neither side); the predict CLI's
  `--mesh-data 2` on the CPU writes the single-device run's results;
- the serving mesh's errors: a data axis that does not divide
  SERVING_BATCH, a multi-process launch, and `--mesh-data` beyond the
  visible CUDA devices (the JAX CLI's "does not cover").
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from leaffliction_tpu.data import loader as jax_loader  # noqa: E402
from leaffliction_tpu.parallel.mesh import MeshSpec as JaxMeshSpec  # noqa: E402
from leaffliction_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from leaffliction_tpu.predict.predictor import Predictor as JaxPredictor  # noqa: E402
from leaffliction_tpu_torch.cli import predict as torch_cli  # noqa: E402
from leaffliction_tpu_torch.data import loader  # noqa: E402
from leaffliction_tpu_torch.parallel import distributed  # noqa: E402
from leaffliction_tpu_torch.parallel.mesh import (  # noqa: E402
    MeshSpec,
    check_replicated,
    local_rows,
    make_mesh,
)
from leaffliction_tpu_torch.predict.predictor import (  # noqa: E402
    SERVING_BATCH,
    Predictor,
)
from test_torch_predict import LABELS, SIZE, _write_artifacts  # noqa: E402

torch.set_num_threads(1)

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                "MASTER_ADDR", "MASTER_PORT")


@pytest.fixture(autouse=True)
def _no_torchrun_env(monkeypatch):
    for k in TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)


def _resolve(spec_cls, data, model, n):
    try:
        got = spec_cls(data=data, model=model).resolve(n)
        return (got.data, got.model)
    except ValueError as exc:
        return str(exc)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("data,model", [(-1, 1), (1, 1), (2, 1), (4, 1),
                                        (8, 1), (-1, 2), (2, 2), (4, 2),
                                        (3, 0)])
def test_mesh_spec_resolves_as_jax(data, model, n):
    assert _resolve(MeshSpec, data, model, n) == \
        _resolve(JaxMeshSpec, data, model, n)


class _Store:
    """An ImageStore-shaped array store (both packages' iterators take it);
    every fifth item failed to decode, so shards differ by more than one
    row of valid items."""

    def __init__(self, items, img_size=2, host_pixels=True):
        self.items = list(items)
        n = len(self.items)
        self.img_size = img_size
        self.images = np.arange(n * img_size * img_size * 3, dtype=np.int64
                                ).reshape(n, img_size, img_size, 3
                                          ).astype(np.uint8)
        self.labels = (np.asarray(self.items, np.int32) * 7) % 5
        self.valid = np.asarray(self.items) % 5 != 4
        self.host_pixels = host_pixels

    @property
    def valid_indices(self):
        return np.nonzero(self.valid)[0].astype(np.int32)


def _epochs(mod, store, bs, steps, drop_remainder):
    it = mod.BatchIterator(store, bs, shuffle=True, seed=3,
                           drop_remainder=drop_remainder,
                           pad_to_steps=steps)
    out = [it.steps_per_epoch()]
    for epoch in (0, 1):
        out += [tuple(np.asarray(a).tolist() for a in b)
                for b in it.epoch(epoch)]
    return out


@pytest.mark.parametrize("n", [5, 37, 208])
@pytest.mark.parametrize("bs", [4, 32])
def test_sharded_loader_matches_jax(n, bs):
    items = list(range(n))
    for p in (1, 2, 3, 4):
        steps = loader.global_steps_per_epoch(n, bs, p)
        assert steps == jax_loader.global_steps_per_epoch(n, bs, p)
        shards = []
        for r in range(p):
            mine = loader.items_for_process(items, r, p)
            assert mine == jax_loader.items_for_process(items, r, p)
            shards += mine
            for host_pixels in (True, False):
                for drop, pad in ((False, steps), (True, steps),
                                  (False, None), (True, None)):
                    args = (bs, pad, drop)
                    assert _epochs(loader, _Store(mine, 2, host_pixels),
                                   *args) == _epochs(
                        jax_loader, _Store(mine, 2, host_pixels), *args)
        assert sorted(shards) == items


def test_loader_defaults_read_torchrun_env(monkeypatch):
    items = list(range(9))
    assert loader.items_for_process(items) == items
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "3")
    assert loader.items_for_process(items) == [1, 4, 7]
    assert loader.global_steps_per_epoch(9, 2) == 2


def test_local_rows_and_check_replicated_of_one_rank():
    assert [local_rows(8, r, 2) for r in (0, 1)] == [slice(0, 4),
                                                    slice(4, 8)]
    assert local_rows(6, 2, 3) == slice(4, 6)
    with pytest.raises(ValueError, match="not divisible"):
        local_rows(6, 0, 4)
    mesh = make_mesh(MeshSpec(), "cpu")
    assert (mesh.data, mesh.model, mesh.rank, mesh.group) == (1, 1, 0, None)
    a = torch.arange(6, dtype=torch.bfloat16)
    assert check_replicated(a, mesh) == check_replicated(a.clone(), mesh)
    assert check_replicated(a, mesh) != check_replicated(a.float(), mesh)
    with pytest.raises(ValueError, match="does not cover 1 devices"):
        make_mesh(MeshSpec(data=2), "cpu")
    # a model axis over one process does not cover it either
    with pytest.raises(ValueError, match="mesh 1x2 does not cover 1 "
                                         "devices"):
        make_mesh(MeshSpec(data=1, model=2), "cpu")


@pytest.mark.parametrize("env,name,backend,device", [
    ({}, "cpu", "gloo", "cpu"),
    ({}, "cuda", "nccl", "cuda"),
    ({"WORLD_SIZE": "2", "LOCAL_RANK": "1"}, "cuda", "nccl", "cuda:1"),
    ({"WORLD_SIZE": "2", "LOCAL_RANK": "1"}, "cpu", "gloo", "cpu"),
    # two ranks of a host pinned to one card: NCCL refuses, gloo it is
    ({"WORLD_SIZE": "2", "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2"},
     "cuda:0", "gloo", "cuda:0"),
    # one rank a host (two hosts), each pinned to its cuda:0
    ({"WORLD_SIZE": "2", "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1"},
     "cuda:0", "nccl", "cuda:0"),
])
def test_backend_and_rank_device_rule(monkeypatch, env, name, backend,
                                      device):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert distributed.backend_for(name) == backend
    assert distributed.rank_device(name) == torch.device(device)


def test_maybe_initialize_needs_torchruns_environment(monkeypatch):
    assert distributed.maybe_initialize("cpu") is None  # one process
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert distributed.maybe_initialize("cpu") is None
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="RANK, MASTER_ADDR, MASTER_PORT"):
        distributed.maybe_initialize("cpu")


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    learn = _write_artifacts(tmp_path_factory.mktemp("learn"), False)
    arrays = np.random.default_rng(4).integers(0, 256, (70, SIZE, SIZE, 3),
                                               dtype=np.uint8)
    single = Predictor(learn, device="cpu").load()._probs_for_arrays(arrays)
    return learn, arrays, single


@pytest.mark.parametrize("n", [2, 4, 8])
def test_serving_mesh_matches_one_device(served, n):
    learn, arrays, single = served
    pred = Predictor(learn, devices=["cpu"] * n).load()
    assert len(pred.devices) == n
    got = pred._probs_for_arrays(arrays)
    assert got.shape == (70, len(LABELS))
    np.testing.assert_allclose(got, single, rtol=1e-5, atol=1e-6)


def test_serving_mesh_matches_jax_mesh(served):
    learn, arrays, _ = served
    mesh = jax_make_mesh(JaxMeshSpec(data=8, model=1),
                         devices=jax.devices()[:8])
    ref = JaxPredictor(learn, mesh=mesh).load()._probs_for_arrays(arrays)
    got = Predictor(learn, devices=["cpu"] * 8).load()._probs_for_arrays(
        arrays)
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_serving_mesh_errors(served, monkeypatch):
    learn, _, _ = served
    with pytest.raises(ValueError, match=f"serving batch {SERVING_BATCH} "
                       r"not divisible by the mesh data axis \(3\)"):
        Predictor(learn, devices=["cpu"] * 3)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="mesh serving is single-process"):
        Predictor(learn, devices=["cpu"] * 2)
    monkeypatch.delenv("WORLD_SIZE")
    # more devices than CUDA shows: the JAX CLI's make_mesh error
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="mesh 2x1 does not cover 1 "
                                         "devices"):
        torch_cli.serving_mesh(2, torch.device("cuda"))
    assert torch_cli.serving_mesh(-1, torch.device("cuda")) == [
        torch.device("cuda", 0)]


def test_predict_cli_mesh_writes_the_single_device_results(
        served, tmp_path, monkeypatch):
    from PIL import Image

    learn, arrays, _ = served
    images = tmp_path / "images"
    images.mkdir()
    for i, a in enumerate(arrays[:6]):
        Image.fromarray(a).save(images / f"leaf{i}.png")
    monkeypatch.chdir(tmp_path)
    rows = {}
    for n in ("1", "2"):
        out = tmp_path / f"results_{n}.json"
        torch_cli.main([str(images), "--batch-mode", "--device", "cpu",
                        "--mesh-data", n, "-learnings", str(learn),
                        "-json", str(out), "-out", str(tmp_path / "out")])
        rows[n] = json.loads(out.read_text())["batch_results"]
    assert len(rows["2"]) == 6
    assert [r["top_prediction"] for r in rows["2"]] == \
        [r["top_prediction"] for r in rows["1"]]
    for a, b in zip(rows["2"], rows["1"]):
        np.testing.assert_allclose(
            [a["all_probabilities"][k] for k in LABELS],
            [b["all_probabilities"][k] for k in LABELS], rtol=1e-5,
            atol=1e-6)
