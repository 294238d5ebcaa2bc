"""`prefetch_to_device` on the port's streamed train path
(`leaffliction_tpu_torch/train/trainer.py`), on the CPU.

It yields what the JAX package's `prefetch_to_device` yields for the same
host batches, single and chained, in the same order. `fit` and `evaluate`
on the streamed path (pixels uploaded by it) are bit-equal to the gather
path (a device-resident dataset) from the same state and seed: one step a
dispatch and three, with `skip_steps`, in one process and on two gloo
ranks (`tests/torch_dp_worker.py`, each rank its rows of the same global
batches). The pinned ring, its side stream and events run only on the
card (`tests/test_torch_gpu.py`).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch_dp_worker  # noqa: E402
from leaffliction_tpu.parallel.mesh import make_mesh as jax_mesh  # noqa: E402
from leaffliction_tpu.train import trainer as jax_trainer  # noqa: E402
from leaffliction_tpu_torch.data.loader import Batch  # noqa: E402
from leaffliction_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from leaffliction_tpu_torch.train import trainer  # noqa: E402

torch.set_num_threads(1)


def _host_batches(n=5, b=4, size=8, seed=0):
    rng = np.random.default_rng(seed)
    return [Batch(images=rng.integers(0, 256, (b, size, size, 3), np.uint8),
                  labels=rng.integers(0, 3, b).astype(np.int32),
                  mask=(rng.random(b) < 0.8).astype(np.float32),
                  indices=rng.integers(0, 99, b).astype(np.int32))
            for _ in range(n)]


@pytest.mark.parametrize("lookahead", [1, 2, 4])
@pytest.mark.parametrize("k", [1, 3])
def test_yields_what_the_jax_prefetch_yields(lookahead, k):
    """The same batches, in the same order, field for field (JAX's
    device arrays read back), chunked by `chain_batches` (k = 3 gives one
    chunk and two single batches)."""
    host = _host_batches()
    ours = list(trainer.prefetch_to_device(
        trainer.chain_batches(iter(host), k), torch.device("cpu"),
        lookahead))
    ref = list(jax_trainer.prefetch_to_device(
        jax_trainer.chain_batches(iter(host), k),
        jax_mesh(devices=jax.devices()[:1]), lookahead))
    assert len(ours) == len(ref) == (5 if k == 1 else 3)
    for got, want in zip(ours, ref):
        assert got.images.dtype == torch.uint8
        assert got.labels.dtype == torch.int64
        assert got.mask.dtype == torch.float32
        for field in ("images", "labels", "mask"):
            np.testing.assert_array_equal(getattr(got, field).numpy(),
                                          np.asarray(getattr(want, field)))
        np.testing.assert_array_equal(got.indices, want.indices)


def test_takes_a_mesh_and_passes_its_rows_through():
    """A `Mesh` names the device; a rank's own rows (`local_batch`) go
    through unchanged."""
    mesh = make_mesh(None, torch.device("cpu"))
    host = _host_batches(2)
    got = list(trainer.prefetch_to_device(iter(host), mesh))
    assert [g.images.device.type for g in got] == ["cpu", "cpu"]
    np.testing.assert_array_equal(got[1].images.numpy(), host[1].images)


def test_is_lazy():
    """Nothing is drawn from the stream before the first batch is asked
    for, and at most `lookahead` batches beyond it after."""
    drawn = []

    def stream():
        for b in _host_batches(6):
            drawn.append(b)
            yield b

    it = trainer.prefetch_to_device(stream(), torch.device("cpu"), 2)
    assert drawn == []
    next(it)
    assert len(drawn) <= 3


def _assert_same(run):
    got, want = run["streamed"], run["gather"]
    assert got["steps"] == want["steps"] > 0
    assert got["prefetched"] > 0 and want["prefetched"] == 0
    assert got["state"].keys() == want["state"].keys()
    for key in want["state"]:
        assert torch.equal(got["state"][key], want["state"][key]), key
    assert got["history"] == want["history"]
    assert torch.equal(got["generator"], want["generator"])
    assert got["variant"] == want["variant"]
    assert got["eval"][:2] == want["eval"][:2]
    for a, b in zip(got["eval"][2:], want["eval"][2:]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k,skip", [(1, 0), (3, 0), (1, 2), (3, 2)])
def test_fit_streamed_equals_gather(k, skip):
    """One process: `fit` and `evaluate` over the prefetched batches
    against the device-resident gather, bit for bit."""
    run = torch_dp_worker.streamed_against_gather(k=k, skip_steps=skip)
    assert run["gather"]["steps"] == 12 - skip
    _assert_same(run)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("prefetch_ranks")
    runs = [(1, 0), (3, 0), (3, 2)]
    return runs, torch_dp_worker.launch(
        {"dir": str(d), "scenarios": [["prefetch", {"kind": "prefetch",
                                                    "runs": runs}]]})


@pytest.mark.parametrize("rank", [0, 1])
def test_fit_streamed_equals_gather_on_two_ranks(two_ranks, rank):
    """Two gloo ranks, each streaming its rows of the global batches:
    every run bit-equal to the gather path on this rank, and the two
    ranks' states equal."""
    runs, results = two_ranks
    mine = results["prefetch"][rank]
    for k, skip in runs:
        run = mine[f"k{k}_skip{skip}"]
        assert run["gather"]["steps"] == 12 - skip
        _assert_same(run)
        other = results["prefetch"][1 - rank][f"k{k}_skip{skip}"]
        for key, v in run["streamed"]["state"].items():
            assert torch.equal(v, other["streamed"]["state"][key]), key
