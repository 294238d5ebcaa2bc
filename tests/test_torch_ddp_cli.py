"""The train CLI on two CPU ranks (gloo), through its normal entry point.

Two worker processes (`tests/torch_dp_worker.py`, each killed if it outlives
its timeout) run `cli.train.main` in turn on these scenarios, the process
group joined once:

- the multi-host scenario of `tools/multihost_smoke.py`: 5 train items
  over 2 ranks (3 and 2, stride-sharded), leafcnn-tiny, 1 epoch: both
  ranks take `global_steps_per_epoch` steps, rank 0 alone writes the
  artifacts, and `meta.json` records the mesh {"data": 2, "model": 1} and
  the gloo backend;
- `--balance-from` on conftest's tree at 4 images per rank, f32, against
  one process at 8 (this process), 2 epochs: every rank balances the same
  tree, the four fused tensors pass `check_replicated` (equal digests on
  both ranks), rank 0 alone writes the manifests and the artifacts. Two
  ranks sum BatchNorm's moments and the gradients in another order than
  one process, and Adam's early updates of near-zero gradients grow such
  rounding, so the runs are compared twice:
  - augmentation off (both runs see the same pixels, as in
    `tests/test_torch_ddp.py`), at 1e-5 relative: every history entry
    (read 3.1e-6) and all weights together as one relative L2 (read
    7.7e-6), the accuracies exactly. Each tensor alone is not held at
    1e-5: a BatchNorm bias whose gradient nearly cancels reads 4.5e-4;
  - augmentation on, against a control measured here: the one process
    again with oneDNN off (another summation order in every convolution).
    Epoch 1's train loss at 1e-5 (read 9.4e-8, the control's too), the
    accuracies exactly, and the losses, all weights together and the worst
    tensor each within the larger of 1e-5 and 4x the control's drift (read
    against the control: losses 5.0e-5 / 2.8e-5, weights 1.4e-4 / 9.9e-5,
    worst tensor 5.3e-3 / 2.2e-3, a bias): the leaf images' flat
    background, edge-clamped by the rotation, gives the max-pools near-ties
    that any summation order breaks either way;
- `--checkpoint-every-steps 2` on a split manifest of conftest's tree, 3
  epochs: uninterrupted; killed (an exception from the step checkpointer
  on both ranks at the 6th step, in epoch 2); then `--resume`: the
  resumed run ends in the uninterrupted run's weights and history,
  exactly, on both ranks;
- `--steps-per-dispatch 2` on a mesh (chunks of 2 steps run eagerly, each
  rank taking its rows of every batch of a chunk on the gather path):
  `--balance-from` and the uninterrupted manifest run again, each equal to
  its one-step-a-dispatch run exactly on both ranks.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from leaffliction_tpu_torch.cli import train as train_cli  # noqa: E402
from leaffliction_tpu_torch.data.loader import (  # noqa: E402
    global_steps_per_epoch,
)
from leaffliction_tpu_torch.data.manifest import (  # noqa: E402
    load_manifest,
    save_manifest,
    write_split_manifest,
)
from leaffliction_tpu_torch.train.checkpoint import (  # noqa: E402
    load_model_msgpack,
)

import torch_dp_worker  # noqa: E402

torch.set_num_threads(1)

TINY = ["--scale", "tiny", "--device", "cpu", "--no-mixed-precision"]
BALANCE = ["--epochs", "2", "--img-size", "32", *TINY]
RESUME = ["--epochs", "3", "--batch-size", "4", "--img-size", "32",
          "--checkpoint-every-steps", "2", *TINY]
KILL_AT = 6


def _uneven_manifest(tiny_dataset, path):
    """5 train items and 4 val items of conftest's tree (its Apple)."""
    write_split_manifest(tiny_dataset, path.with_name("all.json"),
                         val_ratio=0.2, seed=32)
    meta, items = load_manifest(path.with_name("all.json"))
    def take(label, split, n):
        return [it for it in items
                if it.label == label and it.split == split][:n]

    labels = sorted({it.label for it in items if it.plant == "Apple"})[:2]
    train = take(labels[0], "train", 3) + take(labels[1], "train", 2)
    val = take(labels[0], "val", 2) + take(labels[1], "val", 2)
    save_manifest(path, meta, train + val)
    return path


@pytest.fixture(scope="module")
def runs(tiny_dataset, tmp_path_factory):
    d = tmp_path_factory.mktemp("ddp_cli")
    uneven = _uneven_manifest(tiny_dataset, d / "uneven.json")
    split = d / "split.json"
    write_split_manifest(tiny_dataset, split, val_ratio=0.2, seed=32)
    for name in ("uneven", "balance", "noaug", "full", "resume",
                 "chained"):
        (d / name).mkdir()

    def cli(name, argv, **extra):
        return {"kind": "cli", "cwd": str(d / name.split("_")[0]),
                "argv": argv, **extra}

    scenarios = [
        ("uneven", cli("uneven", [
            "--manifest", str(uneven), "--epochs", "1", "--batch-size", "2",
            "--img-size", "16", "--mesh-data", "2", "--out-dir", "models",
            *TINY])),
        ("balance", cli("balance", [
            "--balance-from", str(tiny_dataset), "--batch-size", "4",
            "--out-dir", "models", *BALANCE])),
        ("noaug", cli("noaug", [
            "--balance-from", str(tiny_dataset), "--batch-size", "4",
            "--out-dir", "models", *BALANCE], augment=False)),
        ("full", cli("full", ["--manifest", str(split), "--out-dir",
                              "models", *RESUME])),
        ("resume_killed", cli("resume", [
            "--manifest", str(split), "--out-dir", "models", *RESUME],
            kill_after=KILL_AT)),
        ("resume_resumed", cli("resume", [
            "--manifest", str(split), "--out-dir", "models", "--resume",
            *RESUME])),
        ("chained_balance", cli("chained", [
            "--balance-from", str(tiny_dataset), "--batch-size", "4",
            "--out-dir", "models_balance", "--steps-per-dispatch", "2",
            *BALANCE])),
        ("chained_full", cli("chained", [
            "--manifest", str(split), "--out-dir", "models_full",
            "--steps-per-dispatch", "2", *RESUME])),
    ]
    results = torch_dp_worker.launch({"dir": str(d), "scenarios": scenarios},
                                     world=2, timeout=240)
    return d, results


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _meta(d, name):
    return json.loads((d / name / "models" / "meta.json").read_text())


def test_uneven_shards_take_equal_steps_and_rank0_writes(runs):
    d, results = runs
    r0, r1 = results["uneven"]
    steps = global_steps_per_epoch(5, 2, 2)
    assert steps == 2
    assert r0["steps_ran"] == r1["steps_ran"] == steps
    assert r0["history"] == r1["history"]
    assert r0["mesh"] == r1["mesh"] == {"data": 2, "model": 1}
    assert (r0["wrote"], r1["wrote"]) == (["models"], [])
    meta = _meta(d, "uneven")
    assert meta["system"]["mesh"] == {"data": 2, "model": 1}
    assert meta["system"]["collective_backend"] == "gloo"
    assert meta["system"]["process_count"] == 2
    assert meta["run"]["batch_size"] == 2  # per process
    assert meta["data"]["train_items"] == 5
    for name in ("leaf_cnn.msgpack", "labels.json", "history.json",
                 "confusion_matrix.json"):
        assert (d / "uneven" / "models" / name).is_file()


def _one_process(tiny_dataset, cwd, monkeypatch, augment=True,
                 onednn=True):
    """The `--balance-from` run on one process at 8 images, in `cwd`."""
    from leaffliction_tpu_torch.train import steps

    real_build = steps.build_step_fns

    def build_step_fns(*args, **kwargs):
        return real_build(*args, **{**kwargs, "augment": augment})

    cwd.mkdir(parents=True)
    with monkeypatch.context() as m, torch.backends.mkldnn.flags(
            enabled=onednn):
        m.setattr(steps, "build_step_fns", build_step_fns)
        m.chdir(cwd)
        return train_cli.main(["--balance-from", str(tiny_dataset),
                               "--batch-size", "8", "--out-dir", "models",
                               *BALANCE])["fit"]


def _drift(history, state, fit):
    """→ (the largest relative difference of the losses, whether the
    accuracies are equal, all weights together as one relative L2, the
    worst tensor's (relative L2, name)) between a run and `fit`."""
    losses = max(float(np.max(np.abs(np.subtract(history[k],
                                                 fit.history[k]))
                              / np.abs(fit.history[k])))
                 for k in ("loss", "val_loss"))
    accuracies = all(history[k] == fit.history[k]
                     for k in ("accuracy", "val_accuracy"))
    ref = fit.state.model.state_dict()
    overall = _rel(torch.cat([state[k].ravel() for k in ref]),
                   torch.cat([v.ravel() for v in ref.values()]))
    worst = max((_rel(state[k], v), k) for k, v in ref.items())
    return losses, accuracies, overall, worst


def _assert_balance_run(d, name, results):
    """Both ranks balanced alike; rank 0 alone wrote."""
    r0, r1 = results[name]
    assert r0["balance_flags"] == [("balance_to_device", True),
                                   ("split_fused_result", True)]
    assert r1["balance_flags"] == [("balance_to_device", False),
                                   ("split_fused_result", False)]
    assert len(r0["replicated"]) == 4
    assert r0["replicated"] == r1["replicated"]
    assert (r0["wrote"], r1["wrote"]) == (["models"], [])
    for fname in ("manifest_augmented.json", "manifest_split.json",
                  "split_summary.csv"):
        assert (d / name / "artifacts" / "datasets" / fname).is_file()
    return r0


def _ranks_state(r0):
    return {k[len("model."):]: v for k, v in r0["state"].items()}


def test_balance_from_on_two_ranks_matches_one_process(
        runs, tiny_dataset, tmp_path, monkeypatch):
    d, results = runs
    r0 = _assert_balance_run(d, "balance", results)
    fit = _one_process(tiny_dataset, tmp_path / "one", monkeypatch)
    ctl = _one_process(tiny_dataset, tmp_path / "ctl", monkeypatch,
                       onednn=False)
    assert r0["steps_ran"] == fit.steps_ran == ctl.steps_ran
    # epoch 1's training loss is summed before any divergence can grow
    np.testing.assert_allclose(r0["history"]["loss"][0],
                               fit.history["loss"][0], rtol=1e-5)
    got = _drift(r0["history"], _ranks_state(r0), fit)
    control = _drift(ctl.history, ctl.state.model.state_dict(), fit)
    assert control[2] > 0, "the control changed no summation order"
    assert got[1] and control[1], (got, control)
    for what, g, c in (("losses", got[0], control[0]),
                       ("weights", got[2], control[2]),
                       ("worst tensor", got[3][0], control[3][0])):
        assert g <= max(1e-5, 4 * c), f"{what}: {g:.2e}, control {c:.2e}"
    ours, mine = ([(it["id"], it["label"], it["split"]) for it in json.loads(
        (root / "artifacts" / "datasets" / "manifest_split.json"
         ).read_text())["items"]] for root in (d / "balance",
                                               tmp_path / "one"))
    assert ours == mine


def test_balance_from_on_two_ranks_without_augmentation(
        runs, tiny_dataset, tmp_path, monkeypatch):
    d, results = runs
    r0 = _assert_balance_run(d, "noaug", results)
    fit = _one_process(tiny_dataset, tmp_path / "one", monkeypatch,
                       augment=False)
    assert r0["steps_ran"] == fit.steps_ran
    for k in ("loss", "val_loss"):
        np.testing.assert_allclose(r0["history"][k], fit.history[k],
                                   rtol=1e-5, err_msg=k)
    for k in ("accuracy", "val_accuracy"):
        assert r0["history"][k] == fit.history[k], k
    overall = _drift(r0["history"], _ranks_state(r0), fit)[2]
    assert overall <= 1e-5, overall


def test_killed_and_resumed_equals_uninterrupted(runs):
    d, results = runs
    killed = results["resume_killed"]
    assert all(r["killed"] and r["step_callbacks"] == KILL_AT
               for r in killed)
    full, resumed = results["full"], results["resume_resumed"]
    for r in range(2):
        got, want = resumed[r]["history"], full[0]["history"]
        for k in ("val_loss", "val_accuracy"):
            assert got[k] == want[k], k
        # the resumed epoch's train metrics cover only the steps after the
        # checkpoint (the JAX semantics, `tests/test_torch_resume.py`)
        for k in ("loss", "accuracy"):
            assert got[k][0] == want[k][0] and got[k][2] == want[k][2], k
        for k, v in full[0]["state"].items():
            assert torch.equal(resumed[r]["state"][k], v), k
    a = load_model_msgpack(d / "resume" / "models" / "leaf_cnn.msgpack")
    b = load_model_msgpack(d / "full" / "models" / "leaf_cnn.msgpack")

    def leaves(t, prefix=""):
        for k, v in t.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}", v

    assert dict((k, v.tobytes()) for k, v in leaves(a)) == \
        dict((k, v.tobytes()) for k, v in leaves(b))


@pytest.mark.parametrize("chained,ref", [("chained_balance", "balance"),
                                         ("chained_full", "full")])
def test_chained_on_two_ranks_equals_one_step_a_dispatch(runs, chained,
                                                         ref):
    _, results = runs
    for r in range(2):
        got, want = results[chained][r], results[ref][r]
        assert got["steps_ran"] == want["steps_ran"]
        assert got["history"] == want["history"]
        assert got["state"].keys() == want["state"].keys()
        for k, v in want["state"].items():
            assert torch.equal(got["state"][k], v), k
