"""The train CLI with tensor parallelism on CPU ranks (gloo), through its
normal entry point.

Worker processes (`tests/torch_dp_worker.py`, each killed if it outlives
its timeout) run `cli.train.main` with `--mesh-model 2`, the process group
joined once a launch:

- manifest mode on `data=1 × model=2` (two ranks) and `data=2 × model=2`
  (four), leafcnn-tiny at 32 px (`min_size` 64: the width-64 stage and its
  32 → 64 boundary are sharded): every rank ends with the same gathered
  state and history, rank 0 alone writes the artifacts, `meta.json`
  records the mesh {"data": D, "model": 2}, the written model is the
  gathered state bit for bit, and `cli.predict` serves it in one process
  with the probabilities of a predictor built on that state; on `1 × 2`
  `--checkpoint-every 1` writes the full state, which one process
  restores;
- `--checkpoint-every-steps 2` on `1 × 2`, 3 epochs: uninterrupted;
  killed (an exception from the step checkpointer on both ranks at the
  10th step, in epoch 2 of 8 steps each); then `--resume`: the resumed run ends in the
  uninterrupted run's weights and history, exactly, on both ranks;
- a second run killed the same way, whose (full-state) checkpoint one
  process resumes here: it runs the steps after the checkpoint and ends
  within 1e-3 of the uninterrupted two-rank run (losses relative, all
  weights as one relative L2): the one process sums in another order;
- `--balance-from` on `1 × 2`: both ranks balance the same tree (the four
  fused tensors pass `check_replicated`, equal digests), rank 0 alone
  writes the manifests and the artifacts.
"""

import json
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from leaffliction_tpu_torch.cli import predict as predict_cli  # noqa: E402
from leaffliction_tpu_torch.cli import train as train_cli  # noqa: E402
from leaffliction_tpu_torch.convert import to_state_dict  # noqa: E402
from leaffliction_tpu_torch.data.loader import (  # noqa: E402
    global_steps_per_epoch,
)
from leaffliction_tpu_torch.data.manifest import (  # noqa: E402
    load_manifest,
    select_items,
    write_split_manifest,
)
from leaffliction_tpu_torch.models.leafcnn import build_leafcnn  # noqa: E402
from leaffliction_tpu_torch.predict.predictor import Predictor  # noqa: E402
from leaffliction_tpu_torch.train.checkpoint import (  # noqa: E402
    load_model_msgpack,
)

import torch_dp_worker  # noqa: E402

torch.set_num_threads(1)

TINY = ["--scale", "tiny", "--device", "cpu", "--no-mixed-precision"]
TP = ["--mesh-model", "2"]
RUN = ["--epochs", "2", "--batch-size", "4", "--img-size", "32", *TINY]
ONE = ["--epochs", "3", "--batch-size", "4", "--img-size", "32",
       "--checkpoint-every-steps", "2", *TINY]
RESUME = [*ONE, *TP]
KILL_AT = 10


@pytest.fixture(scope="module")
def runs(tiny_dataset, tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_cli")
    split = d / "split.json"
    write_split_manifest(tiny_dataset, split, val_ratio=0.2, seed=32)
    for name in ("m12", "m22", "full", "resume", "again", "balance"):
        (d / name).mkdir()

    def cli(name, argv, **extra):
        return {"kind": "cli", "cwd": str(d / name.split("_")[0]),
                "argv": argv, **extra}

    manifest = ["--manifest", str(split), "--out-dir", "models"]
    two = [
        ("m12", cli("m12", [*manifest, *RUN, "--mesh-data", "1", *TP,
                            "--checkpoint-every", "1"])),
        ("full", cli("full", [*manifest, *RESUME])),
        ("resume_killed", cli("resume", [*manifest, *RESUME],
                              kill_after=KILL_AT)),
        ("resume_resumed", cli("resume", [*manifest, "--resume",
                                          *RESUME])),
        ("again_killed", cli("again", [*manifest, *RESUME],
                             kill_after=KILL_AT)),
        ("balance", cli("balance", [
            "--balance-from", str(tiny_dataset), "--out-dir", "models",
            *RUN, *TP])),
    ]
    results = torch_dp_worker.launch(
        {"dir": str(d / "two"), "scenarios": two, "mesh_data": 1,
         "mesh_model": 2}, world=2, timeout=240)
    results.update(torch_dp_worker.launch(
        {"dir": str(d / "four"), "mesh_data": 2, "mesh_model": 2,
         "scenarios": [("m22", cli("m22", [*manifest, *RUN, "--mesh-data",
                                           "2", *TP]))]},
        world=4, timeout=240))
    return d, split, results


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("name,data", [("m12", 1), ("m22", 2)])
def test_tp_cli_writes_the_gathered_model_once_and_predict_serves_it(
        runs, name, data, tiny_dataset, tmp_path, monkeypatch):
    d, split, results = runs
    ranks = results[name]
    r0 = ranks[0]
    _, items = load_manifest(split)
    n_train = len(select_items(items, "train"))
    assert r0["steps_ran"] == 2 * global_steps_per_epoch(n_train, 4, data)
    assert r0["wrote"] == ["models"]
    for r in ranks:
        assert r["mesh"] == {"data": data, "model": 2}
        assert r["history"] == r0["history"]
        assert r["state"].keys() == r0["state"].keys()
        for k, v in r0["state"].items():
            assert torch.equal(r["state"][k], v), k
    assert all(r["wrote"] == [] for r in ranks[1:])
    assert np.isfinite(r0["history"]["loss"]).all()
    models = d / name / "models"
    meta = json.loads((models / "meta.json").read_text())
    assert meta["system"]["mesh"] == {"data": data, "model": 2}
    assert meta["system"]["collective_backend"] == "gloo"
    assert meta["run"]["batch_size"] == 4  # a data index's
    state = {k[len("model."):]: v for k, v in r0["state"].items()}
    written = to_state_dict(load_model_msgpack(models / "leaf_cnn.msgpack"))
    assert written.keys() == state.keys()
    for k, v in state.items():
        assert torch.equal(written[k], v), k

    # cli.predict in one process, against a predictor on the gathered state
    images = sorted(tiny_dataset.rglob("*.JPG"))[:6]
    folder = tmp_path / "images"
    folder.mkdir()
    for p in images:
        shutil.copy(p, folder / p.name)
    monkeypatch.chdir(tmp_path)
    predict_cli.main([str(folder), "--batch-mode", "--device", "cpu",
                      "-learnings", str(models), "--json-output",
                      str(tmp_path / "out.json")])
    served = json.loads((tmp_path / "out.json").read_text())["batch_results"]
    model = build_leafcnn(len(meta["labels"]), "tiny")
    model.load_state_dict(state)
    ref = Predictor.from_model(model, meta["labels"], 32, device="cpu")
    want = {str(r["image_path"]): r for r in
            ref.predict_batch(sorted(folder.iterdir()))}
    assert len(served) == len(images)
    for r in served:
        w = want[r["image_path"]]
        assert r["top_prediction"] == w["top_prediction"]
        np.testing.assert_allclose(
            [r["all_probabilities"][k] for k in meta["labels"]],
            [w["all_probabilities"][k] for k in meta["labels"]],
            rtol=0, atol=1e-6)


def test_tp_epoch_checkpoint_is_the_full_state(runs):
    """`--checkpoint-every 1` on `1 × 2`: the model group gathers, rank 0
    writes the full state; one process restores it, and the last epoch's
    checkpoint holds the weights the run saved (the base weights, or the
    EMA copies when those won)."""
    from leaffliction_tpu_torch.train.checkpoint import (
        latest_resume_step,
        restore_resume_checkpoint,
    )
    from leaffliction_tpu_torch.train.steps import train_state_for

    d, _, results = runs
    r0 = results["m12"][0]
    ckpt = d / "m12" / "models" / "checkpoints"
    assert latest_resume_step(ckpt) == 1
    meta = json.loads((d / "m12" / "models" / "meta.json").read_text())
    state = train_state_for(build_leafcnn(len(meta["labels"]), "tiny"))
    restore_resume_checkpoint(ckpt, 1, state)
    saved = ({**state.ema_params, **state.ema_batch_stats}
             if r0["best_variant"] == "ema" else state.model.state_dict())
    for k, v in saved.items():
        assert torch.equal(v, r0["state"][f"model.{k}"]), k


def test_tp_killed_and_resumed_equals_uninterrupted(runs):
    d, _, results = runs
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
    assert dict((k, v.tobytes()) for k, v in _leaves(a)) == \
        dict((k, v.tobytes()) for k, v in _leaves(b))


def test_tp_checkpoint_resumes_in_one_process(runs, tmp_path, monkeypatch):
    """The checkpoint is the full state, so one process resumes it: it
    runs the steps after the checkpoint and ends where the uninterrupted
    two-rank run ends, up to summation order."""
    from leaffliction_tpu_torch.train.checkpoint import (
        latest_resume_step,
        read_step_meta,
    )

    d, split, results = runs
    assert all(r["killed"] for r in results["again_killed"])
    shutil.copytree(d / "again" / "models", tmp_path / "models")
    ckpt = tmp_path / "models" / "checkpoints"
    step = latest_resume_step(ckpt)
    epoch = read_step_meta(ckpt, step)["epoch"]
    monkeypatch.chdir(tmp_path)
    run = train_cli.main(["--manifest", str(split), "--out-dir", "models",
                          "--resume", *ONE])
    full = results["full"][0]
    fit = run["fit"]
    assert run["mesh"].shape == {"data": 1, "model": 1}
    assert fit.steps_ran == full["steps_ran"] - step
    hist, want = fit.history, full["history"]
    np.testing.assert_allclose(hist["val_loss"], want["val_loss"],
                               rtol=1e-3)
    np.testing.assert_allclose(hist["loss"][epoch + 1:],
                               want["loss"][epoch + 1:], rtol=1e-3)
    state = fit.state.model.state_dict()
    ref = {k[len("model."):]: v for k, v in full["state"].items()}
    overall = float(torch.cat([(state[k] - v).ravel() for k, v in
                               ref.items()]).norm()
                    / torch.cat([v.ravel() for v in ref.values()]).norm())
    assert overall <= 1e-3, overall


def test_tp_balance_from_on_one_by_two(runs):
    d, _, results = runs
    r0, r1 = results["balance"]
    assert r0["balance_flags"] == [("balance_to_device", True),
                                   ("split_fused_result", True)]
    assert r1["balance_flags"] == [("balance_to_device", False),
                                   ("split_fused_result", False)]
    assert len(r0["replicated"]) == 4
    assert r0["replicated"] == r1["replicated"]
    assert (r0["wrote"], r1["wrote"]) == (["models"], [])
    assert r0["mesh"] == {"data": 1, "model": 2}
    assert r0["history"] == r1["history"]
    for k, v in r0["state"].items():
        assert torch.equal(r1["state"][k], v), k
    assert np.isfinite(r0["history"]["loss"]).all()
    for fname in ("manifest_augmented.json", "manifest_split.json",
                  "split_summary.csv"):
        assert (d / "balance" / "artifacts" / "datasets" / fname).is_file()
    meta = json.loads((d / "balance" / "models" / "meta.json").read_text())
    assert meta["system"]["mesh"] == {"data": 1, "model": 2}
