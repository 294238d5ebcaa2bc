"""Mid-run resume of the PyTorch port's train CLI on the CPU, and its
checkpoints held against the JAX package's.

Tiny LeafCNN, 32 px, batch 8 on conftest's `tiny_dataset` (4 train steps
an epoch). A run killed mid-epoch (an exception from a patched
`maybe_save`, as `tests/test_resume.py` kills the JAX CLI) or after an
epoch checkpoint, then `--resume`, must end in exactly the state of one
uninterrupted run: every tensor of the final state (model, Adam moments,
EMA), the step, `lr_scale` and the training generator's state, compared
with `torch.equal`. After an epoch checkpoint `history.json` is equal too;
after a step checkpoint the resumed epoch's train loss and accuracy cover
only the steps after the checkpoint (the JAX semantics), and are held
exactly against the uninterrupted run's own metrics of those steps. The
save cadence skips a step while a save is in flight, which depends on
timing; the tests that count saves make every cadence fire by waiting for
the save in flight first, on the port's side and the JAX side alike.
"""

import contextlib
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from leaffliction_tpu.cli import split as split_cli  # noqa: E402
from leaffliction_tpu_torch.cli import train as train_cli  # noqa: E402
from leaffliction_tpu_torch.models.leafcnn import LeafCNN  # noqa: E402
from leaffliction_tpu_torch.train import checkpoint as ck  # noqa: E402
from leaffliction_tpu_torch.train import steps as tsteps  # noqa: E402
import jax_native  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    """The JAX side decodes through its JPEG helper loaded whole, or
    both sides through PIL (`tests/jax_native.py`)."""
    jax_native.ready()


torch.set_num_threads(1)

STEPS_PER_EPOCH, EPOCHS = 4, 3


@pytest.fixture(scope="module")
def manifest(tiny_dataset, tmp_path_factory):
    out = tmp_path_factory.mktemp("split")
    split_cli.main(["--src", str(tiny_dataset), "--out", str(out),
                    "--val-ratio", "0.25", "--seed", "32"])
    return out / "manifest_split.json"


def _flags(manifest, out, *extra):
    return ["--manifest", str(manifest), "--batch-size", "8", "--img-size",
            "32", "--scale", "tiny", "--device", "cpu",
            "--no-mixed-precision", "--out-dir", str(out), *extra]


@contextlib.contextmanager
def recorded_steps():
    """The metrics (loss, correct, n) of every train step, in order: each
    step alone or in a chained dispatch runs `StepFns._step`."""
    real, kept = tsteps.StepFns._step, []

    def recording(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        kept.append({"loss": out[0], "correct": out[1], "n": out[2]})
        return out

    tsteps.StepFns._step = recording
    try:
        yield kept
    finally:
        tsteps.StepFns._step = real


def _waiting(real, calls, kill_at=None):
    """`maybe_save` that first waits for the save in flight, so every
    cadence fires, records (global step, epoch, step in epoch, saved), and
    raises once it has been called `kill_at` times."""
    def maybe_save(self, global_step, state, meta, *rest):
        if self._inflight is not None:
            self._inflight.result(timeout=60)
        saved = real(self, global_step, state, meta, *rest)
        calls.append((global_step, meta["epoch"], meta["step_in_epoch"],
                      saved))
        if kill_at is not None and len(calls) >= kill_at:
            raise RuntimeError("simulated kill")
        return saved
    return maybe_save


@contextlib.contextmanager
def saves_waiting(kill_at=None):
    real, calls = ck.AsyncStepCheckpointer.maybe_save, []
    ck.AsyncStepCheckpointer.maybe_save = _waiting(real, calls, kill_at)
    try:
        yield calls
    finally:
        ck.AsyncStepCheckpointer.maybe_save = real


@pytest.fixture(scope="module")
def uninterrupted(manifest, tmp_path_factory):
    """One run of EPOCHS epochs under `--profile-dir`, with its steps'
    metrics."""
    out = tmp_path_factory.mktemp("uninterrupted")
    with recorded_steps() as steps:
        run = train_cli.main(_flags(manifest, out, "--epochs", str(EPOCHS),
                                    "--profile-dir", str(out / "profile")))
    assert len(steps) == STEPS_PER_EPOCH * EPOCHS
    return out, run["fit"], steps


def _tensors(result):
    st = result.state
    out = {f"model.{k}": v for k, v in st.model.state_dict().items()}
    for name in ("mu", "nu", "ema_params", "ema_batch_stats"):
        out.update({f"{name}.{k}": v for k, v in getattr(st, name).items()})
    return out


def _assert_same_end(got, ref):
    """Every tensor of the final state, the step, lr_scale and the
    generator's state exactly equal."""
    a, b = _tensors(got), _tensors(ref)
    assert a.keys() == b.keys()
    bad = [k for k in a if not torch.equal(a[k], b[k])]
    assert bad == []
    assert got.state.step == ref.state.step
    assert got.state.lr_scale == ref.state.lr_scale
    assert torch.equal(got.generator_state, ref.generator_state)
    assert got.best_variant == ref.best_variant


def _history(out):
    return json.loads((out / "history.json").read_text())


def test_step_checkpoint_resume_equals_uninterrupted(manifest, uninterrupted,
                                                     tmp_path):
    ref_out, ref, ref_steps = uninterrupted
    out = tmp_path / "m"
    flags = _flags(manifest, out, "--epochs", str(EPOCHS),
                   "--checkpoint-every-steps", "2")
    with saves_waiting(kill_at=6) as calls, \
            pytest.raises(RuntimeError, match="simulated kill"):
        train_cli.main(flags)
    # saves at global steps 1, 3, 5; the newest two kept; the kill at 6
    assert [c[0] for c in calls if c[3]] == [1, 3, 5]
    ckpt = out / "checkpoints"
    latest = ck.latest_resume_step(ckpt)
    assert latest == 5 and calls[-1][0] - latest <= 2 * 2
    assert sorted(p.name for p in ckpt.iterdir()) == [
        "3", "5", "step_meta_3.json", "step_meta_5.json"]
    meta = ck.read_step_meta(ckpt, latest)
    assert (meta["epoch"], meta["step_in_epoch"]) == (1, 1)  # mid-epoch
    assert {k: len(v) for k, v in meta["history"].items()} == {
        "loss": 1, "accuracy": 1, "val_loss": 1, "val_accuracy": 1}

    with recorded_steps() as steps:
        run = train_cli.main(flags + ["--resume"])
    _assert_same_end(run["fit"], ref)
    assert run["fit"].state.step == STEPS_PER_EPOCH * EPOCHS
    assert run["fit"].steps_ran == len(steps) == 7
    # the resumed steps are the uninterrupted run's steps 6-12, exactly
    for got, want in zip(steps, ref_steps[5:]):
        for k in ("loss", "correct", "n"):
            assert torch.equal(got[k], want[k]), k
    got_h, ref_h = _history(out), _history(ref_out)
    assert got_h["val_loss"] == ref_h["val_loss"]
    assert got_h["val_accuracy"] == ref_h["val_accuracy"]
    for k in ("loss", "accuracy"):
        assert got_h[k][0] == ref_h[k][0] and got_h[k][2] == ref_h[k][2]
    # epoch 2 counts only the 3 steps after the checkpoint
    rows = torch.stack([torch.stack([m["loss"] * m["n"], m["correct"],
                                     m["n"]]) for m in ref_steps[5:8]])
    loss_sum, correct, n = rows.sum(0).double().tolist()
    assert got_h["loss"][1] == loss_sum / n
    assert got_h["accuracy"][1] == correct / n


def test_epoch_checkpoint_resume_equals_uninterrupted(manifest, uninterrupted,
                                                      tmp_path, monkeypatch):
    ref_out, ref, _ = uninterrupted
    out = tmp_path / "m"
    flags = _flags(manifest, out, "--epochs", str(EPOCHS),
                   "--checkpoint-every", "1")
    real, saved = ck.save_resume_checkpoint, []

    def killing_save(ckpt_dir, epoch, *args):
        if epoch == 2:  # killed after epoch 3's training
            raise RuntimeError("simulated kill")
        real(ckpt_dir, epoch, *args)
        saved.append(epoch)

    monkeypatch.setattr(ck, "save_resume_checkpoint", killing_save)
    with pytest.raises(RuntimeError, match="simulated kill"):
        train_cli.main(flags)
    monkeypatch.setattr(ck, "save_resume_checkpoint", real)
    ckpt = out / "checkpoints"
    assert saved == [0, 1] and ck.latest_resume_step(ckpt) == 1
    assert ck.read_step_meta(ckpt, 1) is None  # an epoch checkpoint
    run = train_cli.main(flags + ["--resume"])
    _assert_same_end(run["fit"], ref)
    assert run["fit"].steps_ran == STEPS_PER_EPOCH
    assert (out / "history.json").read_text() == \
        (ref_out / "history.json").read_text()
    assert json.loads((ckpt / "history.json").read_text()) == _history(out)


def test_balance_from_resume_equals_uninterrupted(tiny_dataset, tmp_path,
                                                  monkeypatch):
    """`--balance-from` resumes too: the fused balance is deterministic by
    seed, so the resumed run balances and splits to the same rows and
    ends in the uninterrupted run's state."""
    monkeypatch.chdir(tmp_path)  # the fused balance writes artifacts/
    flags = ["--balance-from", str(tiny_dataset), "--epochs", "2",
             "--batch-size", "8", "--img-size", "32", "--scale", "tiny",
             "--device", "cpu", "--no-mixed-precision"]
    ref = train_cli.main(flags + ["--out-dir", str(tmp_path / "a")])
    real = ck.save_resume_checkpoint

    def killing_save(ckpt_dir, epoch, *args):
        if epoch == 1:
            raise RuntimeError("simulated kill")
        real(ckpt_dir, epoch, *args)

    out = ["--out-dir", str(tmp_path / "b"), "--checkpoint-every", "1"]
    monkeypatch.setattr(ck, "save_resume_checkpoint", killing_save)
    with pytest.raises(RuntimeError, match="simulated kill"):
        train_cli.main(flags + out)
    monkeypatch.setattr(ck, "save_resume_checkpoint", real)
    run = train_cli.main(flags + out + ["--resume"])
    _assert_same_end(run["fit"], ref["fit"])
    assert run["fit"].epochs_ran == 2 and run["fit"].steps_ran == \
        ref["fit"].steps_ran // 2
    assert run["balance"]["train"] == ref["balance"]["train"]
    assert (tmp_path / "b" / "history.json").read_text() == \
        (tmp_path / "a" / "history.json").read_text()


def test_resume_extends_history(manifest, tmp_path):
    out = tmp_path / "m"
    train_cli.main(_flags(manifest, out, "--epochs", "2",
                          "--checkpoint-every", "1"))
    h1 = _history(out)
    assert len(h1["loss"]) == 2
    train_cli.main(_flags(manifest, out, "--epochs", "4",
                          "--checkpoint-every", "1", "--resume"))
    h2 = _history(out)
    assert len(h2["loss"]) == 4
    assert {k: v[:2] for k, v in h2.items()} == h1


def test_resume_without_checkpoint_warns_and_trains(manifest, tmp_path,
                                                    capsys):
    out = tmp_path / "m"
    run = train_cli.main(_flags(manifest, out, "--epochs", "1", "--resume"))
    log = capsys.readouterr().out  # the port's log goes to stdout
    assert "[WARNING]" in log and "No checkpoint found" in log
    assert run["fit"].steps_ran == STEPS_PER_EPOCH
    assert (out / "leaf_cnn.msgpack").exists()


def _tiny_state():
    from leaffliction_tpu_torch.train.steps import train_state_for

    return train_state_for(LeafCNN(3, (4,)))


def test_maybe_save_does_not_block(tmp_path, monkeypatch):
    """`maybe_save` returns before the save commits: the copy to the host
    and the write run in the worker. The copy is slowed, and the call
    timed; a second call while the save is in flight is skipped."""
    slow = 0.6
    real = ck._host_copy

    def slow_host_copy(snap):
        time.sleep(slow)
        return real(snap)

    monkeypatch.setattr(ck, "_host_copy", slow_host_copy)
    state = _tiny_state()
    gen = torch.Generator().manual_seed(3)
    saver = ck.AsyncStepCheckpointer(tmp_path / "ck", every_steps=1)
    meta = {"epoch": 0, "step_in_epoch": 3, "history": {"loss": [1.5]}}
    try:
        t0 = time.perf_counter()
        assert saver.maybe_save(3, state, meta, gen)
        took = time.perf_counter() - t0
        assert took < slow / 2, f"maybe_save blocked for {took:.2f}s"
        assert saver.busy()
        assert not saver.maybe_save(4, state, meta, gen)  # in flight
        meta["history"]["loss"].append(2.5)  # the snapshot kept [1.5]
    finally:
        saver.close()
    assert ck.latest_resume_step(tmp_path / "ck") == 3
    assert ck.read_step_meta(tmp_path / "ck", 3) == {
        "epoch": 0, "step_in_epoch": 3, "history": {"loss": [1.5]}}
    fresh = _tiny_state()
    _, gen_state = ck.restore_resume_checkpoint(tmp_path / "ck", 3, fresh)
    assert torch.equal(gen_state, gen.get_state())


def test_close_raises_a_failed_save(tmp_path, monkeypatch):
    def failing_write(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(ck, "_write", failing_write)
    saver = ck.AsyncStepCheckpointer(tmp_path / "ck", every_steps=1)
    state, meta = _tiny_state(), {"epoch": 0, "step_in_epoch": 1,
                                  "history": {}}
    assert saver.maybe_save(1, state, meta)
    ck.cf.wait([saver._inflight], timeout=60)
    with pytest.raises(OSError, match="disk full"):
        saver.maybe_save(2, state, meta)  # the next save reads the failure
    with pytest.raises(OSError, match="disk full"):
        saver.close()
    assert ck.latest_resume_step(tmp_path / "ck") is None
    assert not ck.step_meta_path(tmp_path / "ck", 1).exists()


def test_torn_write_is_never_the_latest(tmp_path, monkeypatch):
    """A write killed before its rename leaves `state.pt.tmp`: the previous
    checkpoint stays the latest and restores; a `.tmp` of a newer id is
    not a checkpoint."""
    ckpt = tmp_path / "ck"
    state = _tiny_state()
    ck.save_resume_checkpoint(ckpt, 5, state)
    (ckpt / "9").mkdir()
    (ckpt / "9" / "state.pt.tmp").write_bytes(b"torn")

    def torn_save(obj, f):
        f.write(b"partial")
        raise KeyboardInterrupt

    monkeypatch.setattr(ck.torch, "save", torn_save)
    with pytest.raises(KeyboardInterrupt):
        ck.save_resume_checkpoint(ckpt, 7, state)
    monkeypatch.undo()
    assert (ckpt / "7" / "state.pt.tmp").exists()
    assert ck.latest_resume_step(ckpt) == 5
    restored, _ = ck.restore_resume_checkpoint(ckpt, 5, _tiny_state())
    for k, v in state.model.state_dict().items():
        assert torch.equal(restored.model.state_dict()[k], v)


def test_max_to_keep_prunes_old_checkpoints(tmp_path):
    state = _tiny_state()
    for step in (2, 4, 6):
        state.step = step
        ck.save_resume_checkpoint(tmp_path, step, state)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["4", "6"]
    restored, gen = ck.restore_resume_checkpoint(tmp_path, 6, _tiny_state())
    assert restored.step == 6 and gen is None


def test_profile_dir_writes_a_trace_of_the_step(uninterrupted):
    out, _, _ = uninterrupted
    trace = out / "profile" / "train_trace.json"
    events = json.loads(trace.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert len(events) > 1000
    for op in ("aten::conv2d", "aten::_foreach_add", "aten::log_softmax"):
        assert op in names, op


def test_step_saves_match_the_jax_cli(manifest, tmp_path, monkeypatch):
    """The same manifest and flags through both CLIs with
    `--checkpoint-every-steps 2`, every cadence firing on both sides: the
    same saved steps with the same (epoch, step_in_epoch), the same
    checkpoints kept, step metas with the same keys and history lengths
    (the values differ: the two packages draw differently), and
    `history.json` with the same keys and lengths."""
    from leaffliction_tpu.cli import train as jax_train_cli
    from leaffliction_tpu.train import checkpoint as jck

    flags = ["--manifest", str(manifest), "--epochs", "2", "--batch-size",
             "8", "--img-size", "32", "--scale", "tiny", "--fast",
             "--no-mixed-precision", "--checkpoint-every-steps", "2"]
    with saves_waiting() as port_calls:
        train_cli.main(flags + ["--device", "cpu", "--out-dir",
                                str(tmp_path / "port")])
    jax_calls = []
    monkeypatch.setattr(jck.AsyncStepCheckpointer, "maybe_save", _waiting(
        jck.AsyncStepCheckpointer.maybe_save, jax_calls))
    jax_train_cli.main(flags + ["--no-export-keras", "--out-dir",
                                str(tmp_path / "jax")])
    assert port_calls == jax_calls
    assert [c[0] for c in port_calls if c[3]] == [1, 3, 5, 7]
    port_ck, jax_ck = tmp_path / "port" / "checkpoints", \
        tmp_path / "jax" / "checkpoints"
    assert ck.latest_resume_step(port_ck) == \
        jck.latest_resume_step(jax_ck) == 7
    metas = sorted(p.name for p in port_ck.glob("step_meta_*.json"))
    assert metas == sorted(p.name for p in jax_ck.glob("step_meta_*.json"))
    for step in (5, 7):
        got, want = ck.read_step_meta(port_ck, step), \
            jck.read_step_meta(jax_ck, step)
        assert (got["epoch"], got["step_in_epoch"]) == \
            (want["epoch"], want["step_in_epoch"])
        assert {k: len(v) for k, v in got["history"].items()} == \
            {k: len(v) for k, v in want["history"].items()}
    got_h, want_h = (json.loads((tmp_path / side / "history.json")
                                .read_text()) for side in ("port", "jax"))
    assert {k: len(v) for k, v in got_h.items()} == \
        {k: len(v) for k, v in want_h.items()}
    assert all(np.isfinite(v).all() for v in got_h.values())
