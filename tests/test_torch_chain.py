"""Multi-step dispatch in the PyTorch port, on the CPU, against itself and
against the JAX package's chained steps.

On the CPU a chunk's steps run eagerly (the card replays a CUDA graph of
the same `StepFns.chain`; `tests/test_torch_gpu.py` and `chip_smoke.py`
phase 27 hold the graph against the eager steps there). Held here:

- `chain_batches` equals the JAX package's for k = 1, 2, 3, remainder
  included;
- `train_step_chain` and `train_step_gather` with `sel` [K, B] equal K
  single steps exactly (state, metrics, generator state), with
  augmentation and dropout on, for a tiny LeafCNN at 32 px and resnet10
  at 32 px;
- the chain against JAX's `train_step_chain` / `train_step_gather` [K, B]
  at `tests/test_torch_train_step.py`'s tolerances (augmentation and
  dropout off there, as in that test);
- the scripted `fit(chain_steps=k)` against the JAX `fit(chain_steps=k)`:
  history, steps run, the `(epoch, step_in_epoch)` of every
  `step_callback`, the steps the log line fires at, and resume with
  `skip_steps`; a resume at a step inside another k's chunk ends exactly
  where the uninterrupted run ends;
- the whole-val-set `eval_chain_gather` equals the per-batch eval steps
  exactly and JAX's `eval_chain_gather` at the step test's tolerance;
- the hyper table (LR and Adam's bias corrections) is bit-equal to the f32
  scalars the single step computed before it read them from the device;
- the train CLI: `--steps-per-dispatch 3` and `4` write the same
  `history.json` and weights as `1`; under `4` with
  `--checkpoint-every-steps 2` it saves the steps the JAX CLI saves under
  the same flags; `-1` resolves to 1 on the CPU.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from leaffliction_tpu.data.loader import Batch as JaxBatch  # noqa: E402
from leaffliction_tpu.train import trainer as jax_trainer  # noqa: E402
from leaffliction_tpu_torch.cli import train as train_cli  # noqa: E402
from leaffliction_tpu_torch.data.loader import Batch  # noqa: E402
from leaffliction_tpu_torch.models.leafcnn import (  # noqa: E402
    LeafCNN,
    init_model,
)
from leaffliction_tpu_torch.models.resnet import (  # noqa: E402
    RESNET_PRESETS,
    LeafResNet,
)
from leaffliction_tpu_torch.train import steps, trainer  # noqa: E402
from leaffliction_tpu_torch.train.config import TrainConfig  # noqa: E402
from test_torch_resume import _flags, saves_waiting  # noqa: E402
from test_torch_train_step import CONFIGS, Pair  # noqa: E402
from test_torch_trainer import (  # noqa: E402
    JaxState,
    Script,
    ScriptedSteps,
    _iters,
    _jax_step_fns,
    _resume_kwargs,
)
import jax_native  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    """The JAX side decodes through its JPEG helper loaded whole, or
    both sides through PIL (`tests/jax_native.py`)."""
    jax_native.ready()


torch.set_num_threads(1)

K_CLASSES, S, B = 5, 32, 4


# --- chain_batches ----------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 3])
def test_chain_batches_matches_jax(k):
    """7 batches: k = 2 and 3 give full chunks and a remainder of singles,
    k = 1 passes the stream through; every array equal."""
    rng = np.random.default_rng(k)
    raw = [(rng.integers(0, 256, (B, 2, 2, 3), np.uint8),
            rng.integers(0, 3, B).astype(np.int32),
            (rng.random(B) < 0.8).astype(np.float32),
            rng.integers(0, 30, B).astype(np.int32)) for _ in range(7)]
    got = list(trainer.chain_batches((Batch(*r) for r in raw), k))
    want = list(jax_trainer.chain_batches((JaxBatch(*r) for r in raw), k))
    assert len(got) == len(want) == (7 if k == 1 else 7 // k + 7 % k)
    for g, w in zip(got, want):
        assert len(g) == len(w) == 4
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


# --- the chained step against K single steps --------------------------------

def _model(arch):
    if arch == "leafcnn":
        return LeafCNN(K_CLASSES, (8, 16), drop_block=0.15, drop_top=0.3)
    return LeafResNet(K_CLASSES, **RESNET_PRESETS["resnet10"])


def _twins(arch, cfg):
    """Two equal states and generators, and the step functions (augment
    and dropout on)."""
    out = []
    for _ in range(2):
        state = steps.train_state_for(init_model(_model(arch), 3))
        out.append((state, torch.Generator().manual_seed(7)))
    return out, steps.build_step_fns(cfg, K_CLASSES, 40)


def _tensors(state):
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    for name in ("mu", "nu", "ema_params", "ema_batch_stats"):
        out.update({f"{name}.{k}": v for k, v in
                    getattr(state, name).items()})
    return out


def _assert_same_state(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert ta.keys() == tb.keys()
    assert [k for k in ta if not torch.equal(ta[k], tb[k])] == []
    assert a.step == b.step


@pytest.mark.parametrize("path", ["chain", "gather"])
@pytest.mark.parametrize("arch,cfg", [("leafcnn", "regularized"),
                                      ("leafcnn", "fast"),
                                      ("resnet10", "regularized")])
def test_chain_equals_single_steps(arch, cfg, path):
    k = 3 if arch == "leafcnn" else 2
    rng = np.random.default_rng(5)
    data = torch.from_numpy(rng.integers(0, 256, (12, S, S, 3), np.uint8))
    labels = torch.from_numpy(rng.integers(0, K_CLASSES, 12))
    sel = torch.from_numpy(np.stack([rng.choice(12, B, replace=False)
                                     for _ in range(k)]))
    mask = torch.ones(k, B)
    mask[1, -1] = 0.0
    ((one, g1), (many, gk)), fns = _twins(arch, CONFIGS[cfg])
    singles = []
    for i in range(k):
        singles.append(fns.train_step(one, data[sel[i]], labels[sel[i]],
                                      mask[i], g1))
    if path == "chain":
        m = fns.train_step_chain(many, data[sel], labels[sel], mask, gk)
    else:
        m = fns.train_step_gather(many, data, labels, sel, mask, gk)
    for name in ("loss", "correct", "n"):
        assert torch.equal(m[name], torch.stack([s[name] for s in singles]))
    assert list(m["lr"]) == [s["lr"] for s in singles]
    _assert_same_state(many, one)
    assert many.step == k
    assert torch.equal(gk.get_state(), g1.get_state())


# --- against JAX's chained step ---------------------------------------------

@pytest.mark.parametrize("path", ["chain", "gather"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_chain_matches_jax_chain(name, path):
    """K = 4 steps in one JAX program (`train_step_chain`, or
    `train_step_gather` over the batches as a dataset) and in one port
    dispatch: each step's loss at rtol 1e-5, correct and n equal, the LR
    within 1e-6 of the base LR; the state after the chunk at the step
    test's free-running bars (params 5e-4, batch_stats 5e-5, EMA 2e-4).
    The gather variant scatters the step test's batches over a shuffled
    dataset and gathers them back in their row order, so both variants
    train on the step test's batches (another row order moves the
    near-cancelling BatchNorm biases by another summation order: one
    reached 1.3e-3 after 4 steps with the rows reversed)."""
    p = Pair(CONFIGS[name])
    k = 4
    imgs, labs, msk = p.images[:k], p.labels[:k], p.mask[:k]
    if path == "chain":
        p.jstate, mj = p.jfns.train_step_chain(p.jstate, imgs, labs, msk,
                                               jax.random.key(0))
        mt = p.tfns.train_step_chain(
            p.tstate, torch.from_numpy(imgs), torch.from_numpy(labs).long(),
            torch.from_numpy(msk), p.gen)
    else:
        perm = np.random.default_rng(3).permutation(k * B)
        flat_i = np.empty((k * B,) + imgs.shape[2:], np.uint8)
        flat_l = np.empty((k * B,), np.int32)
        flat_i[perm] = imgs.reshape((-1,) + imgs.shape[2:])
        flat_l[perm] = labs.reshape(-1)
        sel = perm.astype(np.int32).reshape(k, B)
        p.jstate, mj = p.jfns.train_step_gather(
            p.jstate, flat_i, flat_l, sel, msk, jax.random.key(0))
        mt = p.tfns.train_step_gather(
            p.tstate, torch.from_numpy(flat_i),
            torch.from_numpy(flat_l).long(), torch.from_numpy(sel).long(),
            torch.from_numpy(msk), p.gen)
    mj = jax.device_get(mj)
    np.testing.assert_allclose(mt["loss"].numpy(), mj["loss"], rtol=1e-5)
    np.testing.assert_array_equal(mt["correct"].numpy(), mj["correct"])
    np.testing.assert_array_equal(mt["n"].numpy(), mj["n"])
    np.testing.assert_allclose(mt["lr"], mj["lr"], rtol=0,
                               atol=1e-6 * p.cfg.lr)
    assert p.tstate.step == int(p.jstate.step) == k
    p.compare(5e-4, 5e-5, 2e-4)


# --- the whole-val-set eval -------------------------------------------------

@pytest.mark.parametrize("use_ema", [False, True])
def test_eval_chain_matches_batches_and_jax(use_ema):
    """After two steps (so the EMA differs from the params): the port's
    `eval_chain_gather` against its per-batch eval steps exactly, and
    against JAX's `eval_chain_gather` / `eval_chain_ema_gather` at the
    step test's loss bar (rtol 1e-5) with equal counts and predictions."""
    p = Pair(CONFIGS["regularized"])
    for i in range(2):
        p.step_jax(i)
    p.sync_port()
    data = p.images[2:5].reshape((-1, S, S, 3))
    labels = p.labels[2:5].reshape(-1)
    sel = np.arange(len(data), dtype=np.int32)[::-1].reshape(3, B).copy()
    mask = p.mask[2:5]
    td, tl = torch.from_numpy(data), torch.from_numpy(labels).long()
    ts, tm = torch.from_numpy(sel).long(), torch.from_numpy(mask)
    if use_ema:
        m, preds = p.tfns.eval_chain_ema_gather(p.tstate, td, tl, ts, tm)
        jm, jp = p.jfns.eval_chain_ema_gather(p.jstate, data, labels, sel,
                                              mask)
    else:
        m, preds = p.tfns.eval_chain_gather(p.tstate, td, tl, ts, tm)
        jm, jp = p.jfns.eval_chain_gather(p.jstate, data, labels, sel, mask)
    for i in range(3):
        mi, pi = p.tfns.eval_step_gather(p.tstate, td, tl, ts[i], tm[i],
                                         use_ema)
        for name in ("loss_sum", "correct", "n"):
            assert torch.equal(m[name][i], mi[name])
        assert torch.equal(preds[i], pi)
    jm = jax.device_get(jm)
    np.testing.assert_allclose(m["loss_sum"].numpy(), jm["loss_sum"],
                               rtol=1e-5)
    np.testing.assert_array_equal(m["correct"].numpy(), jm["correct"])
    np.testing.assert_array_equal(m["n"].numpy(), jm["n"])
    np.testing.assert_array_equal(preds.numpy(), np.asarray(jp))


def test_evaluate_whole_set_equals_batch_path():
    """`evaluate` with a device-resident val set (one dispatch) against the
    same set streamed batch by batch: equal loss, accuracy and
    predictions."""
    from leaffliction_tpu_torch.data.loader import (
        BatchIterator,
        DeviceImageStore,
    )

    rng = np.random.default_rng(9)
    n = 11  # three batches, the last one padded
    images = torch.from_numpy(rng.integers(0, 256, (n, S, S, 3), np.uint8))
    labels = rng.integers(0, K_CLASSES, n)
    store = DeviceImageStore(labels, S)
    store.images = images.numpy()  # streamed path: host pixels
    store.host_pixels = True
    state = steps.train_state_for(init_model(_model("leafcnn"), 1))
    fns = steps.build_step_fns(CONFIGS["regularized"], K_CLASSES, 10)
    val = BatchIterator(store, B, shuffle=False)
    whole = trainer.evaluate(fns, state, val, device_data=(
        images, torch.from_numpy(labels.astype(np.int64))))
    batched = trainer.evaluate(fns, state, val)
    assert whole[:2] == batched[:2]
    np.testing.assert_array_equal(whole[2], batched[2])
    np.testing.assert_array_equal(whole[3], batched[3])


# --- the hyper table --------------------------------------------------------

@pytest.mark.parametrize("name", list(CONFIGS))
def test_hyper_table_is_the_single_steps_f32(name):
    """Every row (lr, 1 − b1^c, 1 − b2^c) equals, bit for bit, the f32
    values the single step computed on the host before it read them from
    the device (`float(np.float32(schedule(step)) *
    np.float32(lr_scale))` and `float(np.float32(1) - np.float32(b) **
    np.float32(step + 1))`)."""
    fns = steps.build_step_fns(CONFIGS[name], K_CLASSES, 37)
    state = steps.train_state_for(LeafCNN(3, (4,)))
    for lr_scale in (1.0, 0.3, 0.09):
        state.lr_scale, state.step = lr_scale, 0
        table = fns.hyper_table(state, 41)
        assert table.dtype == np.float32 and table.shape == (41, 3)
        for s in range(41):
            lr = float(np.float32(fns.schedule(s)) * np.float32(lr_scale))
            count = np.float32(s + 1)
            bc1 = float(np.float32(1.0) - np.float32(steps.B1) ** count)
            bc2 = float(np.float32(1.0) - np.float32(steps.B2) ** count)
            want = np.asarray([lr, bc1, bc2], np.float32)
            assert want.astype(np.float64).tolist() == [lr, bc1, bc2]
            assert table[s].tobytes() == want.tobytes()
        state.step = 5  # a later dispatch starts at the state's step
        assert fns.hyper_table(state, 3).tobytes() == table[5:8].tobytes()


# --- the scripted fit against the JAX fit -----------------------------------

def _jax_chain_fns(script):
    fns = _jax_step_fns(script)

    def chain(state, images, labels, mask, key):
        ms = []
        for i in range(mask.shape[0]):
            state, m = fns.train_step(state, images[i], labels[i], mask[i],
                                      key)
            ms.append(m)
        return state, {k: jnp.stack([m[k] for m in ms]) for k in ms[0]}

    return dataclasses.replace(fns, train_step_chain=chain)


class _Logged:
    """A logger whose `info` records the step each "step %d" line names."""

    def __init__(self, real):
        self.real, self.steps = real, []

    def info(self, msg, *args):
        if msg.startswith("step %d"):
            self.steps.append(args[0])

    def __getattr__(self, name):
        return getattr(self.real, name)


def _fit_both_chained(script, k, monkeypatch):
    port_cb, jax_cb = [], []
    port_log = _Logged(trainer.LOGGER)
    jax_log = _Logged(jax_trainer.LOGGER)
    monkeypatch.setattr(trainer, "LOGGER", port_log)
    monkeypatch.setattr(jax_trainer, "LOGGER", jax_log)
    state = steps.train_state_for(LeafCNN(3, (4,)))
    state.lr_scale = script.lr_scale
    with torch.no_grad():
        for prm in state.model.parameters():
            prm.zero_()
        for v in state.ema_params.values():
            v.fill_(script.ema_init)
    port = trainer.fit(
        ScriptedSteps(script), state, *_iters(), script.cfg,
        epochs=script.epochs, seed=0, target_val_acc=script.target_val_acc,
        log_every=2, chain_steps=k,
        step_callback=lambda e, s, st, g: port_cb.append((e, s)),
        **_resume_kwargs(script))
    jstate = JaxState(
        params={"p": jnp.zeros((), jnp.float32)}, batch_stats={},
        ema_params={"p": jnp.full((), script.ema_init, jnp.float32)},
        ema_batch_stats={},
        lr_scale=jnp.asarray(script.lr_scale, jnp.float32))
    ref = jax_trainer.fit(
        _jax_chain_fns(script), jstate, *_iters(), script.cfg,
        epochs=script.epochs, seed=0, target_val_acc=script.target_val_acc,
        log_every=2, chain_steps=k,
        step_callback=lambda e, s, st: jax_cb.append((e, s)),
        **_resume_kwargs(script))
    assert port.history == ref.history
    assert (port.steps_ran, port.epochs_ran) == (ref.steps_ran,
                                                 ref.epochs_ran)
    assert port_cb == jax_cb
    assert port_log.steps == jax_log.steps
    assert float(state.model.Dense_0.bias.detach()[0]) == \
        float(ref.state.params["p"])
    return port, port_cb, port_log.steps


_SO_FAR = {"loss": [1.0], "accuracy": [0.0], "val_loss": [0.5],
           "val_accuracy": [0.5]}


@pytest.mark.parametrize("k,script,callbacks,logged", [
    # 3 steps an epoch: a chunk of 2 and a single; a dispatch logs when it
    # crosses a multiple of 2 (steps 2, 5, 6 and 8, not 9)
    (2, Script(TrainConfig.fast(), [1.0, 0.75, 0.5], epochs=3),
     [(0, 2), (0, 3), (1, 2), (1, 3), (2, 2), (2, 3)], [2, 5, 6, 8]),
    (3, Script(TrainConfig.fast(), [1.0, 0.75], epochs=2),
     [(0, 3), (1, 3)], [3, 6]),
    # resumed in epoch 2 after its first chunk (skip_steps 2 under k = 2)
    (2, Script(TrainConfig.fast(), [1.0, 0.75], epochs=3, start_epoch=1,
               history=_SO_FAR, skip_steps=2),
     [(1, 3), (2, 2), (2, 3)], [3, 4]),
], ids=["k2_remainder", "k3_whole_epoch", "k2_resumed_on_a_chunk"])
def test_chained_fit_matches_jax_fit(k, script, callbacks, logged,
                                     monkeypatch):
    _, got_cb, got_log = _fit_both_chained(script, k, monkeypatch)
    assert got_cb == callbacks and got_log == logged


def _tiny_run(chain_steps, skip_steps=0, start=None, kill_after=None,
              kept=None):
    """A tiny LeafCNN (augmentation and dropout on) through `fit` for 2
    epochs of 5 steps (streamed batches of 4); `start` = (state tensors,
    generator state, step) resumes at `skip_steps` of epoch 1;
    `kill_after` keeps the state in `kept["start"]` once that many steps
    of the first epoch ran, then raises from the step callback."""
    from leaffliction_tpu_torch.data.loader import (
        BatchIterator,
        DeviceImageStore,
    )

    rng = np.random.default_rng(4)
    stores = []
    for n in (18, 6):
        store = DeviceImageStore(rng.integers(0, K_CLASSES, n), S)
        store.images = rng.integers(0, 256, (n, S, S, 3), np.uint8)
        store.host_pixels = True
        stores.append(store)
    state = steps.train_state_for(init_model(_model("leafcnn"), 2))
    if start is not None:
        tensors, _, state.step = start
        with torch.no_grad():
            for k, v in _tensors(state).items():
                v.copy_(tensors[k])

    def callback(epoch, step_in_epoch, st, gen):
        if kill_after is not None and step_in_epoch == kill_after:
            kept["start"] = ({k: v.clone() for k, v in _tensors(st).items()},
                             gen.get_state(), st.step)
            raise RuntimeError("simulated kill")

    cfg = dataclasses.replace(CONFIGS["regularized"], plateau_patience=9,
                              early_stop_patience=9)
    return trainer.fit(
        steps.build_step_fns(cfg, K_CLASSES, 10), state,
        BatchIterator(stores[0], B, shuffle=True, seed=1),
        BatchIterator(stores[1], B, shuffle=False), cfg, epochs=2, seed=6,
        chain_steps=chain_steps, step_callback=callback,
        skip_steps=skip_steps,
        generator_state=None if start is None else start[1])


@pytest.mark.parametrize("killed_k,resumed_k", [(1, 3), (3, 2)])
def test_resume_under_another_k_is_step_exact(killed_k, resumed_k):
    """A run killed after its first dispatch under one k and resumed under
    another (the resumed epoch's chunks then start at the checkpoint) ends
    in the state, step and generator state of the uninterrupted run under
    the resumed k, exactly; so does the uninterrupted k = 1 run."""
    ref = _tiny_run(resumed_k)
    kept = {}
    with pytest.raises(RuntimeError, match="simulated kill"):
        _tiny_run(killed_k, kill_after=killed_k, kept=kept)
    got = _tiny_run(resumed_k, skip_steps=killed_k, start=kept["start"])
    _assert_same_state(got.state, ref.state)
    assert torch.equal(got.generator_state, ref.generator_state)
    assert got.steps_ran == 2 * 5 - killed_k
    eager = _tiny_run(1)
    _assert_same_state(eager.state, ref.state)
    assert eager.history == ref.history


# --- the train CLI ----------------------------------------------------------

@pytest.fixture(scope="module")
def manifest(tiny_dataset, tmp_path_factory):
    from leaffliction_tpu.cli import split as split_cli

    out = tmp_path_factory.mktemp("split")
    split_cli.main(["--src", str(tiny_dataset), "--out", str(out),
                    "--val-ratio", "0.25", "--seed", "32"])
    return out / "manifest_split.json"


@pytest.fixture(scope="module")
def one_step_run(manifest, tmp_path_factory):
    out = tmp_path_factory.mktemp("k1")
    run = train_cli.main(_flags(manifest, out, "--epochs", "2",
                                "--steps-per-dispatch", "1"))
    return out, run["fit"]


@pytest.mark.parametrize("k", [3, 4])
def test_cli_chained_equals_one_step(manifest, one_step_run, tmp_path, k,
                                     capsys):
    """4 train steps an epoch: k = 4 is one chunk an epoch, k = 3 a chunk
    and a single; `history.json`, the weights file and the final state
    equal the k = 1 run's exactly."""
    ref_out, ref = one_step_run
    capsys.readouterr()
    out = tmp_path / "m"
    run = train_cli.main(_flags(manifest, out, "--epochs", "2",
                                "--steps-per-dispatch", str(k)))
    assert f"Chaining {k} train steps per dispatch" in capsys.readouterr().out
    got = run["fit"]
    _assert_same_state(got.state, ref.state)
    assert torch.equal(got.generator_state, ref.generator_state)
    assert got.steps_ran == ref.steps_ran == 8
    for name in ("history.json", "leaf_cnn.msgpack",
                 "confusion_matrix.json"):
        assert (out / name).read_bytes() == (ref_out / name).read_bytes()


def test_cli_chained_step_saves_match_the_jax_cli(manifest, tmp_path,
                                                   monkeypatch):
    """`--steps-per-dispatch 4 --checkpoint-every-steps 2` through both
    CLIs, every cadence firing: the callbacks land on chunk boundaries
    (global steps 4 and 8) and both save the same steps with the same
    (epoch, step_in_epoch)."""
    from leaffliction_tpu.cli import train as jax_train_cli
    from leaffliction_tpu.train import checkpoint as jck
    from leaffliction_tpu_torch.train import checkpoint as ck
    from test_torch_resume import _waiting

    flags = ["--manifest", str(manifest), "--epochs", "2", "--batch-size",
             "8", "--img-size", "32", "--scale", "tiny", "--fast",
             "--no-mixed-precision", "--checkpoint-every-steps", "2",
             "--steps-per-dispatch", "4"]
    with saves_waiting() as port_calls:
        train_cli.main(flags + ["--device", "cpu", "--out-dir",
                                str(tmp_path / "port")])
    jax_calls = []
    monkeypatch.setattr(jck.AsyncStepCheckpointer, "maybe_save", _waiting(
        jck.AsyncStepCheckpointer.maybe_save, jax_calls))
    jax_train_cli.main(flags + ["--no-export-keras", "--out-dir",
                                str(tmp_path / "jax")])
    assert port_calls == jax_calls == [(4, 0, 4, True), (8, 1, 4, True)]
    assert ck.latest_resume_step(tmp_path / "port" / "checkpoints") == \
        jck.latest_resume_step(tmp_path / "jax" / "checkpoints") == 8


@pytest.mark.parametrize("requested,device,per_epoch,want", [
    (-1, "cpu", 10, 1), (-1, "cuda", 10, 8), (-1, "cuda", 5, 5),
    (4, "cpu", 10, 4), (4, "cpu", 3, 3), (0, "cuda", 10, 1),
    (1, "cuda", 10, 1),
])
def test_steps_per_dispatch_resolves_as_the_jax_cli(requested, device,
                                                    per_epoch, want):
    assert train_cli.resolve_chain_steps(
        requested, torch.device(device), per_epoch) == want


def test_cli_default_runs_one_step_a_dispatch_on_the_cpu(manifest, tmp_path,
                                                         capsys, monkeypatch):
    """`--steps-per-dispatch` left at -1 on the CPU: no chaining logged and
    one step a dispatch."""
    real, sizes = steps.StepFns._dispatch, []

    def recording(self, state, generator, mask, **batches):
        sizes.append(mask.shape[0])
        return real(self, state, generator, mask, **batches)

    monkeypatch.setattr(steps.StepFns, "_dispatch", recording)
    capsys.readouterr()
    run = train_cli.main(_flags(manifest, tmp_path / "m", "--epochs", "1"))
    assert "Chaining" not in capsys.readouterr().out
    assert run["fit"].steps_ran == 4 and sizes == [1] * 4
