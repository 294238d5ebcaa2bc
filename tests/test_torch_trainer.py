"""The PyTorch port's `fit` loop against the JAX package's `fit`.

Scripted step functions stand in for the model's steps on both sides, so
that each epoch's val_loss is given: every train step adds 1 to every
parameter, and the eval step returns the next scripted val_loss. The JAX
side runs `leaffliction_tpu.train.trainer.fit` on a one-device mesh with the
same script. Both must agree exactly on the loop's bookkeeping: the
history, epochs and steps run, ReduceLROnPlateau (patience, ×factor into
`lr_scale`), EarlyStopping restoring the weights of the best epoch, the stop
at `target_val_acc`, and the base-vs-EMA winner. All scripted values are
dyadic, so f32 and f64 arithmetic give the same numbers.
"""

import dataclasses
from typing import Any, Optional

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from leaffliction_tpu.data.loader import BatchIterator, DeviceImageStore  # noqa: E402
from leaffliction_tpu.parallel.mesh import MeshSpec, make_mesh  # noqa: E402
from leaffliction_tpu.train import trainer as jax_trainer  # noqa: E402
from leaffliction_tpu.train.steps import StepFns as JaxStepFns  # noqa: E402
from leaffliction_tpu_torch.models.leafcnn import LeafCNN  # noqa: E402
from leaffliction_tpu_torch.train.config import TrainConfig  # noqa: E402
from leaffliction_tpu_torch.train.steps import train_state_for  # noqa: E402
from leaffliction_tpu_torch.train.trainer import fit  # noqa: E402

torch.set_num_threads(1)

N_TRAIN, N_VAL, BATCH = 10, 4, 4   # 3 train steps per epoch, 1 val batch


@dataclasses.dataclass
class Script:
    cfg: TrainConfig
    val_losses: list
    epochs: int
    val_acc: float = 0.5
    ema_acc: Optional[float] = None
    target_val_acc: Optional[float] = None
    ema_init: float = 0.0        # the EMA weights' value before training
    # a resumed run: where it starts, the history so far, the steps of the
    # first epoch already run, and the restored state's lr_scale
    start_epoch: int = 0
    history: Optional[dict] = None
    skip_steps: int = 0
    lr_scale: float = 1.0

    def val_loss(self, i: int) -> float:
        return self.val_losses[i] if i < len(self.val_losses) else 9.0


class ScriptedSteps:
    """The port's side: steps over a `TrainState` of the port."""

    def __init__(self, script: Script):
        self.script = script
        self.evals = 0

    def train_step(self, state, images, labels, mask, generator):
        with torch.no_grad():
            for p in state.model.parameters():
                p.add_(1.0)
        state.step += 1
        return {"loss": torch.tensor(1.0), "correct": mask.sum() * 0,
                "n": mask.sum(), "lr": 0.0}

    def train_step_chain(self, state, images, labels, mask, generator):
        """K scripted steps (`fit` dispatches a chunk [K, B], a single
        batch as K = 1)."""
        ms = [self.train_step(state, images[i], labels[i], mask[i],
                              generator) for i in range(len(mask))]
        return {k: torch.stack([torch.as_tensor(m[k]) for m in ms])
                for k in ("loss", "correct", "n")} | {
            "lr": np.asarray([m["lr"] for m in ms])}

    def eval_step(self, state, images, labels, mask, use_ema=False):
        n = mask.sum()
        if use_ema:
            acc, loss = self.script.ema_acc, 1.0
        else:
            acc, loss = self.script.val_acc, self.script.val_loss(self.evals)
            self.evals += 1
        return ({"loss_sum": torch.tensor(loss) * n,
                 "correct": torch.tensor(acc) * n, "n": n},
                torch.zeros(len(mask), dtype=torch.long))


@dataclasses.dataclass(frozen=True)
class JaxState:
    """The fields of the JAX `TrainState` that `fit` reads and replaces."""

    params: Any
    batch_stats: Any
    ema_params: Any
    ema_batch_stats: Any
    lr_scale: Any

    def replace(self, **kw) -> "JaxState":
        return dataclasses.replace(self, **kw)


def _jax_step_fns(script: Script) -> JaxStepFns:
    """The same script as `ScriptedSteps`, as the JAX `fit` calls it."""
    evals = [0]

    def train_step(state, images, labels, mask, key):
        n = jnp.sum(mask)
        state = state.replace(params=jax.tree_util.tree_map(
            lambda p: p + 1.0, state.params))
        return state, {"loss": jnp.float32(1.0), "correct": n * 0, "n": n,
                       "lr": jnp.float32(0.0)}

    def eval_with(use_ema):
        def eval_step(state, images, labels, mask):
            n = jnp.sum(mask)
            if use_ema:
                acc, loss = script.ema_acc, 1.0
            else:
                acc, loss = script.val_acc, script.val_loss(evals[0])
                evals[0] += 1
            return ({"loss_sum": jnp.float32(loss) * n,
                     "correct": jnp.float32(acc) * n, "n": n},
                    jnp.zeros(mask.shape[0], jnp.int32))
        return eval_step

    return JaxStepFns(
        train_step=train_step, train_step_chain=None, train_step_gather=None,
        eval_step=eval_with(False), eval_step_ema=eval_with(True),
        eval_step_gather=None, eval_step_ema_gather=None,
        mesh=make_mesh(MeshSpec(data=1, model=1), devices=jax.devices()[:1]))


def _iters():
    train = DeviceImageStore(np.arange(N_TRAIN) % 3, 8)
    val = DeviceImageStore(np.arange(N_VAL) % 3, 8)
    return (BatchIterator(train, BATCH, shuffle=True, seed=0),
            BatchIterator(val, BATCH, shuffle=False))


def _resume_kwargs(script: Script):
    history = (None if script.history is None
               else {k: list(v) for k, v in script.history.items()})
    return {"start_epoch": script.start_epoch, "history": history,
            "skip_steps": script.skip_steps}


def _run_port(script: Script):
    state = train_state_for(LeafCNN(3, (4,)))
    state.lr_scale = script.lr_scale
    with torch.no_grad():
        for p in state.model.parameters():
            p.zero_()
        for v in state.ema_params.values():
            v.fill_(script.ema_init)
    kwargs = _resume_kwargs(script)
    result = fit(ScriptedSteps(script), state, *_iters(), script.cfg,
                 epochs=script.epochs, seed=0,
                 target_val_acc=script.target_val_acc, **kwargs)
    if kwargs["history"] is not None:
        assert result.history is kwargs["history"]  # extended in place
    return result, {
        "history": result.history, "epochs_ran": result.epochs_ran,
        "steps_ran": result.steps_ran, "best_variant": result.best_variant,
        "val_accuracy": result.val_accuracy,
        "lr_scale": float(np.float32(state.lr_scale)),
        "param": float(state.model.Dense_0.bias.detach()[0])}


def _run_jax(script: Script):
    state = JaxState(
        params={"p": jnp.zeros((), jnp.float32)}, batch_stats={},
        ema_params={"p": jnp.full((), script.ema_init, jnp.float32)},
        ema_batch_stats={},
        lr_scale=jnp.asarray(script.lr_scale, jnp.float32))
    result = jax_trainer.fit(_jax_step_fns(script), state, *_iters(),
                             script.cfg, epochs=script.epochs, seed=0,
                             target_val_acc=script.target_val_acc,
                             **_resume_kwargs(script))
    return {
        "history": result.history, "epochs_ran": result.epochs_ran,
        "steps_ran": result.steps_ran, "best_variant": result.best_variant,
        "val_accuracy": result.val_accuracy,
        "lr_scale": float(np.float32(result.state.lr_scale)),
        "param": float(result.state.params["p"])}


def _fit_both(script: Script):
    result, port = _run_port(script)
    assert port == _run_jax(script)
    return result, port


def test_plateau_then_early_stop_restores_the_best_epoch():
    cfg = dataclasses.replace(TrainConfig.fast(), plateau_patience=2,
                              early_stop_patience=3)
    result, port = _fit_both(Script(cfg, [1.0, 0.5, 0.625, 0.75, 0.875],
                                    epochs=10))
    assert result.epochs_ran == 5 and result.steps_ran == 15
    assert result.history["val_loss"] == [1.0, 0.5, 0.625, 0.75, 0.875]
    assert port["lr_scale"] == pytest.approx(0.3)   # one plateau, at epoch 4
    assert port["param"] == 6.0                      # the weights of epoch 2
    assert result.best_variant == "base"             # FAST keeps no EMA


def test_target_accuracy_stops_and_ema_wins_when_better():
    result, port = _fit_both(Script(
        TrainConfig.regularized(), [1.0, 0.875, 0.75], epochs=3,
        val_acc=0.5, ema_acc=0.75, target_val_acc=0.5, ema_init=-2.0))
    assert result.epochs_ran == 1 and len(result.history["loss"]) == 1
    assert result.best_variant == "ema"
    assert result.val_accuracy == pytest.approx(0.75)
    assert port["param"] == -2.0                     # the EMA weights kept


@pytest.mark.parametrize("script", [
    # REGULARIZED defaults: a plateau at epoch 4 and another at epoch 7,
    # then the early stop restores epoch 1
    Script(TrainConfig.regularized(),
           [1.0, 1.25, 1.5, 1.75, 2.0, 2.25, 2.5], epochs=10,
           val_acc=0.5, ema_acc=0.25),
    # ties are not improvements (min_delta 0)
    Script(dataclasses.replace(TrainConfig.fast(), plateau_patience=2,
                               early_stop_patience=4),
           [1.0, 1.0, 1.0, 1.0, 1.0], epochs=8),
    # a falling loss runs every epoch; a tied EMA keeps the base weights
    Script(TrainConfig.regularized(), [1.0, 0.75, 0.5, 0.25], epochs=4,
           val_acc=0.5, ema_acc=0.5, target_val_acc=0.75, ema_init=-3.0),
], ids=["two_plateaus_then_stop", "ties_plateau", "full_run_ema_tie"])
def test_fit_matches_jax_fit(script):
    _fit_both(script)


_SO_FAR = {"loss": [1.0, 1.0], "accuracy": [0.0, 0.0],
           "val_loss": [0.5, 0.25], "val_accuracy": [0.5, 0.5]}


@pytest.mark.parametrize("script", [
    # resumed in epoch 3 after 1 of its 3 steps, with the restored
    # lr_scale 0.3: the restored scale holds until a plateau, which then
    # multiplies a fresh 1.0 (fresh counters: the plateau needs 2 epochs
    # of the resumed run, not of the whole history)
    Script(dataclasses.replace(TrainConfig.fast(), plateau_patience=2,
                               early_stop_patience=3),
           [1.0, 1.25, 1.5, 1.75], epochs=8, start_epoch=2,
           history=_SO_FAR, skip_steps=1, lr_scale=0.3),
    # an epoch checkpoint: the next epoch, nothing skipped; the fresh best
    # val_loss takes the first resumed epoch as an improvement
    Script(TrainConfig.regularized(), [2.0, 1.5, 1.75], epochs=5,
           start_epoch=2, history=_SO_FAR, val_acc=0.5, ema_acc=0.25),
    # every step of the resumed epoch already run: its train metrics are
    # empty, its val entry still appended
    Script(TrainConfig.fast(), [0.75], epochs=3, start_epoch=2,
           history=_SO_FAR, skip_steps=3),
], ids=["mid_epoch_fresh_plateau", "epoch_checkpoint", "whole_epoch_skipped"])
def test_resumed_fit_matches_jax_fit(script):
    """`start_epoch`, `history` and `skip_steps` as the JAX `fit` takes
    them: the same history (extended, not restarted), steps run, weights
    and plateau multiplier, with the early-stop and plateau counters
    started afresh as JAX starts them."""
    result, port = _fit_both(script)
    assert len(result.history["loss"]) == result.epochs_ran
    assert result.history["val_loss"][:2] == _SO_FAR["val_loss"]
    if script.lr_scale != 1.0:  # one plateau: 0.3 of a fresh 1.0
        assert result.steps_ran == 11 and port["lr_scale"] == \
            pytest.approx(0.3)
