"""One rank of a data-parallel run of the PyTorch port, for the DP tests.

    RANK=r WORLD_SIZE=P MASTER_ADDR=127.0.0.1 MASTER_PORT=n \
        python tests/torch_dp_worker.py JOB.json

The test launches P of these (`tests/test_torch_ddp.py`,
`tests/test_torch_ddp_cli.py`, `tests/test_torch_tp.py`,
`tests/test_torch_tp_cli.py`) with torchrun's environment; each joins
the gloo group on the CPU through `parallel.distributed.maybe_initialize`,
makes the job's mesh (`mesh_data` × `mesh_model`, data parallel over all
P by default) and runs the job's scenarios in order, writing what the test
compares into the job's directory as `<scenario>_rank<r>.pt`. It imports
torch, numpy and the port, never JAX (the test process holds the JAX
side).

Scenarios:
- `bn`: sync `bn_train` on this rank's rows of a global batch: y, mean,
  var, and dx, dγ, dβ for a given dy;
- `steps`: `StepFns.train_step` on this rank's rows for a few steps from
  a given state (LeafCNN, plain or separable, or a ResNet; tensor
  parallel on a `model` axis, sharded at `min_size`), the augmentation
  draws injected for the global batch or the port's own; the metrics of
  every step, the state after the first and the last (gathered to full
  tensors when sharded, and then also as gathered straight after the
  sharding), the generator, K1's launches and the number of sharded
  keys;
- `cli`: `cli.train.main(argv)` in this process (the group stays joined
  across scenarios), with `kill_after` steps it raises from the step
  checkpointer's `maybe_save` at that call, with `augment` false the
  step functions skip the augmentation; the fit result's counts, the
  history, the final model, the calls that wrote artifacts, the fused
  balance's `write_artifacts` flags and the `check_replicated` digests;
- `replicated`: `check_replicated` on equal copies and on copies that
  differ on rank 1;
- `block`: one LeafCNN `ResBlock` (cin → features) in training mode,
  column-parallel over the model group (sharded at `min_size`): its output
  gathered, the full input's gradient and the parameters' gradients
  (gathered) for a given output gradient;
- `prefetch`: `streamed_against_gather` on this rank: `fit` and
  `evaluate` on the streamed path (`prefetch_to_device` on this rank's
  rows) and on the gather path, from the same state and seed.

`streamed_against_gather` is also what the one-process prefetch tests run
(`tests/test_torch_prefetch.py`, with no mesh).
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from leaffliction_tpu_torch.parallel import distributed  # noqa: E402
from leaffliction_tpu_torch.parallel.mesh import (  # noqa: E402
    MeshSpec,
    make_mesh,
)


class Killed(RuntimeError):
    """Raised in place of a step checkpoint to stop a run mid-epoch."""


def scenario_bn(job, mesh):
    from leaffliction_tpu_torch.ops.fused_bn import bn_train

    data = np.load(job["inputs"])
    dtype = getattr(torch, job["dtype"])
    rows = mesh.rows(data["x"].shape[0])
    x = torch.from_numpy(data["x"][rows]).to(dtype).requires_grad_(True)
    scale = torch.from_numpy(data["scale"]).requires_grad_(True)
    bias = torch.from_numpy(data["bias"]).requires_grad_(True)
    y, mean, var = bn_train(x, scale, bias, float(job["eps"]), mesh.group)
    dx, dg, db = torch.autograd.grad(
        y, (x, scale, bias), torch.from_numpy(data["dy"][rows]).to(dtype))
    return {"y": y.detach(), "mean": mean, "var": var, "dx": dx, "dg": dg,
            "db": db}


def scenario_steps(job, mesh):
    from leaffliction_tpu_torch.models.leafcnn import LeafCNN
    from leaffliction_tpu_torch.models.resnet import build_resnet
    from leaffliction_tpu_torch.ops import train_augment
    from leaffliction_tpu_torch.parallel.tensor import shard_train_state
    from leaffliction_tpu_torch.train import steps
    from leaffliction_tpu_torch.train.config import TrainConfig

    from leaffliction_tpu_torch.ops.kernels.rotate import train_aug

    data = np.load(job["inputs"])
    device = mesh.device
    if job.get("arch", "leafcnn") == "leafcnn":
        model = LeafCNN(job["classes"], tuple(job["widths"]),
                        separable=job.get("separable", False),
                        drop_block=job["drop_block"],
                        drop_top=job["drop_top"])
    else:
        model = build_resnet(job["classes"], job["arch"])
        model.drop_top = job["drop_top"]
    model.load_state_dict({k[len("sd."):]: torch.from_numpy(data[k])
                           for k in data.files if k.startswith("sd.")})
    state = steps.train_state_for(model.to(device))
    plan, zero = {}, {}
    if mesh.model > 1:  # and straight back: shard → gather
        plan = shard_train_state(state, mesh, job.get("min_size", 64))
        zero = {f"step0.{k}": v.cpu().clone()
                for k, v in _state_tensors(state).items()}
    cfg = getattr(TrainConfig, job["config"])()
    fns = steps.build_step_fns(cfg, job["classes"], job["total_steps"],
                               augment=job["augment"], mesh=mesh)
    gen = torch.Generator(device=device).manual_seed(job["seed"])
    n_steps = data["images"].shape[0]
    drawn = iter(range(n_steps))
    real_draw = train_augment.draw_params
    if "flip" in data.files:  # JAX's draws for the global batch, step i
        def injected(n, generator, device, *args):
            i = next(drawn)
            assert n == data["flip"].shape[1], n
            return tuple(torch.from_numpy(data[k][i]).to(device)
                         for k in ("flip", "angles", "factors"))

        train_augment.draw_params = injected
    rows = mesh.rows(data["images"].shape[1])
    metrics, first = [], {}
    train_aug.launches = 0
    try:
        for i in range(n_steps):
            m = fns.train_step(
                state, torch.from_numpy(data["images"][i][rows]).to(device),
                torch.from_numpy(data["labels"][i][rows]).long().to(device),
                torch.from_numpy(data["mask"][i][rows]).to(device), gen)
            metrics.append([float(m["loss"]), float(m["correct"]),
                            float(m["n"]), m["lr"]])
            if i == 0:
                first = {f"step1.{k}": v.cpu().clone()
                         for k, v in _state_tensors(state).items()}
    finally:
        train_augment.draw_params = real_draw
    return {"metrics": torch.tensor(metrics, dtype=torch.float64),
            **{k: v.cpu() for k, v in _state_tensors(state).items()},
            **first, **zero, "generator": gen.get_state(),
            "k1_launches": torch.tensor(train_aug.launches),
            "n_sharded": torch.tensor(sum(plan.values()))}


def _state_tensors(state):
    """model.*, mu.*, nu.* and ema.* tensors of a TrainState, full (a
    sharded state's gathered over the model group)."""
    from leaffliction_tpu_torch.parallel.tensor import full_sections

    s = full_sections(state)
    return {**{f"model.{k}": v for k, v in s["model"].items()},
            **{f"mu.{k}": v for k, v in s["mu"].items()},
            **{f"nu.{k}": v for k, v in s["nu"].items()},
            **{f"ema.{k}": v for k, v in {**s["ema_params"],
                                          **s["ema_batch_stats"]}.items()}}


def scenario_cli(job, mesh):
    from leaffliction_tpu_torch.cli import train as train_cli
    from leaffliction_tpu_torch.train import artifacts, checkpoint, steps
    from leaffliction_tpu_torch.train.artifacts import full_state_dict

    wrote = []
    real_save = artifacts.save_training_artifacts

    def counting(out_dir, *args, **kwargs):
        wrote.append(str(out_dir))
        return real_save(out_dir, *args, **kwargs)

    artifacts.save_training_artifacts = counting
    real_maybe_save = checkpoint.AsyncStepCheckpointer.maybe_save
    calls = [0]
    kill_after = job.get("kill_after")

    def maybe_save(self, *args, **kwargs):
        calls[0] += 1
        if kill_after is not None and calls[0] == kill_after:
            if self._inflight is not None:  # let the save in flight land
                self._inflight.result()
            raise Killed(f"killed at step {calls[0]}")
        return real_maybe_save(self, *args, **kwargs)

    checkpoint.AsyncStepCheckpointer.maybe_save = maybe_save
    real_build = steps.build_step_fns
    if not job.get("augment", True):
        def build_step_fns(*args, **kwargs):
            return real_build(*args, **{**kwargs, "augment": False})

        steps.build_step_fns = build_step_fns
    # the fused balance's artifact flags and the replication checks
    from leaffliction_tpu_torch.data import fused_balance
    from leaffliction_tpu_torch.parallel import mesh as mesh_mod

    flags, digests = [], []
    real_fused = {n: getattr(fused_balance, n) for n in
                  ("balance_to_device", "split_fused_result")}
    real_check = mesh_mod.check_replicated

    def flagged(name):
        def call(*args, **kwargs):
            flags.append((name, kwargs.get("write_artifacts")))
            return real_fused[name](*args, **kwargs)
        return call

    def checking(t, m, what="tensor"):
        digests.append((what, real_check(t, m, what)))
        return digests[-1][1]

    for name in real_fused:
        setattr(fused_balance, name, flagged(name))
    mesh_mod.check_replicated = checking
    os.chdir(job["cwd"])
    try:
        run = train_cli.main(job["argv"])
        killed = False
    except Killed:
        run, killed = None, True
    finally:
        artifacts.save_training_artifacts = real_save
        checkpoint.AsyncStepCheckpointer.maybe_save = real_maybe_save
        steps.build_step_fns = real_build
        for name, fn in real_fused.items():
            setattr(fused_balance, name, fn)
        mesh_mod.check_replicated = real_check
    out = {"killed": killed, "wrote": wrote, "step_callbacks": calls[0],
           "balance_flags": flags, "replicated": digests}
    if run is not None:
        fit = run["fit"]
        out.update(steps_ran=fit.steps_ran, epochs_ran=fit.epochs_ran,
                   history=fit.history, best_variant=fit.best_variant,
                   mesh=run["mesh"].shape)
        out["state"] = {f"model.{k}": v.clone() for k, v in
                        full_state_dict(fit.state).items()}
    return out


def scenario_block(job, mesh):
    from leaffliction_tpu_torch.models.leafcnn import ResBlock
    from leaffliction_tpu_torch.parallel.tensor import (
        gather_channels,
        gather_tensors,
        plan_for,
        shard_model,
    )

    data = np.load(job["inputs"])
    block = ResBlock(job["cin"], job["features"], job.get("separable", False),
                     torch.float32)
    block.load_state_dict({k[len("sd."):]: torch.from_numpy(data[k])
                           for k in data.files if k.startswith("sd.")})
    block.to(mesh.device)
    plan = plan_for(block, mesh, job["min_size"])
    shard_model(block, plan, mesh)
    x = torch.from_numpy(data["x"]).to(mesh.device).requires_grad_(True)
    y = gather_channels(block(x, train=True), mesh)
    names = [k for k, _ in block.named_parameters()]
    grads = torch.autograd.grad(
        y, [x] + [p for _, p in block.named_parameters()],
        torch.from_numpy(data["dy"]).to(mesh.device))
    full = gather_tensors(dict(zip(names, grads[1:])), plan, mesh)
    return {"y": y.detach().cpu(), "dx": grads[0].cpu(),
            **{f"grad.{k}": v.cpu() for k, v in full.items()},
            "n_sharded": torch.tensor(sum(plan.values()))}


def scenario_replicated(job, mesh):
    """`check_replicated` on a tensor every rank holds alike, and on one
    that rank 1 holds otherwise: the digest, then the error each rank
    raised."""
    from leaffliction_tpu_torch.parallel.mesh import check_replicated

    same = torch.arange(64, dtype=torch.uint8).view(4, 16)
    digest = check_replicated(same, mesh, "the same tensor")
    try:
        check_replicated(same + (mesh.rank == 1), mesh, "a tensor")
        error = None
    except ValueError as exc:
        error = str(exc)
    return {"digest": digest, "error": error}


class _Store:
    """An in-memory `ImageStore`: uint8 images and int32 labels from a
    seed."""

    def __init__(self, n: int, size: int, classes: int, seed: int) -> None:
        rng = np.random.default_rng(seed)
        self.items: list = []
        self.img_size = size
        self.images = rng.integers(0, 256, (n, size, size, 3), np.uint8)
        self.labels = rng.integers(0, classes, n).astype(np.int32)
        self.valid = np.ones(n, bool)

    def __len__(self) -> int:
        return len(self.labels)

    @property
    def valid_indices(self) -> np.ndarray:
        return np.nonzero(self.valid)[0].astype(np.int32)


class _LocalRows:
    """A batch iterator yielding this rank's rows (`local_batch`) of each
    global batch of `inner`: the streamed path's input that holds the rows
    the gather path takes on a mesh."""

    def __init__(self, inner, mesh) -> None:
        self.inner, self.mesh, self.store = inner, mesh, inner.store

    def steps_per_epoch(self) -> int:
        return self.inner.steps_per_epoch()

    def epoch(self, epoch_idx: int = 0):
        from leaffliction_tpu_torch.train.trainer import local_batch

        for b in self.inner.epoch(epoch_idx):
            yield local_batch(b, self.mesh)


def streamed_against_gather(mesh=None, device="cpu", k: int = 1,
                            skip_steps: int = 0, seed: int = 3,
                            batch: int = 4, epochs: int = 2) -> dict:
    """`fit` then `evaluate` on the streamed path (pixels uploaded by
    `prefetch_to_device`) and on the gather path (a device-resident
    dataset), each from the same fresh tiny LeafCNN state and seed, `k`
    steps a dispatch, the first `skip_steps` steps of the first epoch
    skipped; on a `mesh` (data parallel) both paths take this rank's rows
    of the same global batches of `batch`. → {path: state tensors,
    history, generator state, steps, evaluate's loss, accuracy, y_true and
    y_pred, and the dispatches `prefetch_to_device` handed over}."""
    from leaffliction_tpu_torch.data.loader import BatchIterator
    from leaffliction_tpu_torch.models.leafcnn import LeafCNN
    from leaffliction_tpu_torch.train import steps, trainer
    from leaffliction_tpu_torch.train.config import TrainConfig

    device = torch.device(device)
    classes, size = 3, 16
    train_store = _Store(22, size, classes, seed)
    val_store = _Store(9, size, classes, seed + 1)
    cfg = TrainConfig.regularized()
    real, handed = trainer.prefetch_to_device, []

    def counting(*args, **kwargs):
        for b in real(*args, **kwargs):
            handed.append(len(b.mask))
            yield b

    out = {}
    trainer.prefetch_to_device = counting
    try:
        for path in ("streamed", "gather"):
            handed.clear()
            model = LeafCNN(classes, (8, 16), drop_block=0.1, drop_top=0.3)
            state = steps.create_train_state(model, seed, device)
            fns = steps.build_step_fns(cfg, classes, 100, mesh=mesh)
            train_iter = BatchIterator(train_store, batch, shuffle=True,
                                       seed=seed)
            val_iter = BatchIterator(val_store, batch, shuffle=False)
            if path == "streamed" and fns.data_mesh is not None:
                train_iter = _LocalRows(train_iter, mesh)
            res = trainer.fit(fns, state, train_iter, val_iter, cfg,
                              epochs=epochs, seed=seed,
                              device_dataset=path == "gather",
                              chain_steps=k, skip_steps=skip_steps)
            loss, acc, y_true, y_pred = trainer.evaluate(
                fns, res.state, val_iter,
                device_data=(trainer.put_dataset(val_store, device)
                             if path == "gather" else None))
            out[path] = {
                "state": {key: v.cpu().clone()
                          for key, v in _state_tensors(res.state).items()},
                "history": res.history, "generator": res.generator_state,
                "steps": res.steps_ran, "variant": res.best_variant,
                "eval": (loss, acc, y_true, y_pred),
                "prefetched": len(handed)}
    finally:
        trainer.prefetch_to_device = real
    return out


def scenario_prefetch(job, mesh):
    return {f"k{k}_skip{skip}": streamed_against_gather(
                mesh, mesh.device, k=k, skip_steps=skip)
            for k, skip in job["runs"]}


SCENARIOS = {"bn": scenario_bn, "steps": scenario_steps, "cli": scenario_cli,
             "replicated": scenario_replicated, "block": scenario_block,
             "prefetch": scenario_prefetch}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(job: dict, world: int = 2, timeout: float = 240.0) -> dict:
    """Run `job` (a dict with `dir` and `scenarios`) on `world` worker
    processes over gloo → {scenario name: [rank 0's result, ...]}. Each
    process gets `timeout` seconds (its collectives give up sooner) and is
    killed when it runs over; a non-zero exit raises with its output."""
    import subprocess

    out_dir = Path(job["dir"])
    out_dir.mkdir(parents=True, exist_ok=True)
    job = {"timeout_s": min(120.0, timeout / 2), **job}
    job_file = out_dir / "job.json"
    job_file.write_text(json.dumps(job))
    port = str(_free_port())
    procs, logs = [], [out_dir / f"rank{r}.log" for r in range(world)]
    for r in range(world):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                   WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                   OMP_NUM_THREADS="1")
        # output to files: a full pipe would stall a rank mid-collective
        with logs[r].open("w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, __file__, str(job_file)], env=env,
                stdout=log, stderr=subprocess.STDOUT))
    failed = []
    try:
        for r, p in enumerate(procs):
            try:
                p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
                with logs[r].open("a") as log:
                    log.write(f"\n[rank {r} killed after {timeout} s]")
            if p.returncode != 0:
                failed.append(r)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        raise AssertionError("\n".join(
            f"rank {r} rc={procs[r].returncode}:\n"
            f"{logs[r].read_text()[-3000:]}" for r in failed))
    return {name: [torch.load(out_dir / f"{name}_rank{r}.pt",
                              weights_only=False) for r in range(world)]
            for name, _ in job["scenarios"]}


def main() -> int:
    torch.set_num_threads(1)
    job = json.loads(Path(sys.argv[1]).read_text())
    device = job.get("device", "cpu")
    if device != "cpu":  # the card's f32 is full f32, its cuDNN fixed
        from leaffliction_tpu_torch.core.device import resolve_device

        resolve_device(device)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    distributed.maybe_initialize(device, timeout_s=job.get("timeout_s", 120))
    mesh = make_mesh(MeshSpec(data=job.get("mesh_data", -1),
                              model=job.get("mesh_model", 1)),
                     distributed.rank_device(device))
    out_dir = Path(job["dir"])
    for name, sub in job["scenarios"]:
        result = SCENARIOS[sub["kind"]](sub, mesh)
        torch.save(result, out_dir / f"{name}_rank{mesh.rank}.pt")
        print(f"DP_WORKER_OK {name} rank {mesh.rank}", flush=True)
    distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
