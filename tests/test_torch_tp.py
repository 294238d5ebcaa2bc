"""Tensor parallelism of the PyTorch port on CPU ranks, against JAX.

The shard plan (`parallel.mesh.tp_shardings`) is held exactly against the
JAX package's `tp_shardings` over the whole train state (params, batch
statistics, Adam's moments, the EMA copies) of leafcnn-tiny and -base,
plain and separable, and resnet10, at T ∈ {1, 2, 3, 4} and `min_size` ∈
{32, 64}: the same set of sharded flax paths, and on every sharded leaf
the same block of its last dim on each model index. `from_flax` gives each
rank the block JAX places on its device.

Worker processes (`tests/torch_dp_worker.py`, gloo, each killed if it
outlives its timeout) run the port's tensor-parallel steps; this process
holds the JAX side on conftest's virtual CPU devices:

- four ranks on `data=2 × model=2`, leafcnn-tiny REGULARIZED at 32 px,
  `min_size` 32 (JAX's own test setting), 4 images a data index, three
  steps: against JAX's `build_step_fns` on the same mesh with
  `tp_shardings(min_size=32)` at `tests/test_torch_ddp.py`'s bars (loss
  rtol 1e-5 a step, the counts and LR equal, the first-step state bars;
  with augmentation off also the free-running bars after the third
  step), with augmentation off and with JAX's draws injected;
- the same mesh with the port's own draws and dropout, plain and
  separable, and a 64-class head (a sharded Dense whose logits are
  gathered), each against one process on the global batch: losses at
  rtol 1e-5, the first-step state bars, the generators equal;
- two ranks on `data=1 × model=2`, resnet10 (every layer from the stem on
  sharded), against one process at `tests/test_torch_train_step.py`'s
  first-step rule for resnet10 (`_assert_resnet_first_step`);
- one column-parallel ResBlock 32 → 64 on `data=1 × model=2`, forward
  and backward, against one process;
- every rank's gathered state bit-equal to every other's after each run
  (replicated leaves alike on all ranks, each block alike across its data
  group), and shard → gather bit-exact before the first step.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec  # noqa: E402

from leaffliction_tpu.models.leafcnn import build_leafcnn as jax_leafcnn  # noqa: E402
from leaffliction_tpu.models.resnet import build_resnet as jax_resnet  # noqa: E402
from leaffliction_tpu.parallel import mesh as jmesh  # noqa: E402
from leaffliction_tpu.train import steps as jsteps  # noqa: E402
from leaffliction_tpu.train.config import TrainConfig  # noqa: E402
from leaffliction_tpu_torch.convert import to_flax, to_state_dict  # noqa: E402
from leaffliction_tpu_torch.models.leafcnn import (  # noqa: E402
    LeafCNN,
    ResBlock,
    build_leafcnn,
    init_model,
)
from leaffliction_tpu_torch.models.resnet import build_resnet  # noqa: E402
from leaffliction_tpu_torch.parallel.mesh import (  # noqa: E402
    Mesh,
    channel_slice,
    tp_shardings,
)
from leaffliction_tpu_torch.parallel.tensor import from_flax  # noqa: E402
from leaffliction_tpu_torch.train import steps  # noqa: E402

import test_torch_ddp as ddp  # noqa: E402
import torch_dp_worker  # noqa: E402

torch.set_num_threads(1)

K, S, B, N_STEPS, MIN = ddp.K, ddp.S, ddp.B, ddp.N_STEPS, 32
D, T = 2, 2


# --- the shard plan -------------------------------------------------------

MODELS = {
    "tiny": lambda sep: (jax_leafcnn(K, "tiny", separable=sep,
                                     lane_fold=False),
                         build_leafcnn(K, "tiny", separable=sep)),
    "base": lambda sep: (jax_leafcnn(K, "base", separable=sep,
                                     lane_fold=False),
                         build_leafcnn(K, "base", separable=sep)),
    "resnet10": lambda sep: (jax_resnet(K, "resnet10", lane_fold=False,
                                        dtype=jnp.float32),
                             build_resnet(K, "resnet10")),
}


def _key_str(path) -> tuple:
    out = []
    for p in path:
        name = getattr(p, "key", getattr(p, "name", getattr(p, "idx", p)))
        out.append(str(name))
    return tuple(out)


def _jax_sharded(state, mesh, min_size):
    """{(section, flax path): the sharding} of JAX's sharded leaves, the
    moments as sections `mu` and `nu`."""
    sh = jmesh.tp_shardings(state, mesh, min_size=min_size)
    found = {}
    for path, s in jax.tree_util.tree_flatten_with_path(sh)[0]:
        if s.spec == PartitionSpec():
            continue
        names = _key_str(path)
        if names[0] == "opt_state":
            i = next(i for i, n in enumerate(names) if n in ("mu", "nu"))
            found[(names[i],) + names[i + 1:]] = s
        else:
            found[names] = s
    return found


def _port_sharded(model, t, min_size):
    """The port's plan as {(section, flax path)} over the same sections."""
    sd = model.state_dict()
    plan = tp_shardings({k: v.shape for k, v in sd.items()}, t, min_size)
    params = {k for k, _ in model.named_parameters()}
    found = set()
    for key, sharded in plan.items():
        if not sharded:
            continue
        tree = to_flax({key: sd[key]})
        coll = next(c for c, sub in tree.items() if sub)
        path, node = [], tree[coll]
        while isinstance(node, dict):
            (name, node), = node.items()
            path.append(name)
        sections = (("params", "mu", "nu", "ema_params") if key in params
                    else ("batch_stats", "ema_batch_stats"))
        assert coll == ("params" if key in params else "batch_stats"), key
        found |= {(sec,) + tuple(path) for sec in sections}
    return plan, found


@pytest.fixture(scope="module")
def jax_states():
    cfg = TrainConfig.regularized()
    out = {}
    for name, build in MODELS.items():
        for sep in ((False, True) if name != "resnet10" else (False,)):
            jm, tm = build(sep)
            out[(name, sep)] = (jsteps.create_train_state(jm, cfg, 32, 0),
                                tm)
    return out


@pytest.mark.parametrize("min_size", [32, 64])
@pytest.mark.parametrize("t", [1, 2, 3, 4])
def test_shard_plan_equals_jax_tp_shardings(jax_states, t, min_size):
    mesh = jmesh.make_mesh(jmesh.MeshSpec(data=1, model=t),
                           devices=jax.devices()[:t])
    for (name, sep), (state, model) in jax_states.items():
        want = _jax_sharded(state, mesh, min_size)
        _, got = _port_sharded(model, t, min_size)
        assert got == set(want), (name, sep, sorted(got ^ set(want))[:6])
        if t == 1:
            assert not got
        for path, s in want.items():
            # a moment has its parameter's shape
            leaf = getattr(state, "params" if path[0] in ("mu", "nu")
                           else path[0])
            for part in path[1:]:
                leaf = leaf[part]
            n = leaf.shape[-1]
            where = s.devices_indices_map(leaf.shape)
            for r in range(t):
                blk = where[mesh.devices[0, r]][-1]
                mine = channel_slice(n, Mesh(data=1, rank=r, device=None,
                                             model=t))
                assert (blk.start or 0, blk.stop or n) == \
                    (mine.start, mine.stop), (path, r)


def test_resnet18_shards_every_conv_at_two(jax_states):
    """ROADMAP's reading of JAX's rule at T=2, min_size 64: every conv,
    BatchNorm and SE Conv_1 of resnet18 is sharded, SE Conv_0 only at
    width 512 (64 outputs), the 8-class head replicated."""
    plan = tp_shardings({k: v.shape for k, v in
                         build_resnet(8, "resnet18").state_dict().items()},
                        2, 64)
    for k, sharded in plan.items():
        if k.startswith("Dense_0") or k.startswith("norm_"):
            assert not sharded, k
        elif ".SEBlock_0.Conv_0." in k:
            assert sharded == (k.startswith("BasicBlock_6.")
                               or k.startswith("BasicBlock_7.")), k
        else:
            assert sharded, k


def test_from_flax_gives_each_rank_its_jax_block():
    """`from_flax` on JAX's variables is, for each model index, the block
    JAX places on that index's device (leafcnn-base, T=2, min_size 64)."""
    jm = jax_leafcnn(K, "base", lane_fold=False)
    state = jsteps.create_train_state(jm, TrainConfig.regularized(), 32, 0)
    mesh = jmesh.make_mesh(jmesh.MeshSpec(data=1, model=2),
                           devices=jax.devices()[:2])
    variables = {"params": state.params, "batch_stats": state.batch_stats,
                 "norm_stats": state.norm_stats}
    placed = jax.device_put(variables,
                            jmesh.tp_shardings(variables, mesh, 64))
    for r in range(2):
        dev = mesh.devices[0, r]
        mine = jax.tree_util.tree_map(
            lambda a: np.asarray(next(s.data for s in a.addressable_shards
                                      if s.device == dev)), placed)
        want = to_state_dict(mine)
        got = from_flax(jax.device_get(variables),
                        Mesh(data=1, rank=r, device=None, model=2))
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), (r, k)


# --- the steps ------------------------------------------------------------

def _one_process(sd, model, images, labels, mask):
    """The port's one process on the global batch → (losses, the state
    after step 1, the final state, the generator)."""
    model.load_state_dict(sd)
    state = steps.train_state_for(model)
    fns = steps.build_step_fns(TrainConfig.regularized(), model.Dense_0
                               .out_features, 20)
    gen = torch.Generator().manual_seed(0)
    losses = []
    for i in range(images.shape[0]):
        losses.append(float(fns.train_step(
            state, torch.from_numpy(images[i]),
            torch.from_numpy(labels[i]).long(), torch.from_numpy(mask[i]),
            gen)["loss"]))
        if i == 0:
            first = {k: v.clone().numpy() for k, v in
                     torch_dp_worker._state_tensors(state).items()}
    return losses, first, gen.get_state()


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp")
    cfg = TrainConfig.regularized()
    model, jstate = ddp._jax_state(cfg)
    images, labels, mask = ddp._batches()
    sd = to_state_dict(jax.device_get(
        {"params": jstate.params, "batch_stats": jstate.batch_stats,
         "norm_stats": jstate.norm_stats}))
    weights = {f"sd.{k}": v.numpy() for k, v in sd.items()}
    np.savez(d / "steps.npz", images=images, labels=labels, mask=mask,
             **weights)
    np.savez(d / "steps_draws.npz", images=images, labels=labels,
             mask=mask, **ddp._jax_draws(N_STEPS, B * D), **weights)
    # a 64-class head: sharded at min_size 32 and T=2
    head = LeafCNN(64, ddp.WIDTHS, drop_block=0.1, drop_top=0.3)
    init_model(head, 3)
    head_sd = {k: v.clone() for k, v in head.state_dict().items()}
    rng = np.random.default_rng(2)
    head_labels = rng.integers(0, 64, labels.shape).astype(np.int32)
    np.savez(d / "head.npz", images=images, labels=head_labels, mask=mask,
             **{f"sd.{k}": v.numpy() for k, v in head_sd.items()})
    sep = LeafCNN(K, ddp.WIDTHS, separable=True)
    init_model(sep, 5)
    sep_sd = {k: v.clone() for k, v in sep.state_dict().items()}
    np.savez(d / "sep.npz", images=images, labels=labels, mask=mask,
             **{f"sd.{k}": v.numpy() for k, v in sep_sd.items()})
    common = {"kind": "steps", "classes": K, "widths": list(ddp.WIDTHS),
              "config": "regularized", "total_steps": 20, "seed": 0,
              "inputs": str(d / "steps.npz"), "drop_block": 0.0,
              "drop_top": 0.0, "min_size": MIN}
    own = {**common, "augment": True, "drop_block": 0.1, "drop_top": 0.3}
    scenarios = [
        ("steps_jax", {**common, "augment": False}),
        ("steps_jax_draws", {**common, "augment": True,
                             "inputs": str(d / "steps_draws.npz")}),
        ("own", own),
        ("own_separable", {**own, "separable": True,
                           "inputs": str(d / "sep.npz")}),
        ("head64", {**own, "classes": 64, "inputs": str(d / "head.npz")})]
    four = torch_dp_worker.launch(
        {"dir": str(d / "four"), "scenarios": scenarios, "mesh_data": D,
         "mesh_model": T}, world=D * T, timeout=180)

    # resnet10 on data=1 x model=2: every layer from the stem on sharded
    res = build_resnet(K, "resnet10")
    init_model(res, 4)
    res_sd = {k: v.clone() for k, v in res.state_dict().items()}
    np.savez(d / "resnet.npz", images=images[:, :B], labels=labels[:, :B],
             mask=mask[:, :B],
             **{f"sd.{k}": v.numpy() for k, v in res_sd.items()})
    # one column-parallel ResBlock 32 -> 64, forward and backward
    blk = init_model(ResBlock(32, 64, False, torch.float32), 3)
    brng = np.random.default_rng(4)
    bx = brng.standard_normal((4, 32, 8, 8)).astype(np.float32)
    bdy = brng.standard_normal((4, 64, 8, 8)).astype(np.float32)
    np.savez(d / "block.npz", x=bx, dy=bdy,
             **{f"sd.{k}": v.numpy() for k, v in blk.state_dict().items()})
    two = torch_dp_worker.launch(
        {"dir": str(d / "two"), "mesh_data": 1, "mesh_model": 2,
         "scenarios": [("resnet10", {**own, "arch": "resnet10",
                                     "drop_top": 0.2,
                                     "inputs": str(d / "resnet.npz")}),
                       ("block", {"kind": "block", "cin": 32,
                                  "features": 64, "min_size": 64,
                                  "inputs": str(d / "block.npz")})]},
        world=2, timeout=180)

    jax_mesh = jmesh.make_mesh(jmesh.MeshSpec(data=D, model=T),
                               devices=jax.devices()[:D * T])
    ref = {}
    for name, augment in (("steps_jax", False), ("steps_jax_draws", True)):
        _, js = ddp._jax_state(cfg)
        sh = jmesh.tp_shardings(js, jax_mesh, min_size=MIN)
        js = jax.device_put(js, sh)
        jfns = jsteps.build_step_fns(model, cfg, K, total_steps=20,
                                     mesh=jax_mesh, augment=augment,
                                     state_shardings=sh)
        metrics = []
        for i in range(N_STEPS):
            js, m = jfns.train_step(js, images[i], labels[i], mask[i],
                                    jax.random.key(i))
            metrics.append(jax.device_get(m))
            if i == 0:
                first = ddp._jax_tensors(js)
        ref[name] = (ddp._jax_tensors(js), first, metrics)
    own_in = (sd, images, labels, mask)
    ref["inputs"] = {
        "steps_jax": own_in, "steps_jax_draws": own_in, "own": own_in,
        "own_separable": (sep_sd, images, labels, mask),
        "head64": (head_sd, images, head_labels, mask),
        "resnet10": (res_sd, images[:, :B], labels[:, :B], mask[:, :B]),
        "block": (blk, bx, bdy)}
    return {**four, **two}, ref


@pytest.mark.parametrize("scenario", ["steps_jax", "steps_jax_draws"])
def test_tp_steps_match_jax_tp_on_a_two_by_two_mesh(tp, scenario):
    results, ref = tp
    got = results[scenario][0]
    last, first, jmetrics = ref[scenario]
    assert int(got["n_sharded"]) > 0
    for i, mj in enumerate(jmetrics):
        loss, correct, n, lr = got["metrics"][i].tolist()
        np.testing.assert_allclose(loss, float(mj["loss"]), rtol=1e-5)
        assert correct == float(mj["correct"])
        assert n == float(mj["n"]) == B * D - (i % 2 == 0)
        np.testing.assert_allclose(lr, float(mj["lr"]), rtol=0,
                                   atol=1e-6 * TrainConfig.regularized().lr)
    if scenario == "steps_jax":  # the same pixels on both sides
        ddp._assert_state(got, first, ddp.FIRST, prefix="step1.")
        ddp._assert_state(got, last, ddp.FREE)
    else:  # the moments carry the pixels' difference (test_torch_ddp)
        ddp._assert_state(got, first, {k: v for k, v in ddp.FIRST.items()
                                       if k not in ("mu", "nu")},
                          prefix="step1.")


@pytest.mark.parametrize("scenario", ["steps_jax", "steps_jax_draws", "own",
                                      "own_separable", "head64",
                                      "resnet10"])
def test_tp_ranks_gather_alike_and_shard_gather_is_exact(tp, scenario):
    results, ref = tp
    ranks = results[scenario]
    for r in ranks[1:]:
        assert r.keys() == ranks[0].keys()
        for k in ranks[0]:
            assert torch.equal(ranks[0][k], r[k]), k
    for k, v in ref["inputs"][scenario][0].items():
        assert torch.equal(ranks[0][f"step0.model.{k}"], v), k


@pytest.mark.parametrize("scenario,build", [
    ("own", lambda: LeafCNN(K, ddp.WIDTHS, drop_block=0.1, drop_top=0.3)),
    ("own_separable", lambda: LeafCNN(K, ddp.WIDTHS, separable=True,
                                      drop_block=0.1, drop_top=0.3)),
    ("head64", lambda: LeafCNN(64, ddp.WIDTHS, drop_block=0.1,
                               drop_top=0.3)),
    ("resnet10", lambda: build_resnet(K, "resnet10")),
])
def test_tp_steps_equal_one_process_on_the_global_batch(tp, scenario,
                                                        build):
    """The port's own draws (augmentation and dropout, for the global
    batch and every channel) keep the generators in step, so the TP ranks
    compute what one process computes up to summation order."""
    results, ref = tp
    sd, images, labels, mask = ref["inputs"][scenario]
    losses, first, gen = _one_process(sd, build(), images, labels, mask)
    got = results[scenario][0]
    assert int(got["n_sharded"]) > 0
    assert torch.equal(got["generator"], gen)
    if scenario == "resnet10":
        _assert_resnet_first_step(got, first, losses)
        return
    np.testing.assert_allclose(got["metrics"][:, 0].numpy(), losses,
                               rtol=1e-5)
    ddp._assert_state(got, first, ddp.FIRST, prefix="step1.")


def _assert_resnet_first_step(got, first, losses):
    """resnet10 at `tests/test_torch_train_step.py`'s first-step rule: its
    zero-initialised BatchNorm scales leave gradients of rounding size
    (1e-11 on dead stem channels), whose sign any summation order flips,
    and Adam's first update is lr · sign(g). So the first loss at rtol
    1e-5; the moments and BatchNorm statistics at the first-step bars;
    the params and their EMA copies at their first-step bars wherever
    |g| > 1e-6 and within 2·lr elsewhere. Later losses move for the same reason (2.1e-5 read at the
    second step), so they are not held."""
    lr = TrainConfig.regularized().lr
    np.testing.assert_allclose(float(got["metrics"][0, 0]), losses[0],
                               rtol=1e-5)
    ddp._assert_state(got, first, {k: v for k, v in ddp.FIRST.items()
                                   if k in ("stats", "mu", "nu")},
                      prefix="step1.")
    for k, ref in first.items():
        section, name = k.split(".", 1)
        mine = got[f"step1.{k}"].numpy()
        if section == "ema" and f"mu.{name}" not in first:
            assert ddp._rel(mine, ref) <= ddp.FIRST["ema"], k  # statistics
        if f"mu.{name}" not in first or section not in ("model", "ema"):
            continue  # the params and their EMA copies from here
        sure = np.abs(first[f"mu.{name}"]) / 0.1 > 1e-6
        bar = ddp.FIRST["params" if section == "model" else "ema"]
        assert ddp._rel(mine[sure], ref[sure]) <= bar, k
        assert np.abs(mine - ref).max() <= 2 * lr + 1e-6, k


def test_head64_shards_the_dense_head():
    plan = tp_shardings({k: v.shape for k, v in LeafCNN(
        64, ddp.WIDTHS).state_dict().items()}, 2, MIN)
    assert plan["Dense_0.weight"] and plan["Dense_0.bias"]
    assert not tp_shardings({k: v.shape for k, v in LeafCNN(
        K, ddp.WIDTHS).state_dict().items()}, 2, MIN)["Dense_0.weight"]


def test_column_parallel_block_equals_one_process(tp):
    """One ResBlock 32 -> 64 on `data=1 × model=2` (min_size 64: both
    convs, SE Conv_1, the 1x1 shortcut and the BatchNorms sharded; the
    32-channel input full on both ranks), forward and backward in training
    mode: the gathered output at 1e-6, the input's gradient (the model
    group's sum of the ranks' parts) and the gathered parameter gradients
    within 1e-5 relative L2 of one process; both ranks alike."""
    results, ref = tp
    a, b = results["block"]
    for n in a:
        assert torch.equal(a[n], b[n]), n
    assert int(a["n_sharded"]) > 0
    blk, x, dy = ref["inputs"]["block"]
    xt = torch.from_numpy(x).requires_grad_(True)
    y = blk(xt, train=True)
    names = [n for n, _ in blk.named_parameters()]
    grads = torch.autograd.grad(y, [xt] + [p for _, p in
                                           blk.named_parameters()],
                                torch.from_numpy(dy))
    assert (a["y"] - y.detach()).abs().max().item() <= 1e-6
    for name, want in [("dx", grads[0])] + [
            (f"grad.{n}", g) for n, g in zip(names, grads[1:])]:
        assert ddp._rel(a[name].numpy(), want.numpy()) <= 1e-5, name
