"""Data parallelism of the PyTorch port on two CPU ranks, against JAX.

Two worker processes (`tests/torch_dp_worker.py`, gloo on the CPU, each
killed if it outlives its timeout) run the port's data-parallel pieces on
their rows of a global batch; this process holds the JAX side, which is
one program over the global batch on a 2-device mesh of conftest's virtual
CPU devices:

- sync `bn_train` (f32 and bf16): each rank's y and dx against JAX's
  `bn_train` on the concatenated batch at `tests/test_torch_bn_train.py`'s
  tolerances (y 1e-6 in f32 and 2e-2 in bf16, mean and var 1e-5, the VJP
  rtol 2e-4 / atol 2e-3); the ranks' mean and var bit-equal; dγ and dβ
  are each rank's own share, whose sum over the ranks is JAX's (returned
  already summed, the step's all-reduce would count them twice);
- three leafcnn-tiny REGULARIZED train steps at 32 px, 4 images per rank
  (global 8, one row masked out in some steps), no dropout, against JAX's
  `build_step_fns` on a `data=2` mesh at `tests/test_torch_train_step.py`'s
  bars: loss rtol 1e-5 a step, the correct count, n and the LR equal; the
  state after the first step at its first-step bars (params 1e-4,
  batch_stats 5e-6, moments 1e-4, EMA 1e-5 relative L2), and, with
  augmentation off (both sides see the same pixels), after the third at
  its free-running bars (params 5e-4, batch_stats 5e-5, EMA 2e-4; read
  1.3e-4, on a BatchNorm bias);
- the same steps with augmentation on and JAX's draws for the global batch
  injected (`train_augment.draw_params` replaced, as `tests/jax_draws.py`
  hands the balancer JAX's draws), at the same bars but for the moments
  and the state after the third step: K1's twin and JAX's `rotate_warp`
  differ by up to 1e-4 a pixel, which a BatchNorm bias gradient (a
  near-cancelling sum) carries into its first moment (4.9e-3 relative L2
  read), and from the second step on Adam turns such differences in
  near-zero gradients into updates up to 2·lr apart (1.9e-2 relative L2
  read on a BatchNorm bias after three steps);
- both ranks' final states (model, moments, EMA, generator) bit-equal;
- `check_replicated` passes equal copies and raises on every rank when
  one rank's copy differs;
- three steps with the port's own draws and dropout on (the tiny preset's
  rates), two ranks against one process on the global batch: every draw is
  made for the global batch, so the two differ only by the summation order
  of the ranks' BatchNorm and gradient sums: losses at rtol 1e-5 (7.7e-6
  read at the third step), the state after the first step at the
  first-step bars (read 5.9e-6) and the generators equal. (With
  augmentation on, the port against itself drifts past the free-running
  bars by the third step, 6.8e-4 on the params: the edge-clamped pixels
  make near-ties in the max-pools that rounding resolves either way.)
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from leaffliction_tpu.models.leafcnn import LeafCNN as JaxLeafCNN  # noqa: E402
from leaffliction_tpu.ops.fused_bn import bn_train as jax_bn_train  # noqa: E402
from leaffliction_tpu.ops.train_augment import _draw_params  # noqa: E402
from leaffliction_tpu.parallel.mesh import MeshSpec, make_mesh  # noqa: E402
from leaffliction_tpu.train import steps as jsteps  # noqa: E402
from leaffliction_tpu.train.config import TrainConfig  # noqa: E402
from leaffliction_tpu_torch.convert import to_state_dict  # noqa: E402
from leaffliction_tpu_torch.models.leafcnn import LeafCNN  # noqa: E402
from leaffliction_tpu_torch.train import steps  # noqa: E402

import torch_dp_worker  # noqa: E402

torch.set_num_threads(1)

K, S, B, P, N_STEPS = 5, 32, 4, 2, 3
WIDTHS = (16, 32, 64)
BN_SHAPE = (8, 32, 6, 5)  # global NCHW batch: 4 rows a rank


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _flat(params, batch_stats):
    return {k: v.numpy() for k, v in to_state_dict(
        {"params": jax.device_get(params),
         "batch_stats": jax.device_get(batch_stats)}).items()}


def _bn_inputs(dtype):
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(BN_SHAPE) * 2 + 0.5).astype(np.float32)
    dy = rng.standard_normal(BN_SHAPE).astype(np.float32)
    if dtype == "bfloat16":  # the same bf16 values on both sides
        x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16), np.float32)
        dy = np.asarray(jnp.asarray(dy).astype(jnp.bfloat16), np.float32)
    c = BN_SHAPE[1]
    return {"x": x, "dy": dy,
            "scale": np.linspace(0.5, 1.5, c, dtype=np.float32),
            "bias": np.linspace(-0.3, 0.3, c, dtype=np.float32)}


def _jax_state(cfg):
    model = JaxLeafCNN(num_classes=K, widths=WIDTHS, drop_block=0.0,
                       drop_top=0.0, lane_fold=False)
    rng = np.random.default_rng(0)
    state = jsteps.create_train_state(model, cfg, S, seed=0)
    state = state.replace(norm_stats={
        "mean": jnp.asarray(rng.uniform(0.4, 0.6, 3), jnp.float32),
        "var": jnp.asarray(rng.uniform(0.05, 0.1, 3), jnp.float32)})
    return model, state


def _batches():
    rng = np.random.default_rng(1)
    images = rng.integers(0, 256, (N_STEPS, B * P, S, S, 3), np.uint8)
    labels = rng.integers(0, K, (N_STEPS, B * P)).astype(np.int32)
    mask = np.ones((N_STEPS, B * P), np.float32)
    mask[::2, -1] = 0.0  # a padded row of rank 1 in steps 0 and 2
    return images, labels, mask


def _jax_draws(n_steps, n):
    """The draws JAX's train step makes for step i's key (`key(i)` →
    fold_in 0 → split → the augmentation key → one key per image)."""
    out = {"flip": [], "angles": [], "factors": []}
    for i in range(n_steps):
        k_aug, _ = jax.random.split(jax.random.fold_in(jax.random.key(i), 0))
        keys = jax.random.split(k_aug, n)
        flip, angles, factors = jax.vmap(
            lambda k: _draw_params(k, 0.05, 0.1))(keys)
        out["flip"].append(np.asarray(flip))
        out["angles"].append(np.asarray(angles, np.float32))
        out["factors"].append(np.asarray(factors, np.float32))
    return {k: np.stack(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def ddp(tmp_path_factory):
    """The workers' results for every scenario, and the JAX side."""
    d = tmp_path_factory.mktemp("ddp")
    scenarios, ref = [], {}
    for dtype in ("float32", "bfloat16"):
        inputs = _bn_inputs(dtype)
        np.savez(d / f"bn_{dtype}.npz", **inputs)
        scenarios.append((f"bn_{dtype}", {
            "kind": "bn", "inputs": str(d / f"bn_{dtype}.npz"),
            "eps": 1e-3, "dtype": dtype}))
        ref[f"bn_{dtype}"] = inputs

    cfg = TrainConfig.regularized()
    model, jstate = _jax_state(cfg)
    images, labels, mask = _batches()
    sd = to_state_dict(jax.device_get(
        {"params": jstate.params, "batch_stats": jstate.batch_stats,
         "norm_stats": jstate.norm_stats}))
    weights = {f"sd.{k}": v.numpy() for k, v in sd.items()}
    np.savez(d / "steps.npz", images=images, labels=labels, mask=mask,
             **weights)
    np.savez(d / "steps_draws.npz", images=images, labels=labels,
             mask=mask, **_jax_draws(N_STEPS, B * P), **weights)
    common = {"kind": "steps", "classes": K, "widths": list(WIDTHS),
              "config": "regularized", "total_steps": 20, "seed": 0,
              "inputs": str(d / "steps.npz"), "drop_block": 0.0,
              "drop_top": 0.0}
    scenarios += [
        ("steps_jax", {**common, "augment": False}),
        ("steps_jax_draws", {**common, "augment": True,
                             "inputs": str(d / "steps_draws.npz")}),
        ("steps_own_draws", {**common, "augment": True, "drop_block": 0.1,
                             "drop_top": 0.3})]
    scenarios.append(("replicated", {"kind": "replicated"}))
    results = torch_dp_worker.launch({"dir": str(d), "scenarios": scenarios},
                                     world=P, timeout=180)

    mesh = make_mesh(MeshSpec(data=P, model=1), devices=jax.devices()[:P])
    for name, augment in (("steps_jax", False), ("steps_jax_draws", True)):
        jfns = jsteps.build_step_fns(model, cfg, K, total_steps=20,
                                     mesh=mesh, augment=augment)
        _, js = _jax_state(cfg)  # the step donates its state: a fresh one
        metrics = []
        for i in range(N_STEPS):
            js, m = jfns.train_step(js, images[i], labels[i], mask[i],
                                    jax.random.key(i))
            metrics.append(jax.device_get(m))
            if i == 0:
                first = _jax_tensors(js)
        ref[name] = (_jax_tensors(js), first, metrics)
    ref["own"] = (sd, images, labels, mask)
    return results, ref


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sync_bn_train_matches_jax_on_the_global_batch(ddp, dtype):
    results, ref = ddp
    got = results[f"bn_{dtype}"]
    inp = ref[f"bn_{dtype}"]
    jdt = jnp.dtype(dtype)
    nhwc = lambda a: jnp.asarray(a.transpose(0, 2, 3, 1)).astype(jdt)  # noqa: E731
    (yj, mj, vj), vjp = jax.vjp(
        lambda a, s, b: jax_bn_train(a, s, b, 1e-3), nhwc(inp["x"]),
        jnp.asarray(inp["scale"]), jnp.asarray(inp["bias"]))
    dxj, dgj, dbj = vjp((nhwc(inp["dy"]), jnp.zeros_like(mj),
                         jnp.zeros_like(vj)))

    def nchw(a):
        return np.asarray(a, np.float32).transpose(0, 3, 1, 2)

    y = np.concatenate([r["y"].float().numpy() for r in got])
    dx = np.concatenate([r["dx"].float().numpy() for r in got])
    tol = 1e-6 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(y, nchw(yj), rtol=tol, atol=tol)
    for k, ref_k in (("mean", mj), ("var", vj)):
        assert torch.equal(got[0][k], got[1][k]), k
        np.testing.assert_allclose(got[0][k].numpy(), np.asarray(ref_k),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dx, nchw(dxj), rtol=2e-4, atol=2e-3)
    for k, ref_k in (("dg", dgj), ("db", dbj)):
        total = sum(r[k].numpy().astype(np.float64) for r in got)
        np.testing.assert_allclose(total, np.asarray(ref_k), rtol=2e-4,
                                   atol=2e-3)
        # each rank's share is its own rows' sum, not the global one
        assert not np.allclose(got[0][k].numpy(), np.asarray(ref_k),
                               rtol=2e-4, atol=2e-3), k


def _jax_tensors(js):
    """A JAX train state as the worker's `_state_tensors` names it."""
    adam = next(t for t in js.opt_state if hasattr(t, "mu"))
    out = {f"model.{k}": v for k, v in _flat(js.params,
                                               js.batch_stats).items()}
    params = {k for k in _flat(js.params, js.batch_stats)
              if _kind(f"model.{k}") == "params"}
    for name, tree in (("mu", adam.mu), ("nu", adam.nu)):
        out.update({f"{name}.{k}": v for k, v in
                    _flat(tree, js.batch_stats).items() if k in params})
    out.update({f"ema.{k}": v for k, v in
                _flat(js.ema_params, js.ema_batch_stats).items()})
    return out


# relative L2 bars a tensor, `tests/test_torch_train_step.py`'s: after the
# first step from a fresh state, and after free-running steps
FIRST = {"params": 1e-4, "stats": 5e-6, "mu": 1e-4, "nu": 1e-4, "ema": 1e-5}
FREE = {"params": 5e-4, "stats": 5e-5, "ema": 2e-4}


def _kind(key):
    section, name = key.split(".", 1)
    if section == "model":
        return "stats" if name.split(".")[-1] in ("mean", "var") \
            else "params"
    return section


def _assert_state(got, ref, bars, prefix=""):
    """Every tensor of `ref` whose kind has a bar, against `got`."""
    worst = {}
    for k, v in ref.items():
        kind = _kind(k)
        if kind in bars and not k.endswith(("norm_mean", "norm_var")):
            e = _rel(got[prefix + k].numpy(), v)
            worst[kind] = max(worst.get(kind, (0.0, "")), (e, k))
    for kind, (e, k) in worst.items():
        assert e <= bars[kind], f"{kind}: {k} off by {e:.2e}"


@pytest.mark.parametrize("scenario", ["steps_jax", "steps_jax_draws"])
def test_dp_steps_match_jax_on_a_two_device_mesh(ddp, scenario):
    results, ref = ddp
    got = results[scenario][0]
    last, first, jmetrics = ref[scenario]
    for i, mj in enumerate(jmetrics):
        loss, correct, n, lr = got["metrics"][i].tolist()
        np.testing.assert_allclose(loss, float(mj["loss"]), rtol=1e-5)
        assert correct == float(mj["correct"])
        assert n == float(mj["n"]) == B * P - (i % 2 == 0)
        np.testing.assert_allclose(lr, float(mj["lr"]), rtol=0,
                                   atol=1e-6 * TrainConfig.regularized().lr)
    if scenario == "steps_jax":  # the same pixels on both sides
        _assert_state(got, first, FIRST, prefix="step1.")
        _assert_state(got, last, FREE)
    else:  # the moments carry the pixels' difference (module doc)
        _assert_state(got, first, {k: v for k, v in FIRST.items()
                                   if k not in ("mu", "nu")},
                      prefix="step1.")


@pytest.mark.parametrize("scenario", ["steps_jax", "steps_jax_draws",
                                      "steps_own_draws"])
def test_dp_ranks_end_bit_equal(ddp, scenario):
    results, _ = ddp
    a, b = results[scenario]
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_dp_steps_with_dropout_equal_one_process_on_the_global_batch(ddp):
    """The port's own draws (augmentation and dropout) are made for the
    global batch, so two ranks compute what one process computes."""
    import sys

    results, ref = ddp
    sd, images, labels, mask = ref["own"]
    model = LeafCNN(K, WIDTHS, drop_block=0.1, drop_top=0.3)
    model.load_state_dict(sd)
    state = steps.train_state_for(model)
    fns = steps.build_step_fns(TrainConfig.regularized(), K, 20)
    gen = torch.Generator().manual_seed(0)
    losses = []
    for i in range(N_STEPS):
        losses.append(float(fns.train_step(
            state, torch.from_numpy(images[i]),
            torch.from_numpy(labels[i]).long(), torch.from_numpy(mask[i]),
            gen)["loss"]))
        if i == 0:
            first = {k: v.clone().numpy() for k, v in
                     sys.modules["torch_dp_worker"]._state_tensors(
                         state).items()}
    got = results["steps_own_draws"][0]
    np.testing.assert_allclose(got["metrics"][:, 0].numpy(), losses,
                               rtol=1e-5)
    _assert_state(got, first, FIRST, prefix="step1.")
    assert torch.equal(got["generator"], gen.get_state())


def test_check_replicated_catches_a_rank_that_differs(ddp):
    results, _ = ddp
    a, b = results["replicated"]
    assert a["digest"] == b["digest"]
    assert "rank 0's copy is not the one of rank(s) [1]" in a["error"]
    assert "rank 1's copy is not the one of rank(s) [0]" in b["error"]
