"""The ResNet backbone in the PyTorch port, held against the flax model.

The same seeded variables go to both sides: the flax init, then BN
statistics, BN affine parameters and norm_stats redrawn with numpy so that
none is the identity (`test_torch_leafcnn._redraw`), converted by
`convert.py`. The JAX side is `build_resnet(..., lane_fold=False)` (the
lane fold is a TPU layout of the same function). resnet10 and resnet18 ×
the conv and s2d stems at 32 px, batch ≤ 4, and a 36 px conv-stem case,
whose strided convs pad symmetrically. Tolerances:

- eval logits in f32: rtol and atol 1e-4 (only the summation order
  differs);
- bf16 compute: probabilities within 2e-2, the same top-1;
- training mode (dropout off): logits at 1e-4, and the train step's
  first-step bars (`test_torch_train_step.py`): the moved batch_stats
  (momentum 0.9) 5e-6 and the gradients 1e-4 relative L2, all together
  and each one. One exception, measured: a gradient that is a
  near-cancelling sum moves by more than 1e-4 in JAX itself when the
  batch's rows are reordered (resnet18 conv's `BasicBlock_1.SEBlock_0.
  Conv_0.weight`: 1.4e-4 and 1.6e-4 for two orders; the port differs
  from JAX by 1.3e-4), so each gradient is held at the larger of 1e-4 and
  twice JAX's own drift under a reordered batch;
- init: each block's second BatchNorm scale is zero, every other scale
  one; the state_dict's keys and shapes are the JAX init tree's, and the
  round trip through `convert.py` is exact.

The loaders: a resnet10 s2d directory written by the JAX package is served
by the port's `ModelLoader` within 1e-4 of the JAX loader's logits.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from leaffliction_tpu.models.resnet import LeafResNet as JaxResNet  # noqa: E402
from leaffliction_tpu.models.resnet import build_resnet as jax_build  # noqa: E402
from leaffliction_tpu.train import steps as jsteps  # noqa: E402
from leaffliction_tpu_torch.convert import to_flax, to_state_dict  # noqa: E402
from leaffliction_tpu_torch.models.leafcnn import init_model  # noqa: E402
from leaffliction_tpu_torch.models.resnet import (  # noqa: E402
    RESNET_PRESETS,
    LeafResNet,
    build_resnet,
)
from leaffliction_tpu_torch.train import steps  # noqa: E402
from test_torch_leafcnn import _flat, _redraw  # noqa: E402

torch.set_num_threads(1)

K = 5
CASES = [(preset, stem) for preset in ("resnet10", "resnet18")
         for stem in ("conv", "s2d")]


def _jax_model(preset, stem, dtype=jnp.float32, drop_top=0.2):
    spec = RESNET_PRESETS[preset]
    return JaxResNet(num_classes=K, blocks=spec["blocks"],
                     widths=spec["widths"], stem=stem, drop_top=drop_top,
                     lane_fold=False, dtype=dtype)


def _init_tree(preset, stem, size=32):
    model = jax_build(K, preset, stem=stem, lane_fold=False,
                      dtype=jnp.float32)
    return jax.device_get(model.init(
        jax.random.key(0), jnp.zeros((1, size, size, 3)), train=False))


def _variables(preset, stem, size=32, seed=0):
    init = _init_tree(preset, stem, size)
    rng = np.random.default_rng(seed)
    return {"params": _redraw(init["params"], rng),
            "batch_stats": _redraw(init["batch_stats"], rng),
            "norm_stats": {"mean": rng.uniform(0.3, 0.6, 3).astype(
                np.float32),
                "var": rng.uniform(0.05, 0.1, 3).astype(np.float32)}}


def _images(size=32, seed=1, n=4):
    return np.random.default_rng(seed).random((n, size, size, 3)).astype(
        np.float32)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _port(preset, stem, variables, **kw):
    model = LeafResNet(K, **RESNET_PRESETS[preset], stem=stem, **kw)
    model.load_state_dict(to_state_dict(variables))  # strict
    return model


@pytest.mark.parametrize("preset,stem", CASES)
def test_init_and_convert_round_trip(preset, stem):
    """Zero scales where flax has `scale_init=zeros`; keys and shapes equal
    to the JAX init tree's; flax → state_dict → flax exact."""
    model = init_model(build_resnet(K, preset, stem=stem), 0)
    n_blocks = sum(RESNET_PRESETS[preset]["blocks"])
    scales = {k: v for k, v in model.state_dict().items()
              if k.endswith(".scale")}
    zero = {f"BasicBlock_{k}.BatchNorm_1.scale" for k in range(n_blocks)}
    assert zero <= set(scales)
    for k, v in scales.items():
        assert torch.equal(v, torch.full_like(v, 0.0 if k in zero else 1.0))
    init = _init_tree(preset, stem)
    ref = _flat(init)
    ours = _flat(to_flax(model.state_dict()))
    assert {k: v.shape for k, v in ours.items()} == \
        {k: v.shape for k, v in ref.items()}
    # the flax init agrees on which scales start at zero
    for k, v in ref.items():
        if k.endswith("/scale"):
            assert np.array_equal(v, ours[k]), k

    variables = _variables(preset, stem)
    back = _flat(to_flax(_port(preset, stem, variables).state_dict()))
    want = _flat(variables)
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


@pytest.mark.parametrize("preset,stem,size", [c + (32,) for c in CASES]
                         + [("resnet10", "conv", 36)])
def test_eval_logits_match_flax_f32(preset, stem, size):
    variables = _variables(preset, stem, size)
    x = _images(size)
    ref = np.asarray(_jax_model(preset, stem).apply(
        variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = _port(preset, stem, variables).eval()(
            torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("preset,stem", CASES)
def test_bf16_probabilities_match_flax(preset, stem):
    variables = _variables(preset, stem, seed=3)
    x = _images(seed=4)
    ref = np.asarray(jax.nn.softmax(_jax_model(
        preset, stem, dtype=jnp.bfloat16).apply(
        variables, jnp.asarray(x), train=False), axis=-1))
    model = _port(preset, stem, variables, dtype=torch.bfloat16)
    with torch.no_grad():
        got = torch.softmax(model.eval()(torch.from_numpy(x)), -1).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-2)
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


@pytest.mark.parametrize("preset,stem", CASES)
def test_training_mode_matches_flax(preset, stem):
    """One forward and backward with batch statistics, dropout off."""
    variables = _variables(preset, stem, seed=5)
    x = _images(seed=6)
    labels = np.array([0, 3, 1, 4], np.int32)
    mask = np.ones(4, np.float32)
    jmodel = _jax_model(preset, stem, drop_top=0.0)
    others = {"batch_stats": variables["batch_stats"],
              "norm_stats": variables["norm_stats"]}

    def jgrads(order):
        def jloss(params):
            logits, moved = jmodel.apply({"params": params, **others},
                                         jnp.asarray(x[order]), train=True,
                                         mutable=["batch_stats"])
            loss = jsteps._loss_fn(logits, labels[order], mask, K, 0.02)[0]
            return loss, (logits, moved["batch_stats"])

        (_, (logits, stats)), grads = jax.value_and_grad(
            jloss, has_aux=True)(variables["params"])
        return logits, to_state_dict({"params": jax.device_get(grads),
                                      "batch_stats": jax.device_get(stats)})

    ref_logits, ref_grads = jgrads([0, 1, 2, 3])
    _, reordered = jgrads([3, 2, 1, 0])

    model = _port(preset, stem, variables, drop_top=0.0)
    logits = model(torch.from_numpy(x), train=True)
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(ref_logits), rtol=1e-4, atol=1e-4)
    loss, _ = steps.loss_fn(logits, torch.from_numpy(labels).long(),
                            torch.from_numpy(mask), K, 0.02)
    names = [k for k, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in
                                       model.named_parameters()])
    got = {k: g.numpy() for k, g in zip(names, grads)}
    ref = {k: ref_grads[k].numpy() for k in names}
    assert _rel(np.concatenate([got[k].ravel() for k in names]),
                np.concatenate([ref[k].ravel() for k in names])) <= 1e-4
    for k in names:
        drift = _rel(reordered[k].numpy(), ref[k])
        assert _rel(got[k], ref[k]) <= max(1e-4, 2 * drift), \
            f"grad {k}: {_rel(got[k], ref[k]):.2e} (JAX reordered {drift:.2e})"
    stats = {k: v for k, v in model.state_dict().items()
             if k.endswith((".mean", ".var"))}
    worst = max((_rel(v.numpy(), ref_grads[k].numpy()), k)
                for k, v in stats.items())
    assert worst[0] <= 5e-6, f"batch_stats: {worst[1]} off by {worst[0]:.2e}"
    # momentum 0.9: a tenth of the way from the loaded statistics
    before = to_state_dict(variables)
    moved = stats["BatchNorm_0.mean"] - before["BatchNorm_0.mean"]
    assert float(moved.abs().max()) > 1e-3


def test_training_with_dropout_needs_a_generator():
    model = init_model(build_resnet(K, "resnet10"), 0)
    x = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(7))
    with pytest.raises(ValueError, match="Generator"):
        model(x, train=True)
    a = model(x, train=True, generator=torch.Generator().manual_seed(1))
    b = model(x, train=True, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b)


def test_s2d_stem_refuses_sizes_four_does_not_divide():
    model = build_resnet(K, "resnet10", stem="s2d")
    with pytest.raises(ValueError, match="multiple"):
        model(torch.zeros(1, 34, 32, 3))


def test_port_loader_serves_a_jax_written_resnet(tmp_path):
    """A resnet10 s2d directory as the JAX package writes one (msgpack and
    meta), served by both loaders."""
    from leaffliction_tpu.predict.model_loader import (
        ModelLoader as JaxModelLoader,
    )
    from leaffliction_tpu.train.checkpoint import save_model_msgpack
    from leaffliction_tpu_torch.predict.model_loader import ModelLoader

    variables = _variables("resnet10", "s2d", seed=8)
    save_model_msgpack(tmp_path / "leaf_cnn.msgpack", variables["params"],
                       variables["batch_stats"], variables["norm_stats"])
    (tmp_path / "meta.json").write_text(json.dumps({
        "model_file": "leaf_cnn.msgpack",
        "labels": [f"c{i}" for i in range(K)],
        "data": {"img_size": 32, "num_classes": K},
        "model": {"name": "resnet10", "stem": "s2d",
                  "use_normalization": True},
        "training": {"mixed_precision": False},
    }))
    jl = JaxModelLoader(tmp_path).load()
    pl = ModelLoader(tmp_path, device="cpu").load()
    assert type(pl.model).__name__ == "LeafResNet"
    assert (pl.model.stem, pl.model.dtype) == ("s2d", torch.float32)
    x = _images(seed=9, n=3)
    ref = np.asarray(jl.model.apply(jl.variables, x, train=False))
    with torch.no_grad():
        got = pl.model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
