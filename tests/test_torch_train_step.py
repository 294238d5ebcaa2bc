"""The PyTorch port's train step, held against the JAX package's.

One flax state (LeafCNN tiny widths at 32 px, batch 4, f32, no dropout, no
lane fold, non-identity norm_stats) is converted into the port; both run
`train_step` on the same uint8 batches with augmentation off, on one CPU
device each, for REGULARIZED (AdamW, clip 0.5, smoothing 0.02, EMA 0.999)
and FAST (Adam, integer-label CE). Tolerances, each as a relative L2 error
per tensor (‖port − jax‖ / ‖jax‖) unless stated, sized from the float32
summation-order drift of two conv libraries:

- loss per step rtol 1e-5, correct count equal, LR within 1e-6 of the
  base LR (numpy's and XLA's f32 cos differ by an ulp);
- grads at the first step 1e-4 (observed ~1e-5);
- after 1 step: params 1e-4, batch_stats 5e-6, Adam moments 1e-4, EMA 1e-5;
- after 20 free-running steps: params 5e-4, batch_stats 5e-5, EMA 2e-4;
- the moments at step 20 from JAX's state at step 19: 1e-4 (free-running,
  a ReLU or max-pool boundary crossed at a different step moves single
  late gradients, which the moments carry and the weights barely feel).

These fail on a missing Adam bias correction (the first update 3.16× too
large: params off by ~1e-2) and on the unbiased running variance (~4e-5 in
the 8×8 stage). The optimizer's order (decay after Adam) and optax's clip
formula are pinned on their own, against optax, where they are visible.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from leaffliction_tpu.models.leafcnn import LeafCNN as JaxLeafCNN  # noqa: E402
from leaffliction_tpu.models.resnet import LeafResNet as JaxResNet  # noqa: E402
from leaffliction_tpu.parallel.mesh import MeshSpec, make_mesh  # noqa: E402
from leaffliction_tpu.train import steps as jsteps  # noqa: E402
from leaffliction_tpu.train.config import TrainConfig  # noqa: E402
from leaffliction_tpu_torch.convert import to_state_dict  # noqa: E402
from leaffliction_tpu_torch.models.leafcnn import (  # noqa: E402
    LeafCNN,
    build_leafcnn,
    dropout,
    init_leafcnn,
)
from leaffliction_tpu_torch.models.resnet import (  # noqa: E402
    RESNET_PRESETS,
    LeafResNet,
)
from leaffliction_tpu_torch.train import steps  # noqa: E402
from test_torch_leafcnn import _redraw  # noqa: E402

torch.set_num_threads(1)

K, S, B, N = 5, 32, 4, 20
WIDTHS = (16, 32, 64)
CONFIGS = {"regularized": TrainConfig.regularized(),
           "fast": TrainConfig.fast()}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _flat(params, batch_stats):
    """flax trees → port state_dict names."""
    return {k: v.numpy() for k, v in to_state_dict(
        {"params": jax.device_get(params),
         "batch_stats": jax.device_get(batch_stats)}).items()}


def _adam(jstate):
    return next(s for s in jstate.opt_state if hasattr(s, "mu"))


def _assert_close(got: dict, ref: dict, tol: float, what: str):
    worst = max(((_rel(got[k], ref[k]), k) for k in ref), default=(0, ""))
    assert worst[0] <= tol, f"{what}: {worst[1]} off by {worst[0]:.2e}"


class Pair:
    """A JAX state and the port state converted from it: LeafCNN at the
    tiny widths, or the resnet10 preset (`arch="resnet10"`)."""

    def __init__(self, cfg: TrainConfig, arch: str = "leafcnn"):
        self.cfg = cfg
        if arch == "leafcnn":
            model = JaxLeafCNN(num_classes=K, widths=WIDTHS, drop_block=0.0,
                               drop_top=0.0, lane_fold=False)
            tmodel = LeafCNN(K, WIDTHS)
        else:
            model = JaxResNet(num_classes=K, blocks=RESNET_PRESETS[arch][
                "blocks"], drop_top=0.0, lane_fold=False, dtype=jnp.float32)
            tmodel = LeafResNet(K, **RESNET_PRESETS[arch], drop_top=0.0)
        rng = np.random.default_rng(0)
        jstate = jsteps.create_train_state(model, cfg, S, seed=0)
        self.jstate = jstate.replace(norm_stats={
            "mean": jnp.asarray(rng.uniform(0.4, 0.6, 3), jnp.float32),
            "var": jnp.asarray(rng.uniform(0.05, 0.1, 3), jnp.float32)})
        if arch != "leafcnn":
            # the ResNet's zero-init BN scales make a branch, and a
            # channel shift that a later BatchNorm cancels, give gradients
            # of rounding size, which Adam's first step turns into ±lr in
            # either framework: start from redrawn BN parameters instead
            redraw = np.random.default_rng(1)
            params = _redraw(jax.device_get(self.jstate.params), redraw)
            stats = _redraw(jax.device_get(self.jstate.batch_stats), redraw)
            self.jstate = self.jstate.replace(
                params=params, batch_stats=stats,
                ema_params=jax.tree_util.tree_map(jnp.array, params),
                ema_batch_stats=jax.tree_util.tree_map(jnp.array, stats))
        self.jmodel = model
        self.jfns = jsteps.build_step_fns(
            model, cfg, K, total_steps=N,
            mesh=make_mesh(MeshSpec(data=1, model=1),
                           devices=jax.devices()[:1]), augment=False)
        tmodel.load_state_dict(to_state_dict(jax.device_get(
            {"params": self.jstate.params,
             "batch_stats": self.jstate.batch_stats,
             "norm_stats": self.jstate.norm_stats})))
        self.tstate = steps.train_state_for(tmodel)
        self.tfns = steps.build_step_fns(cfg, K, N, augment=False)
        self.gen = torch.Generator().manual_seed(0)
        self.images = rng.integers(0, 256, (N, B, S, S, 3), np.uint8)
        self.labels = rng.integers(0, K, (N, B)).astype(np.int32)
        self.mask = np.ones((N, B), np.float32)
        self.mask[::3, -1] = 0.0   # padded rows in some batches

    def step_jax(self, i):
        self.jstate, m = self.jfns.train_step(
            self.jstate, self.images[i], self.labels[i], self.mask[i],
            jax.random.key(i))
        return jax.device_get(m)

    def step_port(self, i):
        return self.tfns.train_step(
            self.tstate, torch.from_numpy(self.images[i]),
            torch.from_numpy(self.labels[i]).long(),
            torch.from_numpy(self.mask[i]), self.gen)

    def sync_port(self):
        """Load the JAX state (weights, moments, EMA, step) into the port."""
        j = self.jstate
        sd = to_state_dict(jax.device_get(
            {"params": j.params, "batch_stats": j.batch_stats,
             "norm_stats": j.norm_stats}))
        self.tstate.model.load_state_dict(sd)
        adam = _adam(j)
        for name, tree in (("mu", adam.mu), ("nu", adam.nu)):
            for k, v in _flat(tree, j.batch_stats).items():
                if k in self.tstate.mu:
                    getattr(self.tstate, name)[k].copy_(torch.from_numpy(v))
        ema = _flat(j.ema_params, j.ema_batch_stats)
        for d in (self.tstate.ema_params, self.tstate.ema_batch_stats):
            for k in d:
                d[k].copy_(torch.from_numpy(ema[k]))
        self.tstate.step = int(j.step)

    def compare(self, tol_params, tol_stats, tol_ema, tol_moments=None):
        j, t = self.jstate, self.tstate
        ref = _flat(j.params, j.batch_stats)
        sd = {k: v.detach().numpy() for k, v in
              t.model.state_dict().items() if k in ref}
        _assert_close({k: sd[k] for k in t.params},
                      {k: ref[k] for k in t.params}, tol_params, "params")
        _assert_close({k: sd[k] for k in t.batch_stats},
                      {k: ref[k] for k in t.batch_stats}, tol_stats,
                      "batch_stats")
        ema = _flat(j.ema_params, j.ema_batch_stats)
        mine = {k: v.numpy() for k, v in
                {**t.ema_params, **t.ema_batch_stats}.items()}
        _assert_close(mine, ema, tol_ema, "ema")
        if tol_moments is not None:
            adam = _adam(j)
            for name, tree in (("mu", adam.mu), ("nu", adam.nu)):
                ref_m = _flat(tree, j.batch_stats)
                got = {k: v.numpy() for k, v in getattr(t, name).items()}
                _assert_close(got, {k: ref_m[k] for k in got}, tol_moments,
                              name)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_train_step_matches_jax_over_20_steps(name):
    p = Pair(CONFIGS[name])
    for i in range(N):
        mj, mt = p.step_jax(i), p.step_port(i)
        np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                                   rtol=1e-5)
        assert float(mt["correct"]) == float(mj["correct"])
        assert float(mt["n"]) == float(mj["n"])
        np.testing.assert_allclose(mt["lr"], float(mj["lr"]), rtol=0,
                                   atol=1e-6 * p.cfg.lr)
        if i == 0:
            p.compare(1e-4, 5e-6, 1e-5, tol_moments=1e-4)
    assert p.tstate.step == int(p.jstate.step) == N
    p.compare(5e-4, 5e-5, 2e-4)

    # step 20 again from JAX's state at step 19: the moments
    q = Pair(CONFIGS[name])
    for i in range(N - 1):
        q.step_jax(i)
    q.sync_port()
    q.step_jax(N - 1)
    q.step_port(N - 1)
    q.compare(1e-4, 5e-6, 1e-5, tol_moments=1e-4)


def test_resnet10_train_step_matches_jax():
    """resnet10 (BatchNorm momentum 0.9, SE, strided SAME pads) through
    FAST steps. Its first step from a fresh state: loss, correct count,
    batch_stats and Adam's moments at the first-step bars; the params at
    1e-4 wherever JAX's gradient exceeds 1e-6 (100 × Adam's eps: there
    the first update is lr · sign(g) to 1%), and within Adam's bound 2·lr
    elsewhere, where a gradient of rounding size flips its sign (measured:
    18 of 589,824 weights of one conv, 7.6e-4 relative L2 over the whole
    tensor). Free-running steps diverge here in either framework (batch 4,
    a 1×1 last stage, updates 15% of a weight: JAX against itself on the
    batches' rows reversed reads losses 1.3% apart at the 4th step, 12% by
    the 7th), so each later step starts from JAX's state: loss, correct
    count, params and batch_stats at the first-step bars."""
    p = Pair(CONFIGS["fast"], arch="resnet10")
    lr = p.cfg.lr
    before = _flat(p.jstate.params, p.jstate.batch_stats)
    for i in range(8):
        if i > 0:
            p.sync_port()
        mj, mt = p.step_jax(i), p.step_port(i)
        np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                                   rtol=1e-5)
        assert float(mt["correct"]) == float(mj["correct"])
        if i > 0:
            p.compare(1e-4, 5e-6, 1e-5)
            continue
        j, t = p.jstate, p.tstate
        ref = _flat(j.params, j.batch_stats)
        sd = {k: v.detach().numpy() for k, v in t.model.state_dict().items()}
        mu = _flat(_adam(j).mu, j.batch_stats)
        for k in t.params:
            sure = np.abs(mu[k]) / (1.0 - steps.B1) > 1e-6  # |g| > 1e-6
            assert _rel(sd[k][sure], ref[k][sure]) <= 1e-4, k
            assert np.abs(sd[k] - ref[k]).max() <= 2 * lr + 1e-6, k
            assert np.abs(ref[k] - before[k]).max() <= lr * (1 + 1e-5), k
        _assert_close({k: sd[k] for k in t.batch_stats},
                      {k: ref[k] for k in t.batch_stats}, 5e-6,
                      "batch_stats")
        for name, tree in (("mu", _adam(j).mu), ("nu", _adam(j).nu)):
            ref_m = _flat(tree, j.batch_stats)
            got = {k: v.numpy() for k, v in getattr(t, name).items()}
            _assert_close(got, {k: ref_m[k] for k in got}, 1e-4, name)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_grads_match_jax_grad(name):
    cfg = CONFIGS[name]
    p = Pair(cfg)
    j = p.jstate
    x = p.images[0].astype(np.float32) / 255.0
    labels, mask = p.labels[0], p.mask[0]

    def jloss(params):
        logits, _ = p.jmodel.apply(
            {"params": params, "batch_stats": j.batch_stats,
             "norm_stats": j.norm_stats}, jnp.asarray(x), train=True,
            mutable=["batch_stats"])
        return jsteps._loss_fn(logits, labels, mask, K,
                               cfg.label_smoothing)[0]

    ref = _flat(jax.grad(jloss)(j.params), j.batch_stats)
    model = p.tstate.model
    logits = model(torch.from_numpy(x), train=True)
    loss, _ = steps.loss_fn(logits, torch.from_numpy(labels).long(),
                            torch.from_numpy(mask), K, cfg.label_smoothing)
    names = list(p.tstate.params)
    grads = torch.autograd.grad(loss, [p.tstate.params[k] for k in names])
    _assert_close({k: g.numpy() for k, g in zip(names, grads)},
                  {k: ref[k] for k in names}, 1e-4, "grads")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_lr_schedule_matches_jax(name):
    cfg = CONFIGS[name]
    ref = jsteps.make_lr_schedule(cfg, 37)
    got = steps.make_lr_schedule(cfg, 37)
    for step in range(40):
        # f32 cos in numpy and in XLA may differ by an ulp or two
        np.testing.assert_allclose(
            got(step), float(ref(jnp.asarray(step, jnp.int32))), rtol=0,
            atol=1e-6 * cfg.lr)


def _optax_steps(cfg, params, grads_seq, lrs):
    tx = jsteps.make_optimizer(cfg)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(p)
    for g, lr in zip(grads_seq, lrs):
        u, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                             state, p)
        p = jax.tree_util.tree_map(lambda a, b: a - lr * b, p, u)
    adam = next(s for s in state if hasattr(s, "mu"))
    return p, adam.mu, adam.nu


@pytest.mark.parametrize("name", list(CONFIGS))
def test_optimizer_matches_optax(name):
    """Large weights and small gradients, so the decay term is as large as
    Adam's update: decaying before Adam, or a missing bias correction,
    moves these params by ~1e-3 relative; the port agrees to 2e-6."""
    cfg = CONFIGS[name]
    rng = np.random.default_rng(1)
    params = {"a": rng.uniform(50, 150, (5, 3)).astype(np.float32)
              * rng.choice([-1, 1], (5, 3)).astype(np.float32),
              "b": rng.uniform(50, 150, (7,)).astype(np.float32)}
    grads_seq = [{k: (rng.standard_normal(v.shape) * 0.3).astype(np.float32)
                  for k, v in params.items()} for _ in range(3)]
    lrs = [2e-3, 1.5e-3, 1e-3]
    ref_p, ref_mu, ref_nu = _optax_steps(cfg, params, grads_seq, lrs)

    names = list(params)
    p = [torch.from_numpy(params[k].copy()) for k in names]
    mu = [torch.zeros_like(t) for t in p]
    nu = [torch.zeros_like(t) for t in p]
    for i, (g, lr) in enumerate(zip(grads_seq, lrs)):
        hyper = steps.hyper_rows([i], 1.0, lambda _, lr=lr: lr)[0]
        steps.apply_updates(p, [torch.from_numpy(g[k]) for k in names],
                            mu, nu, torch.from_numpy(hyper), cfg)
    for k, pt, mt, nt in zip(names, p, mu, nu):
        np.testing.assert_allclose(pt.numpy(), np.asarray(ref_p[k]),
                                   rtol=2e-6)
        np.testing.assert_allclose(mt.numpy(), np.asarray(ref_mu[k]),
                                   rtol=2e-6, atol=1e-9)
        np.testing.assert_allclose(nt.numpy(), np.asarray(ref_nu[k]),
                                   rtol=2e-6, atol=1e-9)


def test_clip_matches_optax_not_torch():
    """Global norm 0.5002 against max 0.5: optax scales by 0.5/‖g‖, torch's
    `clip_grad_norm_` by 0.5/(‖g‖ + 1e-6), 2e-6 apart; held at 4e-7."""
    rng = np.random.default_rng(2)
    grads = [rng.standard_normal((4, 3)).astype(np.float32),
             rng.standard_normal((6,)).astype(np.float32)]
    norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                       for g in grads))
    grads = [(g * (0.5002 / norm)).astype(np.float32) for g in grads]
    ref, _ = optax.clip_by_global_norm(0.5).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    got = steps.clip_by_global_norm([torch.from_numpy(g) for g in grads],
                                    0.5)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=4e-7)
    torch_way = [torch.from_numpy(g.copy()) for g in grads]
    torch.nn.utils.clip_grad_norm_(torch_way, 0.5)
    assert not all(np.allclose(a.numpy(), np.asarray(b), rtol=4e-7, atol=0)
                   for a, b in zip(torch_way, ref))
    # under the limit the gradients pass unchanged
    small = [torch.from_numpy(g * 0.5) for g in grads]
    for a, b in zip(steps.clip_by_global_norm(small, 0.5), small):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spatial_dropout_drops_whole_channels(dtype):
    rate = 0.15
    x = (torch.randn(64, 32, 4, 4, generator=torch.Generator()
                     .manual_seed(3)) + 3.0).to(dtype)
    y = dropout(x, rate, torch.Generator().manual_seed(4),
                channels_only=True)
    assert y.dtype == dtype
    dropped = (y == 0).all(dim=(2, 3))
    kept = (y != 0).all(dim=(2, 3))
    assert bool((dropped | kept).all())         # whole channels only
    # share dropped ~ rate: n·c = 2048 draws, sd 0.008
    assert abs(float(dropped.float().mean()) - rate) < 0.03
    expect = x / (1.0 - rate)
    assert torch.equal(y[kept], expect[kept])   # exactly x / (1 − rate)


def test_top_dropout_is_elementwise():
    rate = 0.4
    x = torch.rand(256, 64, generator=torch.Generator().manual_seed(5)) + 1
    y = dropout(x, rate, torch.Generator().manual_seed(6))
    zero = y == 0
    assert abs(float(zero.float().mean()) - rate) < 0.02  # sd 0.004
    assert torch.equal(y[~zero], (x / (1.0 - rate))[~zero])


def test_training_forward_draws_from_its_generator():
    model = init_leafcnn(build_leafcnn(K, "tiny"), 0)
    assert (model.drop_block, model.drop_top) == (0.10, 0.30)
    x = torch.rand(4, S, S, 3, generator=torch.Generator().manual_seed(7))

    def run(seed):
        m = init_leafcnn(build_leafcnn(K, "tiny"), 0)
        return m(x, train=True, generator=torch.Generator().manual_seed(seed))

    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))
    with pytest.raises(ValueError, match="Generator"):
        model(x, train=True)
    # eval mode ignores dropout and the generator
    torch.testing.assert_close(model(x), model(x))


def test_build_leafcnn_takes_use_norm():
    plain = build_leafcnn(K, "small", use_norm=False)
    assert not hasattr(plain, "norm_mean")
    assert (plain.drop_block, plain.drop_top) == (0.15, 0.35)
    assert "norm_mean" in dict(build_leafcnn(K, "small").named_buffers())
