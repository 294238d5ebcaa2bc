"""The port's FLOP counts and MFU (`leaffliction_tpu_torch/train/flops.py`),
held against the JAX package's `train/flops.py` on the CPU.

The port counts the convolutions and matrix products one call dispatches,
forward and backward, with `torch.utils.flop_counter`'s formulas; XLA's
cost analysis of the optimised CPU program also counts elementwise and
reduction work, and counts a convolution's taps only where they touch the
input, not its zero padding. Both count a grouped convolution's weight
gradient as if it were ungrouped. Exact:

- a 64x64 matmul counts 2·64³;
- the eval forward counts 2·N·Cout·(Cin/groups)·k²·Hout·Wout for every
  `Conv` and 2·N·in·out for every `Dense`, summed from forward hooks;
- K eager chained steps count K times one step.

Against XLA, as relative gaps |port − XLA| / XLA (deterministic counts;
measured gaps in brackets), the bf16 REGULARIZED train step at base
widths, 64 px, batch 2, 8 classes:

- within 2%: leafcnn conv stem (+0.85%), resnet18 conv (−0.10%) and s2d
  (+0.14%) stems;
- leafcnn s2d stem within 4% (+3.3%): torch counts the 3x3 convs' padding
  taps, a larger share on the s2d stem's smaller maps;
- leafcnn separable within 8% (−7.4%): XLA's elementwise and reduction
  work is a larger share beside the cheap separable convs.

The eval forward at the served size, 224 px, batch 2: leafcnn within 2%
(−0.21%); resnet18 within 7% (+6.3%): torch counts 7.2% more conv taps
than touch the input (the padding of its 7x7 last stage above all), which
XLA leaves out.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from leaffliction_tpu.models.leafcnn import (  # noqa: E402
    build_leafcnn as jax_leafcnn,
)
from leaffliction_tpu.models.resnet import (  # noqa: E402
    build_resnet as jax_resnet,
)
from leaffliction_tpu.parallel.mesh import MeshSpec, make_mesh  # noqa: E402
from leaffliction_tpu.train import steps as jsteps  # noqa: E402
from leaffliction_tpu.train.config import TrainConfig  # noqa: E402
from leaffliction_tpu.train.flops import (  # noqa: E402
    compiled_flops as jax_compiled_flops,
)
from leaffliction_tpu_torch.convert import to_state_dict  # noqa: E402
from leaffliction_tpu_torch.models.leafcnn import (  # noqa: E402
    Conv,
    Dense,
    build_leafcnn,
)
from leaffliction_tpu_torch.models.resnet import build_resnet  # noqa: E402
from leaffliction_tpu_torch.train import flops  # noqa: E402
from leaffliction_tpu_torch.train import steps  # noqa: E402

K, S, B, SERVED = 8, 64, 2, 224
MODELS = {  # (arch, stem, separable)
    "leafcnn-conv": ("leafcnn", "conv", False),
    "leafcnn-s2d": ("leafcnn", "s2d", False),
    "leafcnn-separable": ("leafcnn", "conv", True),
    "resnet18-conv": ("resnet18", "conv", False),
    "resnet18-s2d": ("resnet18", "s2d", False),
}
STEP_TOL = {"leafcnn-conv": 0.02, "leafcnn-s2d": 0.04,
            "leafcnn-separable": 0.08, "resnet18-conv": 0.02,
            "resnet18-s2d": 0.02}
FORWARD_TOL = {"leafcnn-conv": 0.02, "resnet18-conv": 0.07}


def _models(arch: str, stem: str, separable: bool):
    """The JAX model (plain layout, no lane fold) and the port's, bf16."""
    if arch == "leafcnn":
        return (jax_leafcnn(K, "base", separable=separable, stem=stem,
                            lane_fold=False, dtype=jnp.bfloat16),
                build_leafcnn(K, "base", separable=separable, stem=stem,
                              dtype=torch.bfloat16))
    return (jax_resnet(K, arch, stem=stem, lane_fold=False,
                       dtype=jnp.bfloat16),
            build_resnet(K, arch, stem=stem, dtype=torch.bfloat16))


def _pair(name: str, size: int = S):
    """A JAX train state and the port's state carried over from it."""
    jmodel, model = _models(*MODELS[name])
    jstate = jsteps.create_train_state(jmodel, TrainConfig.regularized(),
                                       size, seed=0)
    model.load_state_dict(to_state_dict(jax.device_get(
        {"params": jstate.params, "batch_stats": jstate.batch_stats,
         "norm_stats": jstate.norm_stats})))
    return jmodel, jstate, steps.train_state_for(model)


def _batch(k: int = 1, size: int = S):
    rng = np.random.default_rng(0)
    return (rng.integers(0, 256, (k, B, size, size, 3), np.uint8),
            rng.integers(0, K, (k, B)).astype(np.int32),
            np.ones((k, B), np.float32))


def _port_step_flops(state, fns, images, labels, mask):
    return flops.compiled_flops(
        fns.train_step, state, torch.from_numpy(images),
        torch.from_numpy(labels).long(), torch.from_numpy(mask),
        torch.Generator().manual_seed(0))


def _gap(got: float, ref: float) -> float:
    return abs(got - ref) / ref


def test_matmul_counts_exactly():
    n = 64
    a = torch.ones(n, n)
    assert flops.compiled_flops(torch.matmul, a, a) == 2 * n ** 3


def test_no_count_is_none():
    assert flops.compiled_flops(lambda x: x + 1, torch.ones(4)) is None

    def raises(x):
        raise ValueError(x)

    assert flops.compiled_flops(raises, 1.0) is None


def test_peak_and_mfu_none_on_cpu():
    assert flops.device_peak_flops() is None
    assert flops.device_peak_flops(torch.device("cpu")) is None
    assert flops.mfu(1e12, 0.01) is None
    assert flops.mfu(None, 0.01) is None
    assert flops.mfu(1e12, 0.0) is None
    assert flops.mfu(1e12, -1.0, torch.device("cpu")) is None


@pytest.mark.parametrize("name, peak", [
    ("NVIDIA H100 80GB HBM3", 989.4e12),
    ("NVIDIA H100 SXM5 80GB", 989.4e12),
    ("NVIDIA H100 NVL", 835.5e12),
    ("NVIDIA H100 PCIe", 756.0e12),
    ("NVIDIA A100-SXM4-80GB", None),
])
def test_peak_table(monkeypatch, name, peak):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device: name)
    card = torch.device("cuda", 0)
    assert flops.device_peak_flops(card) == peak
    if peak is None:
        assert flops.mfu(1e12, 0.01, card) is None
    else:
        assert flops.mfu(peak * 0.01, 0.02, card) == pytest.approx(0.5)


@pytest.mark.parametrize("name", list(MODELS))
def test_train_step_count_matches_xla(name):
    jmodel, jstate, state = _pair(name)
    images, labels, mask = _batch()
    jfns = jsteps.build_step_fns(
        jmodel, TrainConfig.regularized(), K, total_steps=10,
        mesh=make_mesh(MeshSpec(data=1, model=1), devices=jax.devices()[:1]))
    ref = jax_compiled_flops(jfns.train_step, jstate, images[0], labels[0],
                             mask[0], jax.random.key(0))
    got = _port_step_flops(state, steps.build_step_fns(
        TrainConfig.regularized(), K, 10), images[0], labels[0], mask[0])
    assert ref is not None and got is not None
    assert _gap(got, ref) <= STEP_TOL[name], (name, got, ref)


@pytest.mark.parametrize("name", list(FORWARD_TOL))
def test_eval_forward_count_matches_xla(name):
    jmodel, jstate, state = _pair(name, SERVED)
    x = _batch(size=SERVED)[0][0].astype(np.float32) / 255.0
    variables = {"params": jstate.params, "batch_stats": jstate.batch_stats,
                 "norm_stats": jstate.norm_stats}
    ref = jax_compiled_flops(
        jax.jit(lambda v, x: jmodel.apply(v, x, train=False)), variables, x)
    model = state.model.eval()
    with torch.no_grad():
        got = flops.compiled_flops(model, torch.from_numpy(x))
    assert ref is not None and got is not None
    assert _gap(got, ref) <= FORWARD_TOL[name], (name, got, ref)


@pytest.mark.parametrize("name", list(MODELS))
def test_forward_count_is_the_layers_sum(name):
    model = _models(*MODELS[name])[1].eval()
    want = []

    def layer_flops(layer, inputs, out):
        w = layer.weight
        taps = w.shape[1] * (w.shape[2] * w.shape[3] if w.dim() == 4 else 1)
        want.append(2 * out.numel() * taps)

    hooks = [m.register_forward_hook(layer_flops) for m in model.modules()
             if isinstance(m, (Conv, Dense))]
    x = torch.from_numpy(_batch()[0][0]).float() / 255.0
    with torch.no_grad():
        got = flops.compiled_flops(model, x)
    for h in hooks:
        h.remove()
    assert len(want) > 20 and got == sum(want)


def test_chain_counts_k_steps():
    _, model = _models(*MODELS["leafcnn-conv"])
    fns = steps.build_step_fns(TrainConfig.regularized(), K, 10)
    one = _port_step_flops(steps.train_state_for(model), fns,
                           *(a[0] for a in _batch()))
    images, labels, mask = _batch(3)
    chain = flops.compiled_flops(
        fns.train_step_chain, steps.train_state_for(model),
        torch.from_numpy(images), torch.from_numpy(labels).long(),
        torch.from_numpy(mask), torch.Generator().manual_seed(0))
    assert one is not None and chain == 3 * one
