"""A configuration's model is found by its `arch`, as two files
(`portbench/arch.py`): a new architecture runs through the whole harness
with no edit to a file the benchmark has, an unknown one fails, an arch
without its CPU size (`TINY`) fails, and each configuration's layout and
weights are those its frozen file (`portbench/frozen/<config>.json`,
written by `tools/freeze.py`) holds."""

from __future__ import annotations

import math
import subprocess
import sys
import textwrap

import pytest
import torch

from conftest import ROOT, bench, check_frozen, tiny_size
from portbench import arch, flops, program, weights
from portbench.drivers import train
from portbench.reference import models, precision, step as ref_step
from portbench.tools import freeze

# A toy without BatchNorm: patches embedded by a dense layer, one
# LayerNorm, one two-head self-attention with dropout after it, average
# pooling and a dense head. Its port side is a plain `nn.Module`.
TOY_PROGRAM = '''
import torch


class Toy(torch.nn.Module):
    def __init__(self, cfg):
        super().__init__()
        d, p = cfg["dim"], cfg["patch"]
        self.cfg = cfg
        self.embed = torch.nn.Linear(3 * p * p, d)
        self.norm = torch.nn.LayerNorm(d, eps=1e-5)
        self.qkv = torch.nn.Linear(d, 3 * d)
        self.proj = torch.nn.Linear(d, d)
        self.head = torch.nn.Linear(d, cfg["num_classes"])

    def forward(self, x):
        n, s, p, h = len(x), x.shape[1], self.cfg["patch"], self.cfg["heads"]
        x = x.reshape(n, s // p, p, s // p, p, 3).permute(0, 1, 3, 2, 4, 5)
        t = self.norm(self.embed(x.reshape(n, (s // p) ** 2, -1)))
        q, k, v = self.qkv(t).reshape(n, -1, 3, h, t.shape[-1] // h) \\
            .permute(2, 0, 3, 1, 4)
        a = torch.softmax(q @ k.transpose(-1, -2) / q.shape[-1] ** 0.5, -1)
        t = t + self.proj((a @ v).transpose(1, 2).reshape(t.shape))
        return self.head(t.mean(1))


def build(cfg, dtype):
    return Toy(cfg)
'''

TOY_REFERENCE = '''
import torch

from portbench.reference import models

TINY = {"dim": 8, "img_size": 16, "batch_size": 8,
        "compute_dtype": "float32"}


def layout(cfg):
    d, p, k = cfg["dim"], cfg["patch"], cfg["num_classes"]
    for name, shape in (("embed", (d, 3 * p * p)), ("norm", None),
                        ("qkv", (3 * d, d)), ("proj", (d, d)),
                        ("head", (k, d))):
        if shape is None:
            yield f"{name}.weight", (d,), "scale"
            yield f"{name}.bias", (d,), "bias"
        else:
            yield f"{name}.weight", shape, "dense"
            yield f"{name}.bias", (shape[0],), "bias"


def forward(cfg, ctx, w, images):
    q_ = ctx.q

    def dense(name, x):
        return q_(q_(x) @ q_(w[name + ".weight"]).t() + w[name + ".bias"])

    n, s, p, h = len(images), images.shape[1], cfg["patch"], cfg["heads"]
    x = images.reshape(n, s // p, p, s // p, p, 3).permute(0, 1, 3, 2, 4, 5)
    t = dense("embed", x.reshape(n, (s // p) ** 2, -1))
    mean = t.mean(-1, keepdim=True)
    var = t.var(-1, unbiased=False, keepdim=True)
    t = q_((t - mean) * torch.rsqrt(var + 1e-5) * w["norm.weight"]
           + w["norm.bias"])
    q, k, v = dense("qkv", t).reshape(n, -1, 3, h, t.shape[-1] // h) \\
        .permute(2, 0, 3, 1, 4)
    a = q_(torch.softmax(q @ k.transpose(-1, -2) / q.shape[-1] ** 0.5, -1))
    y = dense("proj", q_(a @ v).transpose(1, 2).reshape(t.shape))
    t = q_(t + models.dropout(ctx, y, cfg["drop_attn"]))
    return dense("head", q_(t.mean(1))).float()
'''

TOY = {"arch": "toy", "dim": 8, "heads": 2, "patch": 4, "drop_attn": 0.1,
       "num_classes": 4, "img_size": 16, "batch_size": 8,
       "compute_dtype": "float32", "epochs": 10,
       "optimizer": {"lr": 0.002, "weight_decay": 0.0001, "clipnorm": 0.5,
                     "label_smoothing": 0.02, "ema_decay": 0.999}}
TOY_TRAFFIC = {"kind": "train", "images": 64, "val_share": 0.2,
               "chain_steps": 2, "compared_evals": 1}


@pytest.fixture
def toy_archs(tmp_path, monkeypatch):
    """The toy's two files, in a temporary folder the harness looks in."""
    for side, source in (("program", TOY_PROGRAM),
                         ("reference", TOY_REFERENCE)):
        folder = tmp_path / side
        folder.mkdir()
        (folder / "toy.py").write_text(textwrap.dedent(source))
        monkeypatch.setitem(arch.FOLDERS, side, folder)
    return tmp_path


def _pixels(n: int, size: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(3)
    return torch.randint(0, 256, (n, size, size, 3), generator=g,
                         dtype=torch.uint8)


def test_toy_arch_runs_through_the_harness(toy_archs, monkeypatch):
    cfg = TOY
    assert tiny_size("toy") == {"dim": 8, "img_size": 16, "batch_size": 8,
                                "compute_dtype": "float32"}
    spec = list(models.layout(cfg))
    assert models.running(cfg) == []
    assert len(models.trainable(cfg)) == len(spec) == 10

    x8 = _pixels(6, cfg["img_size"])
    w = weights.draw(cfg, x8, torch.Generator().manual_seed(1))
    assert [n for n, _, _ in spec] == list(w)
    port = program.model(cfg, w, torch.device("cpu")).eval()
    assert list(port.state_dict()) == list(w)
    x = x8.float() / 255.0
    with torch.no_grad():
        torch.testing.assert_close(port(x), models.forward(
            cfg, w, x, models.Context(False)), rtol=1e-5, atol=1e-5)

    # the FLOP count draws no dropout mask, whatever its rate is named
    def no_draw(*a, **k):
        raise AssertionError("the FLOP count drew a random mask")

    d, p, t, k = cfg["dim"], cfg["patch"], (16 // 4) ** 2, 4
    forward = 2 * (t * 3 * p * p * d + t * d * 3 * d + 2 * t * t * d
                   + t * d * d + d * k)
    with monkeypatch.context() as m:
        m.setattr(torch, "rand", no_draw)
        assert flops.forward_flops_per_image(cfg) == forward
        assert flops.train_flops_per_image(cfg) > 2 * forward

    data = train.make_data(cfg, TOY_TRAFFIC, 2 ** 31 + 11,
                           torch.device("cpu"))
    first = ref_step.start(cfg, data.weights, data.fit_seed, "cpu")
    seen = train.Seen(first, first, first,
                      [train.Evaluated(data.weights, 0.0, 0.0)])
    ref = train.reference(cfg, TOY_TRAFFIC, data, seen)
    assert all(not torch.equal(ref.after.weights[n], first.weights[n])
               for n in models.trainable(cfg))
    got = train.reference(cfg, TOY_TRAFFIC, data, seen, q=precision.bf16)
    numbers = train.numbers(cfg, TOY_TRAFFIC, data, seen, got, ref)
    assert set(numbers) == {
        "grad_gap", "grad_median_gap", "change_gap", "change_median_gap",
        "ema_gap", "ema_median_gap", "start_change_gap",
        "start_change_median_gap", "val_loss_gap", "val_acc_gap"}
    assert all(math.isfinite(v) for v in numbers.values())
    assert numbers["change_gap"] > 0


def test_a_kind_no_rule_names_fails_the_draw(toy_archs):
    source = TOY_REFERENCE.replace('"scale"', '"gain"')
    (toy_archs / "reference" / "toy.py").write_text(textwrap.dedent(source))
    with pytest.raises(ValueError, match="'norm.weight' of kind 'gain'"):
        weights.draw(TOY, _pixels(2, 16), torch.Generator().manual_seed(1))


@pytest.mark.parametrize("present", [(), ("reference",)])
def test_unknown_arch_fails(present, tmp_path, monkeypatch):
    for side in arch.FOLDERS:
        monkeypatch.setitem(arch.FOLDERS, side, tmp_path / side)
    for side in present:
        (tmp_path / side).mkdir()
        (tmp_path / side / "swin.py").write_text(TOY_REFERENCE)
    cfg = {**TOY, "arch": "swin"}
    files = [str(tmp_path / side / "swin.py") for side in arch.FOLDERS]
    for call in (lambda: list(models.layout(cfg)),
                 lambda: program.model(cfg, {}, torch.device("cpu"))):
        with pytest.raises(ValueError) as err:
            call()
        assert all(f in str(err.value) for f in files), err.value


def test_an_arch_without_tiny_fails(toy_archs):
    path = toy_archs / "reference" / "toy.py"
    source = textwrap.dedent(TOY_REFERENCE)
    path.write_text(source[:source.index("TINY")]
                    + source[source.index("def layout"):])
    with pytest.raises(ValueError, match="gives no TINY") as err:
        tiny_size("toy")
    assert str(path) in str(err.value)


@pytest.mark.parametrize("config", bench()["configs"],
                         ids=[c["name"] for c in bench()["configs"]])
def test_layout_and_weights_are_frozen(config):
    check_frozen(config, ["layout_sha256", "weights_sha256"])


def test_a_configuration_without_frozen_values_fails(bench_copy):
    config = bench()["configs"][0]
    path = bench_copy / "portbench" / "frozen" / f"{config['name']}.json"
    path.unlink()
    with pytest.raises(pytest.fail.Exception) as err:
        check_frozen(config)
    assert str(path) in str(err.value) and freeze.TOOL in str(err.value)


def test_freeze_prints_the_committed_file():
    out = subprocess.run([sys.executable, freeze.TOOL, "--config",
                          "resnet18"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout == (ROOT / "portbench" / "frozen"
                          / "resnet18.json").read_text()
