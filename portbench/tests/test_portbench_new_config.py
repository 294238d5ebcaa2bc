"""A configuration enters the benchmark as new files only. On a copy of the
benchmark, a toy arch brings its two arch files (with its `TINY`), its
configuration, its frozen values written by `tools/freeze.py`, its cell's
limits, and entries appended to BENCHMARK.json's lists; no other file
changes. The generic checks then hold for it: the names and files, the
frozen values, a tiny run that comes out correct, and a run with the
updates skipped that does not.

The toy trains on the port, in float32. It keeps one BatchNorm, since
the port's train state fails on a model without running statistics (its
EMA update over an empty list): patches embedded by a dense layer, the
port's BatchNorm over the tokens' features, one two-head self-attention
with dropout after it, average pooling and a dense head."""

from __future__ import annotations

from conftest import (bench, check_frozen, check_names, cpu_run, enter,
                      train_cells)

TOY_PROGRAM = '''
import torch


class ToyBN(torch.nn.Module):
    def __init__(self, cfg, dtype):
        super().__init__()
        from leaffliction_tpu_torch.ops.fused_bn import BatchNorm

        d, p = cfg["dim"], cfg["patch"]
        self.cfg, self.dtype = cfg, dtype
        self.embed = torch.nn.Linear(3 * p * p, d)
        self.bn = BatchNorm(d, epsilon=1e-3, dtype=dtype, momentum=0.9)
        self.qkv = torch.nn.Linear(d, 3 * d)
        self.proj = torch.nn.Linear(d, d)
        self.head = torch.nn.Linear(d, cfg["num_classes"])

    def forward(self, x, train=False, generator=None, mesh=None):
        n, s, p, h = len(x), x.shape[1], self.cfg["patch"], self.cfg["heads"]
        x = x.reshape(n, s // p, p, s // p, p, 3).permute(0, 1, 3, 2, 4, 5)
        t = self.embed(x.reshape(n, (s // p) ** 2, -1))
        t = self.bn(t.transpose(1, 2).unsqueeze(-1), train).squeeze(-1) \\
            .transpose(1, 2)
        q, k, v = self.qkv(t).reshape(n, -1, 3, h, t.shape[-1] // h) \\
            .permute(2, 0, 3, 1, 4)
        a = torch.softmax(q @ k.transpose(-1, -2) / q.shape[-1] ** 0.5, -1)
        y = self.proj((a @ v).transpose(1, 2).reshape(t.shape))
        rate = self.cfg["drop_attn"]
        if train and rate > 0:
            keep = torch.rand(y.shape, generator=generator,
                              device=y.device) < 1.0 - rate
            y = torch.where(keep, y / (1.0 - rate),
                            torch.zeros((), device=y.device))
        return self.head((t + y).mean(1)).float()


def build(cfg, dtype):
    return ToyBN(cfg, dtype)
'''

TOY_REFERENCE = '''
import torch

from portbench.reference import models

BN_MOMENTUM = 0.9
TINY = {"dim": 8, "img_size": 16, "batch_size": 8}


def layout(cfg):
    d, p, k = cfg["dim"], cfg["patch"], cfg["num_classes"]
    yield "embed.weight", (d, 3 * p * p), "dense"
    yield "embed.bias", (d,), "bias"
    yield from models.bn_layout("bn", d)
    for name, shape in (("qkv", (3 * d, d)), ("proj", (d, d)),
                        ("head", (k, d))):
        yield f"{name}.weight", shape, "dense"
        yield f"{name}.bias", (shape[0],), "bias"


def forward(cfg, ctx, w, images):
    q_ = ctx.q

    def dense(name, x):
        return q_(q_(x) @ q_(w[name + ".weight"]).t() + w[name + ".bias"])

    n, s, p, h = len(images), images.shape[1], cfg["patch"], cfg["heads"]
    x = images.reshape(n, s // p, p, s // p, p, 3).permute(0, 1, 3, 2, 4, 5)
    t = dense("embed", x.reshape(n, (s // p) ** 2, -1))
    t = models.batchnorm(ctx, w, "bn", t.transpose(1, 2).unsqueeze(-1),
                         1e-3).squeeze(-1).transpose(1, 2)
    q, k, v = dense("qkv", t).reshape(n, -1, 3, h, t.shape[-1] // h) \\
        .permute(2, 0, 3, 1, 4)
    a = q_(torch.softmax(q @ k.transpose(-1, -2) / q.shape[-1] ** 0.5, -1))
    y = dense("proj", q_(a @ v).transpose(1, 2).reshape(t.shape))
    t = q_(t + models.dropout(ctx, y, cfg["drop_attn"]))
    return dense("head", q_(t.mean(1))).float()
'''

CONFIG = {"name": "toy_bn", "arch": "toy_bn", "dim": 32, "heads": 2,
          "patch": 8, "drop_attn": 0.1, "num_classes": 8, "img_size": 64,
          "compute_dtype": "float32", "param_dtype": "float32",
          "batch_size": 32, "epochs": 200,
          "optimizer": {"preset": "regularized", "lr": 0.002,
                        "weight_decay": 0.0001, "clipnorm": 0.5,
                        "label_smoothing": 0.02, "ema_decay": 0.999},
          "reduced": []}
CELL = "train-toy_bn-b32"
LIMITS = {"stats_gap": 0.04, "change_gap": 0.25, "ema_gap": 0.1,
          "start_change_median_gap": 0.2, "val_loss_gap": 0.009}


def _files(root) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_a_configuration_enters_as_new_files(bench_copy, monkeypatch):
    before = _files(bench_copy)
    enter(bench_copy, CONFIG, CELL, LIMITS, TOY_PROGRAM, TOY_REFERENCE)
    after = _files(bench_copy)
    assert [p for p in before if before[p] != after[p]] == ["BENCHMARK.json"]

    new = bench()
    check_names(new)
    assert train_cells()[-1] == CELL
    config = new["configs"][-1]
    check_frozen(config)
    result = cpu_run(CELL)
    assert result["correct"], result["compared"]

    from leaffliction_tpu_torch.train import steps

    monkeypatch.setattr(steps, "apply_updates", lambda *a, **k: None)
    assert not cpu_run(CELL)["correct"]
