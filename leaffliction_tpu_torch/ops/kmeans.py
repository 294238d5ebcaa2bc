"""Small-k k-means over pixels, a fixed number of rounds, batched.

Port of `leaffliction_tpu/ops/kmeans.py`. The distance is the same
x² − 2x·c + c² expansion (not `torch.cdist`), so ties and argmins fall as
JAX's do; empty clusters keep their centre. JAX draws the initial centres
with threefry (`jax.random.choice(key(seed), P, (k,), replace=False)`),
which torch cannot reproduce: the port draws them in `init_indices` from a
CPU generator seeded by `seed`, so the card and the CPU pick the same
pixels, and the parity tests replace `init_indices` with JAX's own draw.
"""

from __future__ import annotations

import torch


def init_indices(n: int, k: int, seed: int) -> torch.Tensor:
    """k distinct pixel indices in [0, n), int64 on the CPU, from `seed`."""
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randperm(n, generator=gen)[:k]


def _assign(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """x [B, P, C], centers [B, k, C] → nearest centre [B, P] (int64)."""
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    c2 = torch.sum(centers * centers, dim=-1)[:, None, :]
    xc = torch.bmm(x, centers.transpose(1, 2))
    return torch.argmin(x2 - 2 * xc + c2, dim=-1)


def kmeans_pixels(img: torch.Tensor, k: int = 3, iters: int = 10,
                  seed: int = 42):
    """img [..., H, W, C] → (labels [..., H, W] int64, centers [..., k, C]
    f32). Every image of the batch starts from the same pixel indices, as
    JAX's vmap of one key does."""
    lead, (h, w, c) = img.shape[:-3], img.shape[-3:]
    x = img.float().reshape(-1, h * w, c)
    idx = init_indices(h * w, k, seed).to(x.device)
    centers = x[:, idx]
    for _ in range(iters):
        onehot = torch.nn.functional.one_hot(_assign(x, centers), k).float()
        counts = onehot.sum(dim=1)[..., None]
        sums = torch.bmm(onehot.transpose(1, 2), x)
        new = sums / torch.clamp(counts, min=1.0)
        centers = torch.where(counts > 0, new, centers)
    labels = _assign(x, centers)
    return labels.reshape(*lead, h, w), centers.reshape(*lead, k, c)


def kmeans_segment_greenest(img: torch.Tensor, k: int = 3, iters: int = 10
                            ) -> torch.Tensor:
    """Boolean mask of the cluster with the highest green dominance."""
    labels, centers = kmeans_pixels(img, k=k, iters=iters)
    greenness = centers[..., 1] - 0.5 * (centers[..., 0] + centers[..., 2])
    best = torch.argmax(greenness, dim=-1)
    return labels == best[..., None, None]
