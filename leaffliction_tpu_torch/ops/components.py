"""Connected components by iterative label propagation.

Port of `leaffliction_tpu/ops/components.py`. Every foreground pixel is
seeded with its flat index + 1 and the max label is spread through each
component (8-connectivity) until a round changes nothing; each component
ends up labelled by its maximum flat index + 1. A round is a 3x3 max and a
segmented max-scan along rows and then columns.

On the card, `_propagate` is one launch of the fixpoint kernel
(`ops/kernels/components.cc_propagate`): every round runs on the device and
the host never waits for it. On the CPU the kernel's plain twin runs the
same rounds in a host loop, over packed segment planes (a plain cummax over
`segment_id << label_bits | label`, where segment_id counts the background
pixels up to each position, never crosses background). Images too large for
that packing in int32 take the JAX package's int64 round on the CPU, columns
first as the JAX tuple-scan round has it (the fixpoint is the same).
"""

from __future__ import annotations

import torch

from leaffliction_tpu_torch.ops.kernels.components import (
    _max3x3,
    _scan_pair,
    _segment_planes,
    cc_propagate,
    packs_in_int32,
)


def _round_wide(lab, mask, segs, label_bits: int) -> torch.Tensor:
    """One round with int64-packed segment planes (plain PyTorch), columns
    first and then rows, in the order of the JAX tuple-scan round."""
    seg_f0, seg_b0, seg_f1, seg_b1 = segs
    low = (1 << label_bits) - 1
    x = torch.where(mask, _max3x3(lab.long()), 0)
    x = _scan_pair(x, mask, seg_f0, seg_b0, -2, low)
    return _scan_pair(x, mask, seg_f1, seg_b1, -1, low).to(torch.int32)


def _propagate_wide(lab, mask, limit: int) -> torch.Tensor:
    """The host loop over `_round_wide` (CPU, images beyond the packing)."""
    h, w = lab.shape[-2], lab.shape[-1]
    label_bits = (h * w + 1).bit_length()
    segs = _segment_planes(mask, label_bits, torch.int64)
    prev, cur = lab, _round_wide(lab, mask, segs, label_bits)
    i = 0
    while i < limit and not torch.equal(prev, cur):
        prev, cur = cur, _round_wide(cur, mask, segs, label_bits)
        i += 1
    return cur


def _propagate(labels: torch.Tensor, mask: torch.Tensor, limit: int
               ) -> torch.Tensor:
    """Spread each component's max label over the component.

    labels: int32 [..., h, w]; mask: bool like labels. At most
    1 + min(limit, h + w) rounds, fewer once a round changes nothing."""
    h, w = labels.shape[-2], labels.shape[-1]
    limit = min(limit, h + w)
    shape = labels.shape
    lab = labels.reshape(-1, h, w).to(torch.int32).contiguous()
    m = mask.reshape(-1, h, w).bool().contiguous()
    if lab.device.type == "cpu" and not packs_in_int32(h, w):
        return _propagate_wide(lab, m, limit).reshape(shape)
    return cc_propagate(lab, m, limit)[0].reshape(shape)


def label_components(mask: torch.Tensor) -> torch.Tensor:
    """int32 label image: 0 = background, components share a unique id."""
    m = mask.bool()
    h, w = m.shape[-2], m.shape[-1]
    flat = torch.arange(1, h * w + 1, dtype=torch.int32,
                        device=m.device).reshape(h, w)
    return _propagate(torch.where(m, flat, 0), m, h + w)


def _sizes_2d(labels: torch.Tensor) -> torch.Tensor:
    """Pixel counts of [..., h, w] label images, as [..., h, w] int64 grids
    indexed by each component representative's (row, col)."""
    h, w = labels.shape[-2], labels.shape[-1]
    lab = labels.reshape(-1, h * w).long()
    b = lab.shape[0]
    offs = torch.arange(b, device=lab.device)[:, None] * (h * w + 1)
    counts = torch.bincount((lab + offs).reshape(-1),
                            minlength=b * (h * w + 1)).reshape(b, -1)
    return counts[:, 1:].reshape(labels.shape)


def largest_component(mask: torch.Tensor) -> torch.Tensor:
    """Boolean mask of the largest component of each [h, w] image of
    [..., h, w] (empty-safe); ties go to the smallest label."""
    labels = label_components(mask)
    sizes = _sizes_2d(labels).flatten(-2)
    best_label = torch.argmax(sizes, dim=-1) + 1
    return ((labels == best_label[..., None, None])
            & (sizes.amax(dim=-1) > 0)[..., None, None])


def _spread_keep(keep_table: torch.Tensor, mask: torch.Tensor
                 ) -> torch.Tensor:
    """Per-pixel keep mask from a representative-indexed 0/1 table: the
    table is already an image seeded at the representatives, so one more
    propagation spreads it over each component."""
    m = mask.bool()
    h, w = m.shape[-2], m.shape[-1]
    seed = torch.where(m & keep_table, 1, 0).to(torch.int32)
    return _propagate(seed, m, h + w) > 0


def remove_small_components(mask: torch.Tensor, min_size: int
                            ) -> torch.Tensor:
    """Drop the components of [..., h, w] smaller than `min_size` px."""
    labels = label_components(mask)
    keep = _sizes_2d(labels) >= min_size
    return _spread_keep(keep, mask) & (labels > 0)


def component_count(mask: torch.Tensor, min_size: int = 1) -> torch.Tensor:
    """Number of distinct components with ≥ min_size pixels, per image."""
    return (_sizes_2d(label_components(mask)) >= min_size).sum(dim=(-2, -1))
