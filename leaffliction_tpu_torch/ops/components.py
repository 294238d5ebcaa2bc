"""Connected components by iterative label propagation.

Port of `leaffliction_tpu/ops/components.py`. Every foreground pixel is
seeded with its flat index + 1 and the max label is spread through each
component (8-connectivity) until a round changes nothing; each component
ends up labelled by its maximum flat index + 1. A round is a 3x3 max and a
segmented max-scan along rows and then columns (`ops/kernels/components`,
the CUDA kernel on the card).

The segmented scan is a plain cummax over `segment_id << label_bits | label`,
where segment_id counts the background pixels up to each position: the max
then never crosses background. Images too large for that packing in int32
take the same round in int64 (plain PyTorch, as in the JAX package, where
that path is not a kernel either).

The convergence loop runs on the host: one `torch.equal` per round.
"""

from __future__ import annotations

import torch

from leaffliction_tpu_torch.ops.kernels.components import (
    _max3x3,
    _scan_pair,
    cc_round,
)


def _segment_planes(mask: torch.Tensor, label_bits: int, dtype):
    """fwd/bwd barrier counts along axis 0 and axis 1, shifted into the
    high bits: (seg_f0, seg_b0, seg_f1, seg_b1), each like `mask`."""
    bar = (~mask).to(dtype)

    def rev_cumsum(dim):
        return torch.cumsum(bar.flip(dim), dim).flip(dim)

    planes = (torch.cumsum(bar, -2), rev_cumsum(-2),
              torch.cumsum(bar, -1), rev_cumsum(-1))
    return tuple((p.to(dtype) << label_bits).contiguous() for p in planes)


def _round_wide(lab, mask, segs, label_bits: int) -> torch.Tensor:
    """One round with int64-packed segment planes (plain PyTorch), columns
    first and then rows, in the order of the JAX tuple-scan round."""
    seg_f0, seg_b0, seg_f1, seg_b1 = segs
    low = (1 << label_bits) - 1
    x = torch.where(mask, _max3x3(lab.long()), 0)
    x = _scan_pair(x, mask, seg_f0, seg_b0, -2, low)
    return _scan_pair(x, mask, seg_f1, seg_b1, -1, low).to(torch.int32)


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

    label_bits = (h * w + 1).bit_length()
    seg_bits = max(h + 1, w + 1).bit_length()
    if label_bits + seg_bits > 31:  # int32 sign bit must stay clear
        segs = _segment_planes(m, label_bits, torch.int64)

        def step(x):
            return _round_wide(x, m, segs, label_bits)
    else:
        segs = _segment_planes(m, label_bits, torch.int32)

        def step(x):
            return cc_round(x, m, *segs, label_bits)

    prev, cur = lab, step(lab)
    i = 0
    while i < limit and not torch.equal(prev, cur):
        prev, cur = cur, step(cur)
        i += 1
    return cur.reshape(shape)


def label_components(mask: torch.Tensor) -> torch.Tensor:
    """int32 label image: 0 = background, components share a unique id."""
    m = mask.bool()
    h, w = m.shape[-2], m.shape[-1]
    flat = torch.arange(1, h * w + 1, dtype=torch.int32,
                        device=m.device).reshape(h, w)
    return _propagate(torch.where(m, flat, 0), m, h + w)


def _sizes_2d(labels: torch.Tensor) -> torch.Tensor:
    """Pixel counts of one [h, w] label image, as an [h, w] int64 grid
    indexed by each component representative's (row, col)."""
    h, w = labels.shape
    counts = torch.bincount(labels.reshape(-1).long(), minlength=h * w + 1)
    return counts[1:].reshape(h, w)


def largest_component(mask: torch.Tensor) -> torch.Tensor:
    """Boolean mask of the largest component of [h, w] (empty-safe); ties
    go to the smallest label."""
    labels = label_components(mask)
    sizes = _sizes_2d(labels)
    best_label = torch.argmax(sizes.reshape(-1)) + 1
    return (labels == best_label) & (sizes.max() > 0)


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
    """Drop the components of [h, w] smaller than `min_size` px."""
    labels = label_components(mask)
    keep = _sizes_2d(labels) >= min_size
    return _spread_keep(keep, mask) & (labels > 0)


def component_count(mask: torch.Tensor, min_size: int = 1) -> torch.Tensor:
    """Number of distinct components with ≥ min_size pixels."""
    return (_sizes_2d(label_components(mask)) >= min_size).sum()
