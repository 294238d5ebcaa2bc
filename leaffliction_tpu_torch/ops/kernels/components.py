"""Connected-components propagation to the fixpoint: CUDA kernel and plain
twin.

Port of `leaffliction_tpu/ops/pallas/components.py::propagate_round_pallas`
and the convergence loop around it in `leaffliction_tpu/ops/components.py`.
`cc_propagate` launches `csrc/cc_propagate.cu` once for CUDA tensors (every
round on the card, no host synchronisation) and runs `cc_propagate_plain`
for CPU tensors; any other device raises. Both are integer only and give the
same bits, labels and round counts.

`cc_round_plain` is one round, in the Pallas kernel's phase order, over the
packed segment planes of `_segment_planes` (barrier counts shifted above
`label_bits`, so a plain cummax restarts at every background pixel):
`seg_f0`/`seg_b0` scan along axis 0 (columns), `seg_f1`/`seg_b1` along
axis 1 (rows).
"""

from __future__ import annotations

import torch

from leaffliction_tpu_torch.kernels import build


def _max3x3(lab: torch.Tensor) -> torch.Tensor:
    """3x3 max with zeros beyond the edge, from zero-padded shifted slices."""
    h, w = lab.shape[-2], lab.shape[-1]
    p = torch.nn.functional.pad(lab, (1, 1, 1, 1))
    rows = torch.maximum(torch.maximum(p[..., 0:h, :], p[..., 1:h + 1, :]),
                         p[..., 2:h + 2, :])
    return torch.maximum(torch.maximum(rows[..., 0:w], rows[..., 1:w + 1]),
                         rows[..., 2:w + 2])


def _scan_pair(lab, mask, seg_f, seg_b, dim: int, low: int) -> torch.Tensor:
    fwd = torch.cummax(seg_f | lab, dim=dim).values & low
    bwd = torch.cummax((seg_b | lab).flip(dim), dim=dim).values.flip(dim) & low
    return torch.where(mask, torch.maximum(fwd, bwd), 0)


def _segment_planes(mask: torch.Tensor, label_bits: int, dtype):
    """fwd/bwd barrier counts along axis 0 and axis 1, shifted into the
    high bits: (seg_f0, seg_b0, seg_f1, seg_b1), each like `mask`."""
    bar = (~mask).to(dtype)

    def rev_cumsum(dim):
        return torch.cumsum(bar.flip(dim), dim).flip(dim)

    planes = (torch.cumsum(bar, -2), rev_cumsum(-2),
              torch.cumsum(bar, -1), rev_cumsum(-1))
    return tuple((p.to(dtype) << label_bits).contiguous() for p in planes)


def packs_in_int32(h: int, w: int) -> bool:
    """Whether `seg << label_bits | label` fits below the int32 sign bit."""
    label_bits = (h * w + 1).bit_length()
    return label_bits + max(h + 1, w + 1).bit_length() <= 31


def cc_round_plain(labels, mask, seg_f0, seg_b0, seg_f1, seg_b1,
                   label_bits: int) -> torch.Tensor:
    """One round in plain PyTorch: 3x3 max → row scans → column scans."""
    mask = mask.bool()
    low = (1 << label_bits) - 1
    lab = torch.where(mask, _max3x3(labels), 0)
    lab = _scan_pair(lab, mask, seg_f1, seg_b1, -1, low)
    return _scan_pair(lab, mask, seg_f0, seg_b0, -2, low)


def cc_propagate_plain(labels: torch.Tensor, mask: torch.Tensor, limit: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The host loop over `cc_round_plain` on [n, h, w]: at most 1 + limit
    rounds, stopping after the first round that changes nothing.

    → (int32 labels [n, h, w], int32 [n] rounds each image ran: 1 + the
    rounds after its first that changed it). An image that has converged
    stays as it is, so running the batch together gives each image's own
    labels. Images too large for the int32 packing scan in int64."""
    n, h, w = labels.shape
    mask = mask.bool()
    label_bits = (h * w + 1).bit_length()
    segs = _segment_planes(mask, label_bits, torch.int32
                           if packs_in_int32(h, w) else torch.int64)

    def step(x):
        return cc_round_plain(x, mask, *segs, label_bits).to(torch.int32)

    prev, cur = labels.to(torch.int32), step(labels)
    rounds = torch.ones(n, dtype=torch.int32, device=labels.device)
    for _ in range(limit):
        changed = (prev != cur).reshape(n, -1).any(1)
        if not bool(changed.any()):
            break
        rounds += changed.to(torch.int32)
        prev, cur = cur, step(cur)
    return cur, rounds


def cc_propagate(labels: torch.Tensor, mask: torch.Tensor, limit: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Propagation to the fixpoint on int32 [n, h, w] labels in [0, h*w]
    (as `ops/components` seeds them) and a bool mask → (int32 labels,
    int32 [n] rounds), as `cc_propagate_plain`."""
    if labels.device.type == "cpu":
        return cc_propagate_plain(labels, mask, limit)
    if labels.device.type != "cuda":
        raise ValueError(f"cc_propagate: no kernel for device "
                         f"{labels.device}")
    if labels.dim() != 3 or labels.dtype != torch.int32 \
            or not labels.is_contiguous():
        raise ValueError("cc_propagate: labels must be contiguous int32 "
                         f"[n, h, w], got {labels.dtype} "
                         f"{tuple(labels.shape)}")
    if mask.dtype != torch.bool or mask.shape != labels.shape \
            or mask.device != labels.device or not mask.is_contiguous():
        raise ValueError("cc_propagate: mask must be a contiguous bool "
                         "tensor like the labels")
    n, h, w = labels.shape
    if h * w + 1 >= 2 ** 31:
        raise ValueError(f"cc_propagate: {h}x{w} labels overflow int32")
    if not 0 <= limit < 2 ** 31 - 1:
        raise ValueError(f"cc_propagate: limit {limit} out of range")
    out = torch.empty_like(labels)
    rounds = torch.empty(n, dtype=torch.int32, device=labels.device)
    if n == 0:
        return out, rounds
    lib = build.load()
    # images that fit in shared memory need no global row plane
    scratch = None if lib.leaf_cc_propagate_smem_bytes(h, w) \
        else torch.empty_like(labels)
    dev = labels.get_device()
    rc = lib.leaf_cc_propagate(
        labels.data_ptr(), mask.view(torch.uint8).data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), rounds.data_ptr(),
        n, h, w, limit, dev, build.current_stream(dev))
    cc_propagate.launches += 1
    build.check(rc, "leaf_cc_propagate")
    return out, rounds


cc_propagate.launches = 0
build.register_launches("cc_propagate", vars(cc_propagate))
