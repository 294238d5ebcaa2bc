"""One connected-components propagation round: CUDA kernel and plain twin.

Port of `leaffliction_tpu/ops/pallas/components.py::propagate_round_pallas`.
`cc_round` launches `csrc/cc_round.cu` for CUDA tensors and runs
`cc_round_plain` for CPU tensors; any other device raises. Both are integer
only and give the same bits.

Inputs are [n, h, w]: int32 labels, a bool/uint8 mask, and the four int32
segment planes (barrier counts shifted above `label_bits`, see
`ops/components._propagate`): `seg_f0`/`seg_b0` scan along axis 0 (columns),
`seg_f1`/`seg_b1` along axis 1 (rows).
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


def cc_round_plain(labels, mask, seg_f0, seg_b0, seg_f1, seg_b1,
                   label_bits: int) -> torch.Tensor:
    """The round in plain PyTorch: 3x3 max → row scans → column scans."""
    mask = mask.bool()
    low = (1 << label_bits) - 1
    lab = torch.where(mask, _max3x3(labels), 0)
    lab = _scan_pair(lab, mask, seg_f1, seg_b1, -1, low)
    return _scan_pair(lab, mask, seg_f0, seg_b0, -2, low)


def cc_round(labels, mask, seg_f0, seg_b0, seg_f1, seg_b1,
             label_bits: int) -> torch.Tensor:
    """One round on [n, h, w] int32 labels → int32 [n, h, w]."""
    if labels.device.type == "cpu":
        return cc_round_plain(labels, mask, seg_f0, seg_b0, seg_f1, seg_b1,
                              label_bits)
    if labels.device.type != "cuda":
        raise ValueError(f"cc_round: no kernel for device {labels.device}")
    if labels.dim() != 3:
        raise ValueError(f"cc_round: want [n, h, w], got {tuple(labels.shape)}")
    segs = (seg_f0, seg_b0, seg_f1, seg_b1)
    for t in (labels,) + segs:
        if (t.dtype != torch.int32 or t.shape != labels.shape
                or t.device != labels.device or not t.is_contiguous()):
            raise ValueError("cc_round: labels and segment planes must be "
                             "contiguous int32 of one shape and device")
    if mask.shape != labels.shape or mask.device != labels.device:
        raise ValueError("cc_round: mask must match the labels")
    if not 0 < label_bits < 31:
        raise ValueError(f"cc_round: label_bits {label_bits} out of range")
    # a bool mask is read in place as bytes (no cast launch per round)
    mask_u8 = (mask if mask.dtype == torch.bool else mask != 0
               ).contiguous().view(torch.uint8)
    grown = torch.empty_like(labels)
    rows = torch.empty_like(labels)
    out = torch.empty_like(labels)
    n, h, w = labels.shape
    lib = build.load()
    with torch.cuda.device(labels.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.leaf_cc_round(
            labels.data_ptr(), mask_u8.data_ptr(), seg_f0.data_ptr(),
            seg_b0.data_ptr(), seg_f1.data_ptr(), seg_b1.data_ptr(),
            grown.data_ptr(), rows.data_ptr(), out.data_ptr(),
            n, h, w, label_bits, stream)
    cc_round.launches += 1
    build.check(rc, "leaf_cc_round")
    return out


cc_round.launches = 0
