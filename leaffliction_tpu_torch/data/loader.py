"""Host-side input pipeline: decode once, cache, stream uint8 batches.

Copy of `leaffliction_tpu/data/loader.py`:

- each image is decoded and resized ONCE into a uint8 cache (`ImageStore`,
  through `data/native.decode_batch_with_fallback`);
- per epoch, batches are fancy-indexed out of the cache, shuffled with a
  per-epoch seed; the final partial batch is padded to the batch size with
  wrap-around rows and a validity mask (or dropped, `drop_remainder`);
- a data-parallel run shards the items by stride (`items_for_process`)
  and pads every rank to the same step count (`global_steps_per_epoch`,
  `BatchIterator(pad_to_steps=)`, zero-mask batches);
- `DeviceImageStore` stands for a dataset whose pixels live only on the
  device (the fused balance → train path): batches then carry indices and
  labels, not pixels.

`apply_training_transform` and `apply_training_transform_device` port the
train CLI's `--transform` (leaf on white through the batched mask pipeline
of `segment/mask`), for a host store and for rows on the device.
"""

from __future__ import annotations

import os
from typing import Callable, Iterator, NamedTuple, Optional, Sequence

import numpy as np

from leaffliction_tpu_torch.core.logging import get_logger
from leaffliction_tpu_torch.data.manifest import ManifestItem

LOGGER = get_logger(__name__)


def decode_resize_pil(path: str, img_size: int) -> np.ndarray:
    """PIL decode → RGB → LANCZOS resize → uint8 HWC. `Image.draft` lets
    libjpeg downscale in the DCT domain first when the source is large."""
    from PIL import Image

    with Image.open(path) as im:
        im.draft("RGB", (img_size * 2, img_size * 2))
        im = im.convert("RGB")
        if im.size != (img_size, img_size):
            im = im.resize((img_size, img_size), Image.LANCZOS)
        return np.asarray(im, np.uint8)


def default_decode_fn() -> Callable[[str, int], np.ndarray]:
    """The native libjpeg decoder when it builds, else PIL.
    LEAF_NATIVE_DECODE=0 forces PIL (exact LANCZOS parity)."""
    if os.environ.get("LEAF_NATIVE_DECODE", "1") != "0":
        from leaffliction_tpu_torch.data import native

        if native.native_available():
            return native.decode_resize_native
    return decode_resize_pil


class Batch(NamedTuple):
    images: np.ndarray   # [B, S, S, 3] uint8
    labels: np.ndarray   # [B] int32
    mask: np.ndarray     # [B] float32, 0 for padding
    indices: np.ndarray  # [B] int32 store row of every slot, padding too


class ImageStore:
    """Decoded-image cache for a list of manifest items at a fixed size."""

    def __init__(self, items: Sequence[ManifestItem], label2idx: dict,
                 img_size: int) -> None:
        from leaffliction_tpu_torch.data.native import (
            decode_batch_with_fallback,
        )

        self.items = list(items)
        self.img_size = img_size
        self.labels = np.asarray(
            [label2idx[it.label] for it in self.items], np.int32)
        self.images, self.valid = decode_batch_with_fallback(
            [it.src for it in self.items], img_size, workers=4)
        n_bad = int(len(self.items) - self.valid.sum())
        if n_bad:
            LOGGER.warning("%d/%d images failed to decode", n_bad,
                           len(self.items))

    def __len__(self) -> int:
        return len(self.items)

    @property
    def valid_indices(self) -> np.ndarray:
        return np.nonzero(self.valid)[0].astype(np.int32)


class DeviceImageStore:
    """ImageStore-shaped view of a dataset whose pixels live ONLY on the
    device. `images` is a zero-filled placeholder (never-written numpy zeros
    take no real memory); training must take the gather path, which reads
    the device rows by `Batch.indices`."""

    def __init__(self, labels: np.ndarray, img_size: int) -> None:
        self.items: list = []
        self.img_size = img_size
        self.labels = np.asarray(labels, np.int32)
        n = len(self.labels)
        self.images = np.zeros((n, img_size, img_size, 3), np.uint8)
        self.valid = np.ones((n,), bool)
        self.host_pixels = False

    def __len__(self) -> int:
        return len(self.labels)

    @property
    def valid_indices(self) -> np.ndarray:
        return np.nonzero(self.valid)[0].astype(np.int32)


class BatchIterator:
    """Fixed-size batch stream over an ImageStore or a DeviceImageStore."""

    def __init__(self, store, batch_size: int, shuffle: bool, seed: int = 0,
                 drop_remainder: bool = False,
                 pad_to_steps: Optional[int] = None) -> None:
        """`pad_to_steps` fixes the number of batches per epoch whatever
        the local data volume, padding with zero-mask batches: every rank
        of a data-parallel run must take the same number of steps (each is
        a collective), and stride shards differ by up to one item. Derive
        it from the global item count (`global_steps_per_epoch`)."""
        self.store = store
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.pad_to_steps = pad_to_steps

    def steps_per_epoch(self) -> int:
        if self.pad_to_steps is not None:
            return self.pad_to_steps
        n = len(self.store.valid_indices)
        if self.drop_remainder:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _pixels(self, sel: np.ndarray) -> np.ndarray:
        """Host pixel rows of a batch, or a (B, 1, 1, 3) zero stand-in when
        the store's pixels live only on the device."""
        if getattr(self.store, "host_pixels", True):
            return self.store.images[sel]
        return np.zeros((len(sel), 1, 1, 3), np.uint8)

    def epoch(self, epoch_idx: int = 0) -> Iterator[Batch]:
        bs = self.batch_size
        yielded = 0
        for batch in self._local_epoch(epoch_idx):
            if self.pad_to_steps is not None and yielded >= self.pad_to_steps:
                break
            yielded += 1
            yield batch
        if self.pad_to_steps is not None:
            size = self.store.img_size
            if not getattr(self.store, "host_pixels", True):
                size = 1
            while yielded < self.pad_to_steps:
                yielded += 1
                yield Batch(
                    images=np.zeros((bs, size, size, 3), np.uint8),
                    labels=np.zeros((bs,), np.int32),
                    mask=np.zeros((bs,), np.float32),
                    indices=np.zeros((bs,), np.int32),
                )

    def _local_epoch(self, epoch_idx: int = 0) -> Iterator[Batch]:
        idx = self.store.valid_indices.copy()
        if self.shuffle:
            rng = np.random.default_rng(self.seed + epoch_idx)
            rng.shuffle(idx)
        bs = self.batch_size
        end = len(idx) // bs * bs
        for s in range(0, end, bs):
            sel = idx[s:s + bs]
            yield Batch(images=self._pixels(sel),
                        labels=self.store.labels[sel],
                        mask=np.ones((bs,), np.float32), indices=sel)
        if not self.drop_remainder and end < len(idx):
            sel = idx[end:]
            pad = bs - len(sel)
            # wrap-around rows of this epoch's permutation, not repeats of
            # one image: padding is masked out of the loss but still enters
            # the BatchNorm batch statistics
            sel_pad = np.concatenate([sel, np.resize(idx, pad)]
                                     ).astype(np.int32)
            mask = np.concatenate([np.ones((len(sel),), np.float32),
                                   np.zeros((pad,), np.float32)])
            yield Batch(images=self._pixels(sel_pad),
                        labels=self.store.labels[sel_pad], mask=mask,
                        indices=sel_pad)


def _transform_cfg(cfg):
    """The training transform's default: the mask at the stored size, no
    GrabCut."""
    from leaffliction_tpu_torch.segment.config import TransformConfig

    return cfg or TransformConfig(mask_upscale_factor=1.0,
                                  mask_upscale_long_side=0,
                                  grabcut_refine=False)


def apply_training_transform(store: ImageStore, cfg=None,
                             device_batch: int = 64, device="cuda") -> None:
    """Replace the cached images with mask-segmented versions (leaf on
    white), in place: the store goes to `device`, through
    `apply_training_transform_device`, and back."""
    import torch

    n = len(store.images)
    out = apply_training_transform_device(
        torch.from_numpy(store.images).to(device), cfg, device_batch)
    store.images[...] = out.cpu().numpy()
    LOGGER.info("Applied training transform (masked, white bg) to %d images",
                n)

    # env-gated previews (reference LEAF_SAVE_TRANSFORMS)
    if os.environ.get("LEAF_SAVE_TRANSFORMS"):
        from pathlib import Path

        from PIL import Image

        out_dir = Path(os.environ.get("LEAF_SAVE_TRANSFORMS_DIR",
                                      "artifacts/transform_previews"))
        out_dir.mkdir(parents=True, exist_ok=True)
        for i in range(min(8, n)):
            Image.fromarray(store.images[i]).save(
                out_dir / f"preview_{i}.jpg", quality=95)
        LOGGER.info("Saved transform previews to %s", out_dir)


def apply_training_transform_device(images_dev, cfg=None,
                                    device_batch: int = 64):
    """Device-to-device `apply_training_transform` for the fused balance →
    train path: uint8 [N, S, S, 3] on the device → leaf-on-white uint8 on
    the device. Only the chunk scores are read back (the fallback check),
    four chunks behind the newest queued one, so at most five chunks'
    masks are alive at once."""
    from collections import deque

    import torch

    from leaffliction_tpu_torch.segment.mask import (
        finalize_mask_batch,
        make_mask_batch_async,
    )

    cfg = _transform_cfg(cfg)
    white = torch.tensor(255, dtype=torch.uint8, device=images_dev.device)

    def finish(entry):
        chunk, masks, scores = entry
        masks = finalize_mask_batch(chunk, masks, scores, cfg)
        return torch.where(masks[..., None], chunk, white)

    pending: deque = deque()
    outs = []
    for start in range(0, images_dev.shape[0], device_batch):
        chunk = images_dev[start:start + device_batch]
        pending.append((chunk, *make_mask_batch_async(chunk, cfg)))
        if len(pending) > 4:
            outs.append(finish(pending.popleft()))
    while pending:
        outs.append(finish(pending.popleft()))
    LOGGER.info("Applied training transform on device to %d images",
                images_dev.shape[0])
    return torch.cat(outs) if outs else images_dev


def global_steps_per_epoch(global_item_count: int, batch_size: int,
                           process_count: Optional[int] = None) -> int:
    """Steps per epoch every rank must run, from the GLOBAL item count:
    with stride sharding (`items_for_process`) the largest shard is
    ceil(N / P), which needs ceil(ceil(N / P) / B) batches; smaller shards
    pad with zero-mask batches (`BatchIterator(pad_to_steps=...)`), so the
    collective step count and the cosine schedule's total_steps are the
    same on every rank."""
    import math

    pc = process_count
    if pc is None:
        from leaffliction_tpu_torch.parallel.distributed import world_size

        pc = world_size()
    per_host = math.ceil(global_item_count / max(pc, 1))
    return max(1, math.ceil(per_host / batch_size))


def items_for_process(items, process_index: Optional[int] = None,
                      process_count: Optional[int] = None):
    """This rank's stride of the manifest items (item i goes to rank
    i mod P), so each rank decodes only its shard."""
    from leaffliction_tpu_torch.parallel import distributed

    pi = distributed.rank() if process_index is None else process_index
    pc = (distributed.world_size() if process_count is None
          else process_count)
    if pc <= 1:
        return list(items)
    return [it for i, it in enumerate(items) if i % pc == pi]


def sample_batch(store: ImageStore, n: int) -> np.ndarray:
    """Up to `n` images for the normalization statistics."""
    return store.images[store.valid_indices[:n]]
