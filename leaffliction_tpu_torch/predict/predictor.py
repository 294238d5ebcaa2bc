"""Single/batch prediction on one device or a serving mesh.

Port of `leaffliction_tpu/predict/predictor.py`, with its serving mesh
(`devices=`: a model replica on each device, each chunk split over them).
Inference runs at a fixed
serving batch (`SERVING_BATCH = 64`, zero-padded); each chunk is uploaded
from pinned memory without blocking, `/255`, run through the model's
forward (LeafCNN or LeafResNet, as `ModelLoader` built it) and a softmax
in f32. Every chunk is enqueued before any result is copied
back, so uploads overlap the previous chunk's compute. Batch decode is the
port's copy of the JAX package's host pipeline (`data/native`: batched C++
JPEG decode, threaded PIL fallback), three chunks in flight. The mask montage runs the port's
segmentation on the same device.
"""

from __future__ import annotations

import concurrent.futures as cf
import copy
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from leaffliction_tpu_torch.core.logging import get_logger
from leaffliction_tpu_torch.data.loader import (
    decode_resize_pil,
    default_decode_fn,
)
from leaffliction_tpu_torch.data.native import decode_batch_with_fallback
from leaffliction_tpu_torch.predict.model_loader import ModelLoader

LOGGER = get_logger(__name__)

SERVING_BATCH = 64


def serving_devices(devices: Optional[Sequence[torch.device | str]]
                    ) -> List[torch.device]:
    """Check a serving mesh's devices (`_build_infer`'s conditions in the
    JAX package): one process only, and a data axis that divides
    SERVING_BATCH. A device may repeat: its slices then share one
    replica."""
    from leaffliction_tpu_torch.parallel.distributed import world_size

    devices = [torch.device(d) for d in devices]
    if len(devices) > 1 and world_size() > 1:
        raise ValueError(
            "mesh serving is single-process (every slice's probabilities "
            "are gathered in this process); run one server per host "
            "instead")
    if SERVING_BATCH % len(devices):
        raise ValueError(
            f"serving batch {SERVING_BATCH} not divisible by the mesh "
            f"data axis ({len(devices)})")
    return devices


class Predictor:
    """`devices=[d0, d1, ...]` is the serving mesh (JAX's `data` axis):
    one model replica on each device, each 64-image chunk split into
    len(devices) equal slices run on their devices, the probabilities
    gathered in order. Without it, one device (`device`)."""

    def __init__(self, learnings_dir: Path | str,
                 device: torch.device | str = "cuda",
                 devices: Optional[Sequence[torch.device | str]] = None
                 ) -> None:
        self.learnings_dir = Path(learnings_dir)
        self.devices = serving_devices(devices or [device])
        self.device = self.devices[0]
        self.model_loader = ModelLoader(self.learnings_dir, self.device)
        self._replicas: Dict[torch.device, torch.nn.Module] = {}

    def load(self) -> "Predictor":
        self.model_loader.load()
        self._replicate()
        return self

    @classmethod
    def from_model(cls, model: torch.nn.Module, labels: Sequence[str],
                   img_size: int, device: torch.device | str = "cuda",
                   devices: Optional[Sequence[torch.device | str]] = None
                   ) -> "Predictor":
        """Serving path over an in-memory model (no artifact dir)."""
        self = cls.__new__(cls)
        self.learnings_dir = Path(".")
        self.devices = serving_devices(devices or [device])
        self.device = self.devices[0]
        loader = ModelLoader(self.learnings_dir, self.device)
        loader.meta = {"labels": list(labels),
                       "data": {"img_size": int(img_size)}}
        loader.model = model.to(self.device).eval()
        self.model_loader = loader
        self._replicate()
        return self

    def _replicate(self) -> None:
        """A copy of the loaded model on each other distinct mesh device
        (the first device serves the loaded model itself)."""
        model = self.model_loader.model
        self._replicas = {}
        for d in self.devices:
            if d != self.device and d not in self._replicas:
                self._replicas[d] = copy.deepcopy(model).to(d).eval()

    @staticmethod
    def _decode_chunk(paths: List[Path], size: int):
        """→ (uint8 [n,S,S,3], ok [n]): batched C++ decode, PIL fallback."""
        return decode_batch_with_fallback(paths, size)

    # --- core batched forward -------------------------------------------

    def _upload(self, chunk: np.ndarray,
                device: Optional[torch.device] = None) -> torch.Tensor:
        device = device or self.device
        x = torch.from_numpy(np.ascontiguousarray(chunk))
        if device.type == "cuda":
            x = x.pin_memory()
        return x.to(device, non_blocking=True)

    def _forward(self, chunk: np.ndarray, device: torch.device
                 ) -> torch.Tensor:
        x = self._upload(chunk, device).float() / 255.0
        model = (self.model_loader.model if device == self.device
                 else self._replicas[device])
        logits = model(x)
        return torch.softmax(logits.float(), dim=-1)

    @torch.inference_mode()
    def _infer(self, chunk: np.ndarray) -> torch.Tensor:
        """uint8 [B,S,S,3] → f32 probabilities [B,K] on the first device
        (enqueued, not synchronised); on a mesh, slice i of the chunk runs
        on device i."""
        if len(self.devices) == 1:
            return self._forward(chunk, self.device)
        per = chunk.shape[0] // len(self.devices)
        parts = [self._forward(chunk[i * per:(i + 1) * per], d)
                 for i, d in enumerate(self.devices)]
        return torch.cat([p.to(self.device, non_blocking=True)
                          for p in parts])

    @staticmethod
    def _padded(chunk: np.ndarray) -> np.ndarray:
        pad = SERVING_BATCH - chunk.shape[0]
        if pad:
            chunk = np.concatenate(
                [chunk, np.zeros((pad,) + chunk.shape[1:], chunk.dtype)])
        return chunk

    def _probs_for_arrays(self, arrays: np.ndarray) -> np.ndarray:
        """uint8 [N,S,S,3] → probabilities [N,K]; pads to SERVING_BATCH."""
        n = arrays.shape[0]
        pending = [
            (self._infer(self._padded(arrays[s:s + SERVING_BATCH])),
             min(SERVING_BATCH, n - s))
            for s in range(0, n, SERVING_BATCH)
        ]
        out = [p[:used].cpu().numpy() for p, used in pending]
        return np.concatenate(out) if out else np.zeros((0, 0))

    # --- public API --------------------------------------------------------

    def predict_single(self, image_path: Path | str,
                       use_transform: bool = False) -> Dict[str, Any]:
        """→ dict(image_path, top_prediction, confidence, all_probabilities,
        original_array, processed_array)."""
        image_path = Path(image_path)
        size = self.model_loader.img_size
        arr = default_decode_fn()(str(image_path), size)
        probs = self._probs_for_arrays(arr[None])[0]
        labels = self.model_loader.labels
        top = int(np.argmax(probs))

        processed = arr
        if use_transform:
            precomputed = self._find_precomputed_mask(image_path)
            if precomputed is not None:
                processed = precomputed
            else:
                processed = self.generate_mask_visualization(arr)

        return {
            "image_path": image_path,
            "top_prediction": labels[top],
            "confidence": float(probs[top]),
            "all_probabilities": {
                lab: float(p) for lab, p in zip(labels, probs)
            },
            "original_array": arr,
            "processed_array": processed,
        }

    def predict_batch(self, image_paths: Sequence[Path | str]
                      ) -> List[Dict[str, Any]]:
        """Batched prediction over many files; unreadable images are
        skipped with a warning. Decode runs three chunks ahead of the
        device; all probabilities are copied back at the end."""
        paths = [Path(p) for p in image_paths]
        if not paths:
            return []
        size = self.model_loader.img_size
        chunks = [paths[s:s + SERVING_BATCH]
                  for s in range(0, len(paths), SERVING_BATCH)]
        pending = []  # (device probs, rows used)
        ok: List[bool] = []
        with cf.ThreadPoolExecutor(max_workers=3) as pool:
            futures = [pool.submit(self._decode_chunk, c, size)
                       for c in chunks]
            for fut in futures:
                chunk, good = fut.result()
                ok.extend(bool(g) for g in good)
                pending.append((self._infer(self._padded(chunk)),
                                chunk.shape[0]))
        probs = np.concatenate([p[:used].cpu().numpy()
                                for p, used in pending])
        labels = self.model_loader.labels
        results: List[Dict[str, Any]] = []
        for i, path in enumerate(paths):
            if not ok[i]:
                continue
            p = probs[i]
            top = int(np.argmax(p))
            results.append({
                "image_path": path,
                "top_prediction": labels[top],
                "confidence": float(p[top]),
                "all_probabilities": {
                    lab: float(v) for lab, v in zip(labels, p)
                },
            })
        return results

    def _find_precomputed_mask(self, image_path: Path) -> Optional[np.ndarray]:
        """Reuse a transform-CLI mask if present
        (`artifacts/transformations/<N>/<stem>__T_Mask.jpg`)."""
        import re

        match = re.search(r"image \((\d+)\)", image_path.stem)
        number = match.group(1) if match else image_path.stem
        candidate = (Path("artifacts") / "transformations" / number
                     / f"{image_path.stem}__T_Mask.jpg")
        if not candidate.exists():
            return None
        try:
            return decode_resize_pil(str(candidate),
                                     self.model_loader.img_size)
        except Exception:
            return None

    @torch.inference_mode()
    def generate_mask_visualization(self, arr: np.ndarray) -> np.ndarray:
        """Leaf mask over a white background, computed on the device."""
        from leaffliction_tpu_torch.segment.mask import (
            apply_mask_white,
            make_mask_single,
        )

        img = self._upload(arr)
        mask, _ = make_mask_single(img)
        return apply_mask_white(img, mask).to(torch.uint8).cpu().numpy()
