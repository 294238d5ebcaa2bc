"""Load a trained model from the artifacts directory onto a device.

Port of `leaffliction_tpu/predict/model_loader.py`: reads `meta.json` for
labels, image size and the model block, and the flax checkpoint
`leaf_cnn.msgpack` it points at, through the parameter bridge
(`convert.py`), or a `.keras` file (`train/keras_export.import_keras`:
the architecture inferred from the graph, f32 unless
`training.mixed_precision` is true, the head's width checked against the
labels). `model.name` `resnet10` or `resnet18` builds that ResNet
preset (with `model.stem` and `model.use_normalization`); any other name
builds LeafCNN from the block's widths, `separable`, `stem` and
`use_normalization`. `training.mixed_precision` defaults to True, which
means bf16 compute over f32 parameters.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from leaffliction_tpu_torch.core.logging import get_logger
from leaffliction_tpu_torch.convert import to_state_dict
from leaffliction_tpu_torch.models.leafcnn import LeafCNN
from leaffliction_tpu_torch.models.resnet import RESNET_PRESETS, build_resnet
from leaffliction_tpu_torch.train.checkpoint import load_model_msgpack

LOGGER = get_logger(__name__)


class ModelLoader:
    def __init__(self, learnings_dir: Path | str,
                 device: torch.device | str = "cuda") -> None:
        self.learnings_dir = Path(learnings_dir)
        self.device = torch.device(device)
        self.meta: Dict[str, Any] = {}
        self.model: Optional[torch.nn.Module] = None

    def load(self) -> "ModelLoader":
        meta_path = self.learnings_dir / "meta.json"
        if not meta_path.exists():
            raise FileNotFoundError(f"Meta file not found: {meta_path}")
        self.meta = json.loads(meta_path.read_text())

        model_file = Path(self.meta["model_file"])
        if not model_file.is_absolute():
            # meta records a path relative to the training run's cwd: the
            # learnings dir the user pointed at wins over the caller's cwd
            local = self.learnings_dir / model_file.name
            if local.exists():
                model_file = local
        mcfg = self.meta.get("model", {})
        training = self.meta.get("training", {})
        if model_file.suffix == ".keras":
            # a reference-trained (or exported) artifact dir: the graph's
            # weights mapped into a LeafCNN whose architecture is inferred
            # from the graph. f32 unless the meta asks for mixed precision:
            # the reference's meta.json has no training.mixed_precision,
            # and bf16 would drift from the user's own Keras predictions
            from leaffliction_tpu_torch.train.keras_export import (
                import_keras,
            )

            use_bf16 = bool(training.get("mixed_precision", False))
            model, _ = import_keras(
                model_file,
                dtype=torch.bfloat16 if use_bf16 else torch.float32)
            if self.labels and model.num_classes != self.num_classes:
                raise ValueError(
                    f"meta.json lists {self.num_classes} labels but the "
                    f".keras graph's head is {model.num_classes}-wide: "
                    "predictions would be decoded against wrong labels")
            self.model = model.to(self.device).eval()
            LOGGER.info("Keras model loaded from %s (%d classes) on %s",
                        model_file, self.num_classes, self.device)
            return self
        arch = mcfg.get("name", "leaf_cnn")
        use_bf16 = training.get("mixed_precision", True)
        dtype = torch.bfloat16 if use_bf16 else torch.float32
        if arch in RESNET_PRESETS:
            model = build_resnet(
                self.num_classes, arch,
                use_norm=bool(mcfg.get("use_normalization", True)),
                stem=mcfg.get("stem", "conv"), dtype=dtype)
        else:
            model = LeafCNN(
                num_classes=self.num_classes,
                widths=tuple(mcfg.get("widths", (32, 64, 128, 256))),
                separable=bool(mcfg.get("separable", False)),
                use_norm=bool(mcfg.get("use_normalization", True)),
                stem=mcfg.get("stem", "conv"),
                dtype=dtype,
            )
        restored = load_model_msgpack(model_file)
        model.load_state_dict(to_state_dict(restored))
        self.model = model.to(self.device).eval()
        LOGGER.info("Model loaded from %s (%d classes) on %s", model_file,
                    self.num_classes, self.device)
        return self

    @property
    def labels(self) -> List[str]:
        return list(self.meta.get("labels", []))

    @property
    def num_classes(self) -> int:
        return len(self.labels) or int(
            self.meta.get("data", {}).get("num_classes", 0))

    @property
    def img_size(self) -> int:
        return int(self.meta.get("data", {}).get("img_size", 224))
