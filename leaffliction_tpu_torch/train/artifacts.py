"""The training artifact set, in the JAX package's schema.

Port of `leaffliction_tpu/train/artifacts.py`: `leaf_cnn.msgpack` (the flax
variable tree through `convert.to_flax`, so that either package's predict
loads it), `labels.json` ({"label2idx": ...}), `history.json`, `meta.json`
and `confusion_matrix.json` (with the PNG where matplotlib is installed).
`meta.json` has the JAX package's keys, except that `torch_version` and
`cuda_version` (null on a CPU build) take the place of `jax_version` and
`flax_version`. A tensor-parallel run hands in the full state dict,
gathered by every rank of the model group (`full_state_dict`), and one
rank writes it.
"""

from __future__ import annotations

import json
from datetime import datetime, timezone
from pathlib import Path
from typing import Any, Dict, List

import torch

from leaffliction_tpu_torch.convert import to_flax
from leaffliction_tpu_torch.core.logging import get_logger
from leaffliction_tpu_torch.parallel.tensor import gather_tensors
from leaffliction_tpu_torch.train.checkpoint import save_model_msgpack
from leaffliction_tpu_torch.train.steps import TrainState
from leaffliction_tpu_torch.utils.confusion import export_confusion

LOGGER = get_logger(__name__)

MODEL_FILENAME = "leaf_cnn.msgpack"


def full_state_dict(state: TrainState) -> Dict[str, torch.Tensor]:
    """The model's full state dict: a sharded state's gathered over the
    model group (every rank of the group calls it)."""
    sd = state.model.state_dict()
    return sd if state.tp is None else gather_tensors(sd, state.sharded,
                                                      state.tp)


def save_training_artifacts(
    out_dir: Path,
    state: TrainState,
    label2idx: Dict[str, int],
    history: Dict[str, List[float]],
    saved_variant: str,
    y_true,
    y_pred,
    meta: Dict[str, Any] | None = None,
    state_dict: Dict[str, torch.Tensor] | None = None,
) -> Path:
    """Write the artifact set; the model is `state_dict` when given (a
    tensor-parallel state's, gathered), else the state's model."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    model_path = out_dir / MODEL_FILENAME
    save_model_msgpack(model_path, to_flax(
        state.model.state_dict() if state_dict is None else state_dict))

    with (out_dir / "labels.json").open("w", encoding="utf-8") as f:
        json.dump({"label2idx": label2idx}, f, indent=2)
    with (out_dir / "history.json").open("w", encoding="utf-8") as f:
        json.dump({k: [float(x) for x in v] for k, v in history.items()},
                  f, indent=2)

    labels_sorted = sorted(label2idx, key=lambda k: label2idx[k])
    meta_out: Dict[str, Any] = {
        "created_at": datetime.now(tz=timezone.utc).isoformat(),
        "model_file": str(model_path),
        "labels_file": str(out_dir / "labels.json"),
        "history_file": str(out_dir / "history.json"),
        "confusion_matrix_file": str(out_dir / "confusion_matrix.json"),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "saved_variant": saved_variant,
        "labels": labels_sorted,
    }
    if meta:
        meta_out.update(meta)
    with (out_dir / "meta.json").open("w", encoding="utf-8") as f:
        json.dump(meta_out, f, indent=2)

    export_confusion(y_true, y_pred, labels_sorted, out_dir)
    LOGGER.info("Artifacts written to %s", out_dir.resolve())
    return model_path
