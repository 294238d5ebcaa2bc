"""Transform-stack configuration: the 28-field frozen dataclass and its
strict YAML load.

A copy of `leaffliction_tpu/segment/config.py` (same fields, same defaults,
the same `load_config` that exits with 1 on a missing file or field), with
the port's own copy of `config.yaml` beside it, because that package's
`segment/__init__.py` imports the JAX mask pipeline.
`tests/test_torch_segment.py` holds the two dataclasses equal field by field
and `tests/test_torch_host_copies.py` the two loads.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path
from typing import Optional, Tuple

from leaffliction_tpu_torch.core.logging import get_logger

LOGGER = get_logger(__name__)


@dataclasses.dataclass(frozen=True)
class TransformConfig:
    gaussian_sigma: float = 1.5
    hsv_channel_for_mask: str = "s"
    fill_size: int = 1000
    morph_kernel: int = 3
    landmarks_count: int = 80
    roi_size: Tuple[int, int] = (256, 256)
    mask_strategy: str = "inclusive"
    bg_bias: Optional[str] = "light_bg"
    grabcut_refine: bool = True
    green_hue_range: Tuple[int, int] = (25, 100)
    min_object_area_ratio: float = 0.10
    max_object_area_ratio: float = 0.98
    mask_upscale_factor: float = 1.3
    mask_upscale_long_side: int = 1500
    shadow_suppression: bool = False
    shadow_s_max: int = 40
    shadow_v_method: str = "percentile"
    shadow_v_percentile: int = 5
    shadow_morphology_kernel: int = 3
    brown_hue_range: Tuple[int, int] = (0, 30)
    brown_s_min: int = 20
    brown_v_max: int = 200
    brown_min_area_px: int = 25
    brown_morph_kernel: int = 3
    use_lab_brown: bool = False
    lab_b_min: int = 125
    lab_a_min: int = 125
    debug_shadow_visualization: bool = False


REQUIRED_FIELDS = [f.name for f in dataclasses.fields(TransformConfig)]


def load_config(path: Optional[Path]) -> TransformConfig:
    """Strict YAML load; exits(1) on missing file/fields like the reference
    (`Transformation.py:105-185`)."""
    import yaml

    if not path:
        LOGGER.error("No configuration file path provided")
        sys.exit(1)
    path = Path(path)
    if not path.exists():
        LOGGER.error("Configuration file not found: %s", path)
        sys.exit(1)
    try:
        with path.open("r", encoding="utf-8") as f:
            data = yaml.safe_load(f) or {}
        missing = [f for f in REQUIRED_FIELDS if f not in data]
        if missing:
            LOGGER.error("Missing required configuration fields: %s", missing)
            sys.exit(1)
        return TransformConfig(
            gaussian_sigma=float(data["gaussian_sigma"]),
            hsv_channel_for_mask=str(data["hsv_channel_for_mask"]),
            fill_size=int(data["fill_size"]),
            morph_kernel=int(data["morph_kernel"]),
            landmarks_count=int(data["landmarks_count"]),
            roi_size=tuple(data["roi_size"]),
            mask_strategy=str(data["mask_strategy"]),
            bg_bias=data["bg_bias"],
            grabcut_refine=bool(data["grabcut_refine"]),
            green_hue_range=tuple(data["green_hue_range"]),
            min_object_area_ratio=float(data["min_object_area_ratio"]),
            max_object_area_ratio=float(data["max_object_area_ratio"]),
            mask_upscale_factor=float(data["mask_upscale_factor"]),
            mask_upscale_long_side=int(data["mask_upscale_long_side"]),
            shadow_suppression=bool(data["shadow_suppression"]),
            shadow_s_max=int(data["shadow_s_max"]),
            shadow_v_method=str(data["shadow_v_method"]),
            shadow_v_percentile=int(data["shadow_v_percentile"]),
            shadow_morphology_kernel=int(data["shadow_morphology_kernel"]),
            brown_hue_range=tuple(data["brown_hue_range"]),
            brown_s_min=int(data["brown_s_min"]),
            brown_v_max=int(data["brown_v_max"]),
            brown_min_area_px=int(data["brown_min_area_px"]),
            brown_morph_kernel=int(data["brown_morph_kernel"]),
            use_lab_brown=bool(data["use_lab_brown"]),
            lab_b_min=int(data["lab_b_min"]),
            lab_a_min=int(data["lab_a_min"]),
            debug_shadow_visualization=bool(data["debug_shadow_visualization"]),
        )
    except SystemExit:
        raise
    except Exception as exc:
        LOGGER.error("Failed to read configuration file (%s)", exc)
        sys.exit(1)


def default_config_path() -> Path:
    return Path(__file__).parent / "config.yaml"
