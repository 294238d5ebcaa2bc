"""Transform-stack configuration: the 28-field frozen dataclass.

A copy of `leaffliction_tpu/segment/config.py::TransformConfig` (same fields,
same defaults), because that package's `segment/__init__.py` imports the JAX
mask pipeline. `tests/test_torch_segment.py` holds the two equal field by
field.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


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
