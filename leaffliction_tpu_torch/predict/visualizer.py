"""Prediction montage (original | mask, caption), drawn on the host with
PIL.

Copy of `leaffliction_tpu/predict/visualizer.py`: two 224² tiles side by side
with a "Prediction: X (c%)" caption.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict

import numpy as np

from leaffliction_tpu_torch.core.logging import get_logger

LOGGER = get_logger(__name__)


class PredictionVisualizer:
    def __init__(self, font_size: int = 20) -> None:
        self.font_size = font_size

    def create_montage(self, result: Dict[str, Any], output_path: Path
                       ) -> None:
        from PIL import Image, ImageDraw, ImageFont

        output_path = Path(output_path)
        original = Image.fromarray(np.asarray(result["original_array"],
                                              np.uint8))
        processed = Image.fromarray(np.asarray(result["processed_array"],
                                               np.uint8))

        display = (224, 224)
        original = original.resize(display, Image.LANCZOS)
        processed = processed.resize(display, Image.LANCZOS)

        width = display[0] * 2 + 20
        height = display[1] + 60
        montage = Image.new("RGB", (width, height), "white")
        montage.paste(original, (0, 0))
        montage.paste(processed, (display[0] + 20, 0))

        draw = ImageDraw.Draw(montage)
        try:
            font = ImageFont.truetype("arial.ttf", self.font_size)
        except OSError:
            font = ImageFont.load_default()

        text = (f"Prediction: {result['top_prediction']} "
                f"({result['confidence']:.1%})")
        bbox = draw.textbbox((0, 0), text, font=font)
        draw.text(((width - (bbox[2] - bbox[0])) // 2, display[1] + 20),
                  text, font=font, fill="black")
        draw.text((10, display[1] + 5), "Original", font=font, fill="gray")
        draw.text((display[0] + 30, display[1] + 5), "Mask", font=font,
                  fill="gray")

        output_path.parent.mkdir(parents=True, exist_ok=True)
        montage.save(output_path, quality=95)
        LOGGER.info("Montage saved to %s", output_path)
