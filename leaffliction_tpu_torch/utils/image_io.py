"""Image writing for the port's artifacts.

Copy of `ImageLoader.save_array` of `leaffliction_tpu/utils/image_io.py`:
the native libjpeg encoder for `.jpg`/`.jpeg` paths when it builds, else
(or when it refuses the array) PIL, at the reference's quality 95.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


class ImageLoader:
    @staticmethod
    def save_array(arr: np.ndarray, path: str | Path,
                   quality: int = 95) -> None:
        from leaffliction_tpu_torch.data import native

        if native.native_available() and str(path).lower().endswith(
                (".jpg", ".jpeg")):
            try:
                native.encode(str(path), np.asarray(arr, np.uint8), quality)
                return
            except ValueError:
                pass
        from PIL import Image

        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(np.asarray(arr, np.uint8)).save(path, quality=quality)
