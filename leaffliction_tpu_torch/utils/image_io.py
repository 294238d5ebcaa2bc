"""Image writing for the port's artifacts.

Copy of `ImageLoader.save_array` and `ImageTransforms` of
`leaffliction_tpu/utils/image_io.py`: the native libjpeg encoder for
`.jpg`/`.jpeg` paths when it builds, else (or when it refuses the array)
PIL, at the reference's quality 95; PIL's LANCZOS resize and the /255
normalisation.
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


class ImageTransforms:
    @staticmethod
    def resize_image(img, size: int | tuple):
        from PIL import Image

        if isinstance(size, int):
            size = (size, size)
        return img.resize(size, Image.LANCZOS)

    @staticmethod
    def normalize_array(arr: np.ndarray) -> np.ndarray:
        return np.asarray(arr, np.float32) / 255.0
