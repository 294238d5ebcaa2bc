"""Batched image ops over torch tensors (NHWC float32/uint8): the port's
counterpart of the JAX package's `ops`, the hand kernels' wrappers under
`ops/kernels/`."""

from leaffliction_tpu_torch.ops.geometry import (  # noqa: F401
    affine_matrix,
    homography_warp,
    perspective_matrix_from_coeffs,
    rotation_matrix,
    shear_matrix,
    warp_image,
)
from leaffliction_tpu_torch.ops.image import (  # noqa: F401
    normalize_to_unit,
    resize_bilinear,
    to_float,
)
