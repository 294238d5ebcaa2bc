"""LeafCNN and the ResNet backbone as torch modules, in the flax layout's
parameter names."""

from leaffliction_tpu_torch.models.leafcnn import (  # noqa: F401
    SCALE_PRESETS,
    LeafCNN,
    build_leafcnn,
)
