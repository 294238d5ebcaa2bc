"""Datasets on the host and the card: manifests, scan, split, the
balancers and the loader."""

from leaffliction_tpu_torch.data.manifest import (  # noqa: F401
    ManifestItem,
    build_label_mapping,
    load_manifest,
    save_manifest,
    select_items,
)
