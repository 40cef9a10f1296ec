"""Data layer (L3): host-side transforms, dataset, sharded loader, label
structures, synthetic fixtures."""

from rangeclip.data.transforms import (
    depth_transform,
    image_transform,
    segmentation_transform,
)
from rangeclip.data.labels import (
    load_candidate_labels,
    load_equivalence_dict,
    build_equivalence_tensor,
    load_label_similarity_sets,
    build_similarity_matrices,
    build_equivalence_class_map,
)
from rangeclip.data.dataset import ImageDepthTextDataset
from rangeclip.data.loader import (
    deterministic_split,
    ShardedBatchLoader,
    setup_dataloaders,
)
from rangeclip.data.synthetic import SyntheticDepthSegDataset, write_synthetic_dataset

__all__ = [
    "depth_transform",
    "image_transform",
    "segmentation_transform",
    "load_candidate_labels",
    "load_equivalence_dict",
    "build_equivalence_tensor",
    "load_label_similarity_sets",
    "build_similarity_matrices",
    "build_equivalence_class_map",
    "ImageDepthTextDataset",
    "deterministic_split",
    "ShardedBatchLoader",
    "setup_dataloaders",
    "SyntheticDepthSegDataset",
    "write_synthetic_dataset",
]
