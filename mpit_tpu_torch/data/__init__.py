"""Data streams of the port, and the split of a global batch over a
World's ranks: the synthetic streams, the on-disk classification
datasets (``--data-dir``), the image importer that writes them, and the
train streams' augmentation (``--augment``)."""

from mpit_tpu_torch.data.augment import augment_images, center_crop, random_resized_crop
from mpit_tpu_torch.data.filedata import FileClassification, load_dataset, write_classification
from mpit_tpu_torch.data.images import decode_image, import_image_directory
from mpit_tpu_torch.data.loader import shard_batch
from mpit_tpu_torch.data.synthetic import (
    SyntheticClassification,
    SyntheticLM,
    synthetic_imagenet,
    synthetic_mnist,
)

__all__ = [
    "FileClassification",
    "SyntheticClassification",
    "SyntheticLM",
    "augment_images",
    "center_crop",
    "decode_image",
    "import_image_directory",
    "load_dataset",
    "random_resized_crop",
    "shard_batch",
    "synthetic_imagenet",
    "synthetic_mnist",
    "write_classification",
]
