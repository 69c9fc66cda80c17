"""Host data pipeline: datasets, augmentations, batching and upload.
numpy and PIL only at import time (loader workers import this package)."""

from . import transforms
from .dataset import InpaintDataset, SelfRefDataset
from .iterator import BatchIterator, device_batches, prefetch

__all__ = ["BatchIterator", "InpaintDataset", "SelfRefDataset",
           "device_batches", "prefetch", "transforms"]
