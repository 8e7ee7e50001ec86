"""Datasets, readers, preprocessing and host-side batching."""

from .datasets import get_dataset  # noqa: F401
from .readers import read_data, read_data_ali, read_data_avazu, read_data_twitter  # noqa: F401
